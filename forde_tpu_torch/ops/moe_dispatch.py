"""MoE routing primitives over a stacked expert bank (port of the dense
part of forde_tpu/ops/moe_dispatch.py).

``dense_combine`` is the reference's math: every expert runs on every
token and the top-k outputs are mixed by a (..., E) combine matrix. The
capacity dispatch (scatter to per-expert buffers) and expert parallelism
come with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def top_k_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, in
    descending order, ties kept in index order (``jax.lax.top_k``'s order;
    ``torch.topk`` leaves the order of ties unspecified)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def top_k_gating(router_logits: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k experts per token and the softmax over their logits."""
    top_logits, top_indices = top_k_desc(router_logits, top_k)
    return top_indices, torch.softmax(top_logits, dim=-1)


def load_balancing_loss(
    router_probs: torch.Tensor, top_k_indices: torch.Tensor, num_experts: int
) -> torch.Tensor:
    """E * sum_e(fraction of routed slots_e * mean router prob_e); the
    aux-loss weight is applied by the caller."""
    num_tokens = router_probs.shape[0] * router_probs.shape[1]
    top_k = top_k_indices.shape[-1]
    counts = torch.bincount(top_k_indices.reshape(-1), minlength=num_experts)
    fraction = counts.to(torch.float32) / (num_tokens * top_k)
    prob = router_probs.mean(dim=(0, 1))
    return num_experts * torch.sum(fraction * prob)


def combine_matrix(
    top_k_indices: torch.Tensor, top_k_probs: torch.Tensor, num_experts: int
) -> torch.Tensor:
    """(..., E) routing weight of each expert (zero if not selected;
    duplicate selections add)."""
    one_hot = F.one_hot(top_k_indices, num_experts).to(top_k_probs.dtype)
    return torch.einsum("...ke,...k->...e", one_hot, top_k_probs)


def dense_combine(all_expert_outputs: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """Mix per-expert outputs (E, B, S, D) with combine weights (B, S, E)."""
    return torch.einsum(
        "ebsd,bse->bsd", all_expert_outputs, combine.to(all_expert_outputs.dtype)
    )
