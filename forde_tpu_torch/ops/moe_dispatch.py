"""MoE routing primitives over a stacked expert bank (port of
forde_tpu/ops/moe_dispatch.py).

Two dispatches:
  * ``dense_combine``: the reference's math, every expert runs on every
    token and the top-k outputs are mixed by a (..., E) combine matrix;
  * capacity: ``capacity_route`` plans per-expert buffers of ``capacity``
    slots (slot 0 of every token before slot 1 of any, then token order;
    overflow dropped), ``capacity_gather`` fills them and
    ``capacity_combine`` mixes the experts' outputs back. Plain gather and
    scatter bookkeeping: no (T, E, C) one-hot tensor.
Expert parallelism over several devices comes with the multi-device slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

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
    # bincount's counts, without its host synchronisation on CUDA
    counts = F.one_hot(top_k_indices.reshape(-1), num_experts).sum(0)
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


def capacity_route(
    top_k_indices: torch.Tensor, top_k_probs: torch.Tensor, num_experts: int, capacity: int
) -> Dict[str, torch.Tensor]:
    """The capacity plan of (T, K) routing choices: slot 0 of every token
    has priority over slot 1 of any token, then earlier tokens over later
    ones. Returns {"expert_indices" (T, K), "slot_token" (E, C) int32 (0
    where empty), "slot_valid" (E, C) bool, "position" (T, K) int32 (the
    slot within the chosen expert), "keep" (T, K) bool (False where the
    token overflowed), "weight" (T, K) fp32 (top_k_probs masked by keep)}."""
    t, k = top_k_indices.shape
    sel = F.one_hot(top_k_indices.long(), num_experts)  # (T, K, E)
    sel_km = sel.transpose(0, 1).reshape(k * t, num_experts)  # slot-major
    before = torch.cumsum(sel_km, dim=0) - sel_km  # occupancy before each choice
    position = (before.reshape(k, t, num_experts).transpose(0, 1) * sel).sum(-1)
    keep = position < capacity
    experts = top_k_indices.long()[keep]
    slots = position[keep]
    tokens = torch.arange(t, device=top_k_indices.device)[:, None].expand(t, k)[keep]
    slot_token = torch.zeros(num_experts, capacity, dtype=torch.int32, device=tokens.device)
    slot_token[experts, slots] = tokens.to(torch.int32)
    slot_valid = torch.zeros(num_experts, capacity, dtype=torch.bool, device=tokens.device)
    slot_valid[experts, slots] = True
    return {
        "expert_indices": top_k_indices,
        "slot_token": slot_token,
        "slot_valid": slot_valid,
        "position": position.to(torch.int32),
        "keep": keep,
        "weight": top_k_probs.float() * keep,
    }


def capacity_gather(flat_x: torch.Tensor, plan: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-expert input buffers (E, C, D) from (T, D) tokens; empty slots 0."""
    gathered = flat_x[plan["slot_token"].long()]
    return gathered * plan["slot_valid"][..., None].to(flat_x.dtype)


def capacity_combine(expert_out: torch.Tensor, plan: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(T, D) tokens from the (E, C, D) expert outputs: each token sums its
    k outputs by (expert, slot) with the kept routing weights; a dropped
    choice adds zero."""
    pos = torch.clamp(plan["position"].long(), max=expert_out.shape[1] - 1)
    per_slot = expert_out[plan["expert_indices"].long(), pos]  # (T, K, D)
    weight = plan["weight"].to(expert_out.dtype)[..., None]
    return torch.sum(per_slot * weight, dim=1)
