"""MoE routing primitives over a stacked expert bank (port of
forde_tpu/ops/moe_dispatch.py).

Two dispatches:
  * dense: the reference's math. ``dense_combine`` mixes the outputs of
    every expert on every token by a (..., E) combine matrix, which is 0
    for the experts a token did not pick. The routed form computes the
    same sum over the routed rows only (no capacity, no drops):
    ``routed_order`` sorts the T*k routing choices by expert, stably (the
    caller reads the group sizes to the host), ``routed_rows`` gathers each
    choice's token row in that order, and ``routed_combine`` puts the
    experts' outputs back in (T, k) order and sums each token's k by its
    gates. Both moves are gathers whose backwards are gathers too (a
    token's k gradient rows summed in slot order, not scattered onto its
    row), so the output and every gradient repeat bit for bit;
  * capacity: ``capacity_route`` plans per-expert buffers of ``capacity``
    slots (slot 0 of every token before slot 1 of any, then token order;
    overflow dropped), ``capacity_gather`` fills them and
    ``capacity_combine`` mixes the experts' outputs back. Plain gather and
    scatter bookkeeping: no (T, E, C) one-hot tensor.
Expert parallelism over several devices comes with the multi-device slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

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


class RoutedOrder(NamedTuple):
    """The T*k routing choices (choice c = token c // k, slot c % k)
    sorted by expert, stably: ``perm`` (T*k,) the choice at each sorted
    position, ``inv`` (T*k,) the sorted position of each choice,
    ``counts`` (E,) the group sizes on the device and ``k``."""

    perm: torch.Tensor
    inv: torch.Tensor
    counts: torch.Tensor
    k: int


def routed_order(top_k_indices: torch.Tensor, num_experts: int) -> RoutedOrder:
    """The expert order of (..., k) routing choices; nothing is read to
    the host (the caller reads ``counts`` once, where it splits)."""
    k = top_k_indices.shape[-1]
    flat = top_k_indices.reshape(-1)
    perm = torch.argsort(flat, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return RoutedOrder(perm, inv, torch.bincount(flat, minlength=num_experts), k)


class _RoutedRows(torch.autograd.Function):
    """(T, D) token rows -> (T*k, D), the row of each choice in expert
    order. The backward gathers each choice's gradient back to (T, k)
    order and sums a token's k slots in order."""

    @staticmethod
    def forward(ctx, x, perm, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return x.index_select(0, torch.div(perm, k, rounding_mode="floor"))

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        per_choice = grad.index_select(0, inv)
        return per_choice.reshape(-1, ctx.k, grad.shape[-1]).sum(1), None, None, None


class _Permute(torch.autograd.Function):
    """Rows of ``x`` taken in the order ``index``, a permutation whose
    inverse is ``inverse``; the backward is the inverse gather."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return grad.index_select(0, inverse), None, None


def routed_rows(flat_x: torch.Tensor, order: RoutedOrder) -> torch.Tensor:
    """(T, D) tokens -> (T*k, D) rows, grouped by expert in ``order``."""
    return _RoutedRows.apply(flat_x, order.perm, order.inv, order.k)


def routed_combine(expert_rows: torch.Tensor, order: RoutedOrder,
                   top_k_probs: torch.Tensor) -> torch.Tensor:
    """(T*k, D) expert outputs in expert order -> (T, D): each token's k
    outputs weighted by ``top_k_probs`` (..., k), cast as ``dense_combine``
    casts its combine matrix, and summed in slot order. As in
    ``dense_combine``'s product, the products and their sum are fp32 and
    the sum is rounded to the outputs' dtype once, so that a bf16 token
    mixes its experts as dense dispatch does (a rounding of each product
    alone flips later routing choices: a prefix-cached prompt, whose
    prefix ran dense, then parts from the same prompt run routed)."""
    per_choice = _Permute.apply(expert_rows, order.inv, order.perm)
    per_choice = per_choice.reshape(-1, order.k, expert_rows.shape[-1])
    weight = top_k_probs.reshape(-1, order.k, 1).to(expert_rows.dtype)
    return torch.sum(per_choice.float() * weight.float(), dim=1).to(expert_rows.dtype)


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
