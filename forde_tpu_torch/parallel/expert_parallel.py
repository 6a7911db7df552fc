"""Explicit expert parallelism over the ``expert`` mesh axis (port of
forde_tpu/parallel/expert_parallel.py).

Each rank of the expert axis holds E/ep experts (train/state.py keeps the
rank's slice of the bank and its Adam moments). The tokens are split over
data (and context) and the same on every rank of the expert axis. Two
dispatches:

  * **all-to-all** (GShard): each expert rank routes a distinct 1/ep
    slice of the local tokens into per-expert capacity buffers, one
    ``all_to_all`` moves each buffer to the rank that owns its expert,
    the local experts run on (E/ep, ep*C, D), and a second ``all_to_all``
    brings the outputs back to the token owners. The slices then
    ``all_gather`` over the expert axis, data-major and expert-minor as
    the JAX package's out_specs order them.
  * **psum**: each rank computes its experts' share of a capacity plan of
    all the local tokens, and ``psum`` adds the partial outputs. It is
    taken where the local token count does not divide the expert axis,
    and under context parallelism.

The a2a dispatch budgets ``capacity`` per source slice, so its overflow
drops are decided per (slice, expert) pair; with ``capacity_factor >=
num_experts`` no token drops and both dispatches equal one process's
capacity dispatch. The aux loss is built from fractions and probabilities
averaged over the data axis, the global-batch formula for equal shards.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.core.mesh import AXIS_CONTEXT, AXIS_DATA, AXIS_EXPERT, Mesh
from forde_tpu_torch.ops import moe_dispatch
from forde_tpu_torch.parallel.collectives import Group, all_gather, all_to_all, pmean, psum


def _experts(h_in, w_up, b_up, w_down, b_down, tp_group=None):
    """The local experts on their buffers (E_local, N, D), in h_in's dtype.
    ``tp_group``: the bank's hidden dim is split over the model axis, and
    the partial outputs are summed over it before the bias."""
    dt = h_in.dtype
    h = torch.einsum("ecd,edh->ech", h_in, w_up.to(dt))
    h = F.gelu(h + b_up.to(dt)[:, None, :], approximate="tanh")
    out = torch.einsum("ech,ehd->ecd", h, w_down.to(dt))
    if tp_group is not None:
        out = psum(out, tp_group)
    return out + b_down.to(dt)[:, None, :]


def _ep_ffn_body(flat_x, top_k_indices, top_k_probs, w_up, b_up, w_down, b_down, *,
                 num_experts: int, capacity: int, group: Group, tp_group=None) -> torch.Tensor:
    """The psum dispatch: a capacity plan of the local tokens (T, ...),
    this rank's experts' slots, and the partial combine summed over the
    expert axis."""
    e_shard = w_up.shape[0]
    e0 = group.index * e_shard
    plan = moe_dispatch.capacity_route(top_k_indices, top_k_probs, num_experts, capacity)
    slot_token = plan["slot_token"][e0:e0 + e_shard].long()
    slot_valid = plan["slot_valid"][e0:e0 + e_shard]
    expert_in = flat_x[slot_token] * slot_valid[..., None].to(flat_x.dtype)
    expert_out = _experts(expert_in, w_up, b_up, w_down, b_down, tp_group)
    ei = plan["expert_indices"].long()
    local = (ei >= e0) & (ei < e0 + e_shard)
    local_e = torch.clamp(ei - e0, 0, e_shard - 1)
    pos = torch.clamp(plan["position"].long(), max=capacity - 1)
    per_slot = expert_out[local_e, pos]  # (T, K, D)
    weight = (plan["weight"] * local).to(expert_out.dtype)[..., None]
    return psum(torch.sum(per_slot * weight, dim=1), group)


def _ep_a2a_ffn_body(flat_x, top_k_indices, top_k_probs, w_up, b_up, w_down, b_down, *,
                     num_experts: int, capacity: int, group: Group,
                     tp_group=None) -> torch.Tensor:
    """The all-to-all dispatch of this rank's T/ep slice of the local
    tokens; returns that slice's (T/ep, D) outputs."""
    e_shard = w_up.shape[0]
    ep = num_experts // e_shard
    me = group.index
    t, d = flat_x.shape
    t_d = t // ep
    rows = slice(me * t_d, (me + 1) * t_d)
    x_me = flat_x[rows]
    plan = moe_dispatch.capacity_route(top_k_indices[rows], top_k_probs[rows], num_experts,
                                       capacity)
    send = moe_dispatch.capacity_gather(x_me, plan).reshape(ep, e_shard, capacity, d)
    # recv[src, le, c]: slot c of my local expert le, from source rank src
    recv = all_to_all(send, group, 0, 0)
    h_in = recv.transpose(0, 1).reshape(e_shard, ep * capacity, d)
    out = _experts(h_in, w_up, b_up, w_down, b_down, tp_group)
    out = out.reshape(e_shard, ep, capacity, d).transpose(0, 1).contiguous()
    # back[src_e, le, c]: global expert src_e * e_shard + le's output for my slot c
    back = all_to_all(out, group, 0, 0)
    return moe_dispatch.capacity_combine(back.reshape(num_experts, capacity, d), plan)


def expert_parallel_moe(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    mesh: Mesh,
    *,
    num_experts: int,
    top_k: int = 2,
    capacity_factor: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A capacity-routed MoE FFN with its router, over this rank's
    (B_local, S, D) tokens (batch split over data): ``params`` has the
    JAX package's names, ``router_kernel`` (D, E), ``router_bias`` (E,),
    and this rank's slice of ``w_up`` (E/ep, D, H), ``b_up``, ``w_down``,
    ``b_down``. Returns (output of x's shape and dtype, the scalar aux loss
    of the global batch, before the aux weight)."""
    b, s, d = x.shape
    flat_x = x.reshape(b * s, d)
    t_local = b * s
    capacity = max(int(capacity_factor * t_local * top_k / num_experts), top_k)
    logits = (flat_x.float() @ params["router_kernel"].float()
              + params["router_bias"].float())
    probs = torch.softmax(logits, dim=-1)
    top_k_indices, top_k_probs = moe_dispatch.top_k_gating(logits, top_k)
    output = _ep_ffn_body(
        flat_x, top_k_indices, top_k_probs, params["w_up"], params["b_up"], params["w_down"],
        params["b_down"], num_experts=num_experts, capacity=capacity,
        group=mesh.group(AXIS_EXPERT),
    ).reshape(b, s, d)
    data = mesh.group(AXIS_DATA)
    counts = F.one_hot(top_k_indices.reshape(-1), num_experts).sum(0)
    frac = pmean(counts.float() / (t_local * top_k), data)
    prob = pmean(probs.mean(dim=0), data)
    return output.to(x.dtype), num_experts * torch.sum(frac * prob)


def expert_parallel_ffn(
    x: torch.Tensor,
    top_k_indices: torch.Tensor,
    top_k_probs: torch.Tensor,
    expert_params: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    mesh: Mesh,
    *,
    num_experts: int,
    top_k: int = 2,
    capacity_factor: float = 2.0,
    variant: str = "auto",
    tp_group=None,
) -> torch.Tensor:
    """The MoE FFN with explicit EP, inside the model (``moe_dispatch ==
    "ep"``): the router and the aux loss run around it. ``x`` (B_local,
    S_local, D) and the routing (B_local, S_local, K) are this rank's;
    ``expert_params`` (w_up, b_up, w_down, b_down) its slice of the bank.
    ``variant``: "a2a" | "psum" | "auto" (all-to-all where the local token
    count divides the expert axis and there is no context axis).
    ``tp_group``: the bank's hidden dim is split over the model axis."""
    b, s, d = x.shape
    ep = mesh.shape[AXIS_EXPERT]
    cp = mesh.shape[AXIS_CONTEXT]
    t_local = b * s
    group = mesh.group(AXIS_EXPERT)
    flat = (x.reshape(t_local, d), top_k_indices.reshape(t_local, top_k),
            top_k_probs.reshape(t_local, top_k))
    if variant == "auto":
        variant = "a2a" if t_local % ep == 0 and cp == 1 else "psum"
    if variant == "a2a":
        if cp > 1:
            raise ValueError("all-to-all EP does not compose with context parallelism "
                             "(flat token out_specs cannot split S over 'context'); use "
                             "variant='psum'")
        if t_local % ep:
            raise ValueError(f"all-to-all EP needs local tokens {t_local} divisible by the "
                             f"expert axis ({ep}); use variant='psum'")
        capacity = max(int(capacity_factor * (t_local // ep) * top_k / num_experts), top_k)
        out = _ep_a2a_ffn_body(*flat, *expert_params, num_experts=num_experts,
                               capacity=capacity, group=group, tp_group=tp_group)
        return all_gather(out, group, dim=0).reshape(b, s, -1).to(x.dtype)
    if variant != "psum":
        raise ValueError(f"unknown variant {variant!r}")
    capacity = max(int(capacity_factor * t_local * top_k / num_experts), top_k)
    out = _ep_ffn_body(*flat, *expert_params, num_experts=num_experts, capacity=capacity,
                       group=group, tp_group=tp_group)
    return out.reshape(b, s, d).to(x.dtype)

