"""Context parallelism for Native Sparse Attention (port of
forde_tpu/parallel/nsa_context.py).

Each NSA branch needs only a bounded slice of the other ranks' state:

  * local (sliding window W): one ``ppermute`` of the previous rank's
    last W-1 k/v rows (the halo) and an O(W^2) corner attention, merged
    into the local window attention by log-sum-exp;
  * compressed: pool means computed on each rank and all-gathered,
    O(S / ratio) rows;
  * top-k: the selected rows fetched by a masked gather on each rank and
    summed with ``psum``, O(k D).

Every function takes this rank's block (the sequence split over the
context axis, the batch over data) and is differentiable through the
collectives' transposes (parallel/collectives.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from forde_tpu_torch.core.mesh import AXIS_CONTEXT, Mesh
from forde_tpu_torch.ops.flash_attention import flash_attention_with_lse
from forde_tpu_torch.parallel.collectives import all_gather, ppermute, psum

NEG_INF = -1e30


def _merge_lse(o_a, lse_a, o_b, lse_b):
    """Exact softmax merge of two partials over disjoint key sets."""
    m = torch.maximum(lse_a, lse_b)
    w_a = torch.exp(lse_a - m)
    w_b = torch.exp(lse_b - m)
    return (o_a.float() * w_a + o_b.float() * w_b) / (w_a + w_b)


def window_attention_cp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    window: int,
    *,
    impl: str = "auto",
    axis_name: str = AXIS_CONTEXT,
) -> torch.Tensor:
    """Causal sliding-window attention of this rank's (B, H, S_local, D)
    block. Local query g = base + i sees global keys [g-W+1, g]: the local
    window call covers keys >= base, and the rest are the previous rank's
    last H = W-1 rows. Halo key j (global base - H + j) is visible to local
    query i iff j >= i, an upper-triangular mask: causal attention in
    flipped coordinates, so the same kernel computes the corner after a
    flip of the sequence axis (padded by one row, as the JAX package pads
    to keep S 8-aligned; the kernels pad further to their tile). Rank 0
    has no previous rank: its corner is killed in the merge. Needs S_local
    >= W - 1."""
    group = mesh.group(axis_name)
    n, idx = group.size, group.index
    s_local = q.shape[2]
    if s_local < window - 1:
        raise ValueError(f"context parallelism needs S/shards >= window-1 (got {s_local} < "
                         f"{window - 1}); use fewer context shards")
    halo = window - 1
    o_loc, lse_loc = flash_attention_with_lse(q, k, v, causal=True, window_size=window,
                                              impl=impl)
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_halo = ppermute(k[:, :, s_local - halo:], group, perm)
    v_halo = ppermute(v[:, :, s_local - halo:], group, perm)

    pad = (0, 0, 0, 1)
    qf, kf, vf = (F.pad(t.flip(2), pad) for t in (q[:, :, :halo], k_halo, v_halo))
    o_x, lse_x = flash_attention_with_lse(qf, kf, vf, causal=True, impl=impl)
    o_x = o_x[:, :, :halo].flip(2)
    lse_x = lse_x[:, :, :halo].flip(2)
    # rank 0 has no previous rank: its corner is killed (a select, so that
    # every rank builds the same autograd graph; parallel/ring_attention.py)
    lse_x = torch.where(torch.tensor(idx == 0, device=lse_x.device),
                        torch.full_like(lse_x, NEG_INF), lse_x)
    o_head = _merge_lse(o_loc[:, :, :halo], lse_loc[:, :, :halo], o_x, lse_x)
    return torch.cat([o_head.to(q.dtype), o_loc[:, :, halo:]], dim=2)


def gather_pool_means_cp(
    x: torch.Tensor,
    mesh: Mesh,
    ratio: int,
    num_pools: int,
    *,
    axis_name: str = AXIS_CONTEXT,
) -> torch.Tensor:
    """The means of ratio-sized chunks of the global (B, S, D) sequence,
    from this rank's (B, S_local, D) block: pooled locally, all-gathered
    over the context axis, the first ``num_pools`` kept. Chunk boundaries
    fall on rank boundaries (S_local % ratio == 0 is required); as in the
    single-device branch the mean sums in fp32 and returns x's dtype."""
    b, s_local, d = x.shape
    if s_local % ratio:
        raise ValueError(f"S/shards={s_local} must be divisible by compression_ratio={ratio}")
    pooled = x.reshape(b, s_local // ratio, ratio, d).float().mean(dim=2).to(x.dtype)
    return all_gather(pooled, mesh.group(axis_name), dim=1)[:, :num_pools]


def topk_select_cp(
    x: torch.Tensor,
    idx: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = AXIS_CONTEXT,
) -> torch.Tensor:
    """Rows ``idx`` (B, K) (global positions, the same on every rank of
    the axis) of the global (B, S, D) sequence, from this rank's block:
    each rank gathers the rows it holds, zeros elsewhere, and ``psum``
    adds them; the full sequence is never gathered."""
    group = mesh.group(axis_name)
    s_local = x.shape[1]
    loc = idx.long() - group.index * s_local
    valid = (loc >= 0) & (loc < s_local)
    rows = torch.gather(x, 1, loc.clamp(0, s_local - 1)[..., None].expand(-1, -1, x.shape[2]))
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return psum(rows, group)


def small_kv_attention_cp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_pos: torch.Tensor,
    mesh: Mesh,
    *,
    impl: str = "auto",
    axis_name: str = AXIS_CONTEXT,
) -> torch.Tensor:
    """``small_kv_attention`` of this rank's (B, H, S_local, D) queries
    against a small key set that every rank holds: key j is visible to
    global query position >= ``key_pos`` (B, K), so each rank shifts the
    thresholds by its base offset -rank * S_local (negative or past
    S_local on most ranks)."""
    from forde_tpu_torch.ops.nsa_attention import small_kv_attention

    base = mesh.group(axis_name).index * q.shape[2]
    return small_kv_attention(q, k, v, key_pos - base, impl=impl)
