"""Ring attention: context parallelism over the ``context`` mesh axis
(port of forde_tpu/parallel/ring_attention.py).

Each rank holds its (B, H, S_local, D) block of q, k and v; the k/v blocks
go round the ring with ``ppermute`` while the partial attentions merge by
log-sum-exp (``flash_attention_with_lse``: every block runs on the flash
kernels, and the lse cotangent folds into their backward). The sequence
is the global one; its memory on each rank is S_global / n.

``schedule``:
  * "ring": step 0 is this rank's own block, local-causal; at step s the
    block of rank idx - s arrives and is entirely past (merged) or
    entirely future (computed and killed in the merge by lse = -1e30).
    n flash calls per rank.
  * "zigzag" (causal only): the global sequence splits into 2n chunks
    and rank d holds chunks (d, 2n-1-d), so every ring step computes
    exactly two half-chunk blocks that are entirely past and nothing is
    killed: 3 + 2(n - 1) flash calls per rank. Inputs and outputs stay
    contiguous: two ``ppermute`` redistribute each way.
  * "auto": zigzag where it applies (causal, n > 1, S_local a multiple of
    16), else the ring.

On a rank the ring position and the source of each block are Python ints,
yet the JAX package's ``jnp.where`` selects stay selects (``_pick``) rather
than branches: every rank then builds the same autograd graph, so the
collectives' backwards run in one order on every rank, as they must.
"""

from __future__ import annotations

from typing import Optional

import torch

from forde_tpu_torch.core.mesh import AXIS_CONTEXT, Mesh
from forde_tpu_torch.ops.flash_attention import flash_attention_with_lse
from forde_tpu_torch.parallel.collectives import Group, ppermute

NEG_INF = -1e30


def _merge_lse(o_acc, lse_acc, o_b, lse_b):
    """Exact softmax merge of two partial attentions over disjoint keys."""
    m = torch.maximum(lse_acc, lse_b)
    w_a = torch.exp(lse_acc - m)
    w_b = torch.exp(lse_b - m)
    denom = w_a + w_b
    o = (o_acc * w_a + o_b.float() * w_b) / denom
    return o, m + torch.log(denom)


def _pick(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where ``cond`` else ``b``, as a select that both feed."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)


def _ring_body(q, k, v, group: Group, scale: float, causal: bool):
    idx, n = group.index, group.size
    o_acc, lse_acc = flash_attention_with_lse(q, k, v, causal=causal, scale=scale)
    o_acc = o_acc.float()
    perm = [(i, (i + 1) % n) for i in range(n)]
    for step in range(1, n):
        k = ppermute(k, group, perm)
        v = ppermute(v, group, perm)
        src = (idx - step) % n  # the rank these k/v came from
        o_b, lse_b = flash_attention_with_lse(q, k, v, causal=False, scale=scale)
        if causal:  # a future block contributes nothing: killed in the merge
            lse_b = _pick(src < idx, lse_b, torch.full_like(lse_b, NEG_INF))
        o_acc, lse_acc = _merge_lse(o_acc, lse_acc, o_b, lse_b)
    return o_acc.to(q.dtype)


def _zigzag_body(q, k, v, group: Group, scale: float):
    n, d = group.size, group.index
    c = q.shape[2] // 2

    def owner(chunk: int) -> int:
        return chunk if chunk < n else 2 * n - 1 - chunk

    even = d % 2 == 0
    perm_even = [(j, owner(2 * j)) for j in range(n)]
    perm_odd = [(j, owner(2 * j + 1)) for j in range(n)]

    def to_zigzag(x):
        recv_e = ppermute(x[:, :, :c], group, perm_even)
        recv_o = ppermute(x[:, :, c:], group, perm_odd)
        return _pick(even, recv_e, recv_o), _pick(even, recv_o, recv_e)

    q_lo, q_hi = to_zigzag(q)
    k_lo, k_hi = to_zigzag(k)
    v_lo, v_hi = to_zigzag(v)

    def attend(qq, kk, vv, causal):
        o, lse = flash_attention_with_lse(qq, kk, vv, causal=causal, scale=scale)
        return o.float(), lse

    # step 0: the two diagonal blocks, and q chunk 2n-1-d against k chunk d
    o_lo, lse_lo = attend(q_lo, k_lo, v_lo, True)
    o_hi, lse_hi = attend(q_hi, k_hi, v_hi, True)
    o_hi, lse_hi = _merge_lse(o_hi, lse_hi, *attend(q_hi, k_lo, v_lo, False))

    ring = [(i, (i + 1) % n) for i in range(n)]
    for step in range(1, n):
        k_lo, v_lo, k_hi, v_hi = (ppermute(t, group, ring) for t in (k_lo, v_lo, k_hi, v_hi))
        src = (d - step) % n  # the arriving chunks: (src, 2n-1-src)
        # always past: q chunk 2n-1-d against k chunk src
        o_hi, lse_hi = _merge_lse(o_hi, lse_hi, *attend(q_hi, k_lo, v_lo, False))
        # exactly one more pair is past: d > src, q chunk d against k chunk
        # src (into lo); d < src, q chunk 2n-1-d against k chunk 2n-1-src (hi)
        lo = d > src
        o_b, lse_b = attend(_pick(lo, q_lo, q_hi), _pick(lo, k_lo, k_hi),
                            _pick(lo, v_lo, v_hi), False)
        m_lo, ml_lo = _merge_lse(o_lo, lse_lo, o_b, lse_b)
        m_hi, ml_hi = _merge_lse(o_hi, lse_hi, o_b, lse_b)
        o_lo, lse_lo = _pick(lo, m_lo, o_lo), _pick(lo, ml_lo, lse_lo)
        o_hi, lse_hi = _pick(lo, o_hi, m_hi), _pick(lo, lse_hi, ml_hi)

    # back to contiguous: target t's front chunk (2t) comes from owner(2t)
    perm_front = [(owner(2 * t), t) for t in range(n)]
    perm_back = [(owner(2 * t + 1), t) for t in range(n)]
    send_front, send_back = _pick(even, o_lo, o_hi), _pick(even, o_hi, o_lo)
    front = ppermute(send_front, group, perm_front)
    back = ppermute(send_back, group, perm_back)
    return torch.cat([front, back], dim=2).to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    axis_name: str = AXIS_CONTEXT,
    schedule: str = "auto",
) -> torch.Tensor:
    """Full (or causal) attention of this rank's (B, H, S_local, D) block
    of a sequence split over ``axis_name`` (the batch stays split over
    data): returns this rank's block of the output."""
    group = mesh.group(axis_name)
    n = group.size
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    s_local = q.shape[2]
    if schedule == "auto":
        schedule = "zigzag" if causal and n > 1 and s_local % 16 == 0 else "ring"
    if schedule == "zigzag":
        if not causal:
            raise ValueError("zigzag schedule is causal-only")
        if s_local % 2:
            raise ValueError(f"zigzag needs an even local length, got {s_local}")
        return _zigzag_body(q, k, v, group, float(scale))
    if schedule != "ring":
        raise ValueError(f"unknown schedule {schedule!r}")
    return _ring_body(q, k, v, group, float(scale), causal)
