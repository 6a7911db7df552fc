"""Bytes and operations of the attention kernels' calls, from shapes and
masks. Each input is read once and each output written once, whatever
the kernel reads again; operations are 2 * D per (query, visible key,
head) for each product the layer needs (no recomputation), so the count is
the same whichever kernel does the work.

Frozen from ``chip_smoke.py``'s ``flash_fwd_bound`` and ``small_kv_bound``
and corrected: the backward counts the four products it needs (dv, dp, dq,
dk), not the recomputed scores, and reads ``lse`` and ``delta`` once.
"""

from __future__ import annotations

import numpy as np

KEY_POS_BYTES = 4  # the kernels take int32 thresholds


def window_pairs(s: int, window: int) -> float:
    """(query, key) pairs of causal attention over the last ``window``
    positions, per (sample, head)."""
    rows = np.arange(s)
    return float(np.minimum(rows + 1, window).sum())


def flash_fwd(b: int, h: int, s: int, d: int, window: int, elem: int):
    """(bytes, operations) of one windowed causal forward: q, k, v read,
    o and lse (fp32) written."""
    moved = 4 * b * h * s * d * elem + b * h * s * 4
    return moved, 4.0 * d * b * h * window_pairs(s, window)


def flash_bwd(b: int, h: int, s: int, d: int, window: int, elem: int):
    """(bytes, operations) of its backward: q, k, v, do read, lse and delta
    (fp32) read, dq, dk, dv written; dv, dp, dq, dk."""
    moved = 7 * b * h * s * d * elem + 2 * b * h * s * 4
    return moved, 8.0 * d * b * h * window_pairs(s, window)


def pool_visible(s: int, num_pools: int, ratio: int) -> np.ndarray:
    """Pools each query of a teacher-forced forward sees: pool p from
    position (p + 1) * ratio on."""
    return np.minimum(np.arange(s) // ratio, num_pools)


def topk_visible(s: int, k: int) -> np.ndarray:
    """Selected keys each query sees, for a selection spread evenly over
    the sequence (the selection is the data's; the layer is bound by its
    bytes at these shapes, so the operations matter little)."""
    return np.minimum(np.floor((np.arange(s) + 1) * k / s), k)


def small_kv_fwd(b: int, h: int, s: int, kk: int, d: int, visible: np.ndarray, elem: int):
    """(bytes, operations) of one small-KV forward of (B, H, S, D) queries
    over (B, H, K, D) keys: q, k, v and the thresholds read, o written;
    4 * D per visible pair, and 2 * D per key for a query that sees none
    (the uniform quirk averages v). ``visible``: keys each query sees."""
    moved = (2 * b * h * s * d + 2 * b * h * kk * d) * elem + b * kk * KEY_POS_BYTES
    pairs = float(visible.sum()) + 0.5 * kk * float((visible == 0).sum())
    return moved, 4.0 * d * b * h * pairs


def small_kv_bwd(b: int, h: int, s: int, kk: int, d: int, visible: np.ndarray, elem: int):
    """Its backward: q, k, v, do, the thresholds, lse and delta read, dq,
    dk, dv written; 8 * D per visible pair, 2 * D per key (dv alone) for a
    query that sees none."""
    moved = ((3 * b * h * s * d + 4 * b * h * kk * d) * elem + b * kk * KEY_POS_BYTES
             + 2 * b * h * s * 4)
    pairs = float(visible.sum())
    return moved, d * b * h * (8.0 * pairs + 2.0 * kk * float((visible == 0).sum()))
