"""Model operations of the FORDE decoder LM (NSA + MoE + mHC) and the
least time of its hand-written attention kernels, from its sizes.

Model operations count what the model requires: 2 per multiply-add of
every matrix product, the routed top-k experts only (not the E that dense
dispatch computes), only the keys that NSA's window, compressed and top-k
branches admit, and no recomputation. A training step is three forwards
(the forward, and the backward's two products per product).
"""

from __future__ import annotations

import numpy as np

from h100bench.counts import attention as att
from h100bench.counts.peaks import DTYPE_BYTES, least_seconds


def _sizes(cfg: dict):
    d, h, hd = cfg["d_model"], cfg["num_heads"], cfg["num_heads"] * cfg["head_dim"]
    return d, h, cfg["head_dim"], hd


def token_flops(cfg: dict) -> float:
    """Matrix products of one token through the layers and the head, the
    per-token parts (no attention over keys, no pooled keys)."""
    d, _, _, hd = _sizes(cfg)
    per_layer = 2 * (
        d * 3 * hd + hd * d  # window branch: qkv, out
        + 2 * d * hd + d * d  # compressed: q, out; gate
        + 2 * d * hd + d * d + d  # top-k: q, out; gate; importance
        + d * cfg["num_experts"]  # router
        + cfg["top_k_experts"] * 2 * d * cfg["expert_hidden_dim"]  # routed experts
        + 2 * cfg["num_streams"] ** 2 * d  # two stream mixes
    )
    head = 2 * (d * (cfg["num_streams"] - 1) * d + d * cfg["vocab_size"])
    return cfg["num_layers"] * per_layer + head


def forward_flops(cfg: dict, b: int, s: int) -> float:
    """One teacher-forced forward of b rows of s tokens."""
    d, h, hd_, hd = _sizes(cfg)
    w, r, k = cfg["window_size"], cfg["compression_ratio"], cfg["top_k_global"]
    pools = max(max(s - w, r) // r, 1)
    k_sel = min(k, s)
    keys = (att.window_pairs(s, w) + float(att.pool_visible(s, pools, r).sum())
            + float(att.topk_visible(s, k_sel).sum()))
    per_row_layer = (2 * 2 * d * hd * (pools + k_sel)  # pooled and selected k, v
                     + 4 * hd_ * h * keys)
    return b * (s * token_flops(cfg) + cfg["num_layers"] * per_row_layer)


def train_step_flops(cfg: dict, b: int, s: int) -> float:
    return 3.0 * forward_flops(cfg, b, s)


def train_kernel_seconds(cfg: dict, b: int, s: int) -> float:
    """Least time of one training step's attention kernels: per layer the
    window's forward and backward, and each global branch's small-KV
    forward and backward."""
    _, h, d, _ = _sizes(cfg)
    elem = DTYPE_BYTES[cfg["dtype"]]
    w, r, k = cfg["window_size"], cfg["compression_ratio"], cfg["top_k_global"]
    pools = max(max(s - w, r) // r, 1)
    k_sel = min(k, s)
    calls = [att.flash_fwd(b, h, s, d, w, elem), att.flash_bwd(b, h, s, d, w, elem)]
    for kk, vis in ((pools, att.pool_visible(s, pools, r)), (k_sel, att.topk_visible(s, k_sel))):
        calls.append(att.small_kv_fwd(b, h, s, kk, d, vis, elem))
        calls.append(att.small_kv_bwd(b, h, s, kk, d, vis, elem))
    return cfg["num_layers"] * sum(least_seconds(m, o, cfg["dtype"]) for m, o in calls)


def decode_token_flops(cfg: dict, pos: int) -> float:
    """One decoded token at position ``pos`` (streaming semantics): the
    per-token products, its k, v for the top-k set, a pool's k, v once a
    chunk closes (one in ``ratio`` tokens), and the keys each branch
    admits at that length."""
    d, h, hd_, hd = _sizes(cfg)
    w, r, k = cfg["window_size"], cfg["compression_ratio"], cfg["top_k_global"]
    pools = max((pos + 1 - w) // r, 0)
    keys = min(pos + 1, w) + pools + min(k, pos + 1)
    per_layer = 2 * 2 * d * hd * (1 + 1.0 / r) + 4 * hd_ * h * keys
    return token_flops(cfg) + cfg["num_layers"] * per_layer


def decode_kernel_seconds(cfg: dict, rows: int) -> float:
    """Least time of one pooled decode step's small-KV forwards: per layer
    the compressed branch over the cache's pool slots and the top-k set,
    one query a row."""
    _, h, d, _ = _sizes(cfg)
    elem = DTYPE_BYTES[cfg["dtype"]]
    slots = max(cfg["max_seq_len"] // cfg["compression_ratio"], 1)
    k_sel = min(cfg["top_k_global"], cfg["max_seq_len"])
    one = np.ones(1)
    calls = [att.small_kv_fwd(rows, h, 1, slots, d, one, elem),
             att.small_kv_fwd(rows, h, 1, k_sel, d, one, elem)]
    return cfg["num_layers"] * sum(least_seconds(m, o, cfg["dtype"]) for m, o in calls)
