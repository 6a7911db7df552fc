"""Model operations of the FORDE dual encoder's training step and the
least time of its hand-written kernels, from its sizes.

Model operations: 2 per multiply-add of every matrix product the pairs
require, the text tower over each row's valid tokens only (mean length of
the mix's uniform range), the vision tower over its patches, CLS and
register tokens; a training step is three forwards.
Kernels: per layer of each tower the fused-qkv attention forward and
backward (every query row, the keys each row's length leaves visible) and
the moment sums of the StatefulLayer's pre-activations (forward) and of
their gradients (backward).
"""

from __future__ import annotations

from h100bench.counts.peaks import DTYPE_BYTES, HBM_BYTES_PER_S, least_seconds


def _tokens(cfg: dict) -> int:
    patches = (cfg["image_size"] // cfg["patch_size"]) ** 2
    return patches + 1 + (8 - (patches + 1) % 8) % 8


def _layer_flops(tw: dict, tokens: float, keys: float) -> float:
    d, hd, f = tw["d_model"], tw["num_heads"] * tw["head_dim"], tw["mlp_hidden_dim"]
    return tokens * 2 * (d * 3 * hd + hd * d + 2 * d * f) + 4 * hd * tokens * keys


def forward_flops(cfg: dict, b: int, text_len: dict) -> float:
    vis, txt = cfg["vision"], cfg["text"]
    tv = _tokens(cfg)
    tt = (text_len["min"] + text_len["max"]) / 2
    patch = (cfg["image_size"] // cfg["patch_size"]) ** 2 * 2 * cfg["patch_size"] ** 2 * 3 * vis["d_model"]
    per_pair = (patch + vis["num_layers"] * _layer_flops(vis, tv, tv)
                + txt["num_layers"] * _layer_flops(txt, tt, tt)
                + 2 * cfg["embed_dim"] * (vis["d_model"] + txt["d_model"]) + 4 * b * cfg["embed_dim"])
    return b * per_pair


def train_step_flops(cfg: dict, b: int, text_len: dict) -> float:
    return 3.0 * forward_flops(cfg, b, text_len)


def _attention(b, s, tw, keys, elem, dtype):
    h, d = tw["num_heads"], tw["head_dim"]
    qkv, o = b * s * 3 * h * d * elem, b * s * h * d * elem
    fwd = least_seconds(qkv + o + b * h * s * 4, 4.0 * d * h * b * s * keys, dtype)
    bwd = least_seconds(2 * qkv + o + 2 * b * h * s * 4, 8.0 * d * h * b * s * keys, dtype)
    return fwd + bwd


def _moments(rows, f, elem):
    return 2 * (rows * f * elem + 3 * f * 4) / HBM_BYTES_PER_S  # z forward, dL/dz backward


def train_kernel_seconds(cfg: dict, b: int, text_len: dict) -> float:
    elem, dtype = DTYPE_BYTES[cfg["dtype"]], cfg["dtype"]
    vis, txt = cfg["vision"], cfg["text"]
    tv, s = _tokens(cfg), cfg["max_text_len"]
    mean_len = (text_len["min"] + text_len["max"]) / 2
    return (vis["num_layers"] * (_attention(b, tv, vis, tv, elem, dtype)
                                 + _moments(b * tv, vis["mlp_hidden_dim"], elem))
            + txt["num_layers"] * (_attention(b, s, txt, mean_len, elem, dtype)
                                   + _moments(b * s, txt["mlp_hidden_dim"], elem)))
