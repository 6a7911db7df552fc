"""Plain attention primitives (port of forde_tpu/ops/attention_ref.py).

The semantic ground truth for the attention kernels. Tensors are
(B, H, S, D). Masks are boolean, True = attend: causal is
lower-triangular, the sliding window is ``0 <= q - k < window``, and
masked logits are -1e9 before the softmax. Scores and the softmax are
fp32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Lower-triangular boolean mask (q, k)."""
    return torch.ones(seq_len, seq_len, dtype=torch.bool, device=device).tril()


def sliding_window_mask(seq_len: int, window_size: int, device=None) -> torch.Tensor:
    """Boolean mask (q, k): True where 0 <= q - k < window_size."""
    pos = torch.arange(seq_len, device=device)
    diff = pos[:, None] - pos[None, :]
    return (diff >= 0) & (diff < window_size)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked multi-head attention on (B, H, S_q, D) / (B, H, S_k, D).

    ``mask`` broadcasts to (B, H, S_q, S_k). The products run on fp32
    copies of the operands, the JAX package's fp32-accumulating einsum.
    """
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.matmul(weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def causal_attention_ref(q, k, v, scale=None):
    mask = causal_mask(q.shape[2], q.device)
    return mha_reference(q, k, v, mask=mask, scale=scale)


def sliding_window_attention_ref(q, k, v, window_size: int, scale=None):
    mask = sliding_window_mask(q.shape[2], window_size, q.device)
    return mha_reference(q, k, v, mask=mask, scale=scale)
