"""Standalone NSA branch modules: CompressedGlobalAttention and
TopKSelection (port of forde_tpu/nn/nsa_modules.py).

The composed ``NativeSparseAttention`` (nn/attention.py) runs its own
inline branches through the small-KV kernel; these modules are the
reference's standalone branches, for users and tests that exercise a
branch alone. Like the JAX modules they are plain products and a softmax
(no kernel): scores in fp32, the -1e9 masks, zeros for a context too
short to pool.

Flax infers a Dense layer's input width at its first call; a torch
module needs it up front, so both take ``d_model``. The parameters keep
the Flax names (``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``,
``importance_scorer``), so ``interop`` carries a JAX module's weights
across.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from forde_tpu_torch.nn.attention import _merge_heads, _split_heads
from forde_tpu_torch.nn.layers import Dense


def _attend(q, k, v, keep, head_dim: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(head_dim), -1e9 where not ``keep``) v, the
    scores in fp32 (Flax's ``preferred_element_type``), the weights in
    v's dtype."""
    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = torch.where(keep, scores, torch.full_like(scores, -1e9))
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return _merge_heads(torch.matmul(weights, v))


class CompressedGlobalAttention(torch.nn.Module):
    """Attend to mean-pooled summaries of the tokens before the local
    window. ``forward(x, local_window_start)``: a context of at most
    ``compression_ratio`` tokens before the window gives zeros."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 compression_ratio: int = 8, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.compression_ratio = compression_ratio
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        hd = num_heads * head_dim
        self.q_proj = Dense(d_model, hd, **kw)
        self.k_proj = Dense(d_model, hd, **kw)
        self.v_proj = Dense(d_model, hd, **kw)
        self.out_proj = Dense(hd, d_model, **kw)

    def forward(self, x: torch.Tensor, local_window_start: int) -> torch.Tensor:
        b, s, d_model = x.shape
        ratio = self.compression_ratio
        num_pools = local_window_start // ratio
        if local_window_start <= ratio or num_pools == 0:
            return torch.zeros_like(x)
        compressed = x[:, :num_pools * ratio].reshape(b, num_pools, ratio, d_model).mean(dim=2)
        h, d = self.num_heads, self.head_dim
        q = _split_heads(self.q_proj(x), h, d)
        k = _split_heads(self.k_proj(compressed), h, d)
        v = _split_heads(self.v_proj(compressed), h, d)
        query_pos = torch.arange(s, device=x.device)[:, None]
        pool_ends = (torch.arange(num_pools, device=x.device) + 1) * ratio
        out = _attend(q, k, v, query_pos >= pool_ends[None, :], d)
        return self.out_proj(out.to(x.dtype))


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest scores of each row, largest first,
    a tie to the lower index (``jax.lax.top_k``'s order; ``torch.topk``
    promises none on CUDA): a stable descending sort. int32 (B, k)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


class TopKSelection(torch.nn.Module):
    """Learned-importance global top-k token selection, then attention of
    every query to the selected tokens before it. ``forward(x,
    importance_scores=None)`` -> (output, indices (B, k) int32); without
    scores the ``importance_scorer`` Dense gives them."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int, top_k: int = 64,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_heads, self.head_dim, self.top_k = num_heads, head_dim, top_k
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        hd = num_heads * head_dim
        self.importance_scorer = Dense(d_model, 1, **kw)
        self.q_proj = Dense(d_model, hd, **kw)
        self.k_proj = Dense(d_model, hd, **kw)
        self.v_proj = Dense(d_model, hd, **kw)
        self.out_proj = Dense(hd, d_model, **kw)

    def forward(self, x: torch.Tensor, importance_scores: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        if importance_scores is None:
            importance_scores = self.importance_scorer(x).squeeze(-1)
        indices = top_k_indices(importance_scores.float(), min(self.top_k, s))
        selected = torch.gather(x, 1, indices.long()[..., None].expand(-1, -1, x.shape[-1]))
        h, d = self.num_heads, self.head_dim
        q = _split_heads(self.q_proj(x), h, d)
        k = _split_heads(self.k_proj(selected), h, d)
        v = _split_heads(self.v_proj(selected), h, d)
        query_pos = torch.arange(s, device=x.device)[None, None, :, None]
        keep = query_pos >= indices[:, None, None, :]
        out = _attend(q, k, v, keep, d)
        return self.out_proj(out.to(x.dtype)), indices
