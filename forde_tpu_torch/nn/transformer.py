"""Encoder self-attention and the FORDE transformer block of the two towers
(port of forde_tpu/nn/transformer.py).

Pre-norm block: LN -> attention -> residual; LN -> StatefulLayer ->
residual. Attention runs the fused-qkv ``flash_mha``: q/k/v are read
straight out of the qkv projection's output and the context comes back in
(B, S, H*D). The text tower's right padding maps to per-sample
``kv_lens``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from forde_tpu_torch.nn import remat
from forde_tpu_torch.nn.layers import Dense, LayerNorm
from forde_tpu_torch.nn.stateful import StatefulLayer
from forde_tpu_torch.ops.flash_attention import flash_mha


class EncoderSelfAttention(torch.nn.Module):
    """Bidirectional multi-head self-attention (zero-transpose flash path)."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        head_dim: int,
        impl: str = "auto",
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.impl = impl
        hd = num_heads * head_dim
        self.qkv_proj = Dense(d_model, 3 * hd, dtype=dtype, param_dtype=param_dtype, device=device)
        self.out_proj = Dense(hd, d_model, dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(
        self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        qkv = self.qkv_proj(x)
        kv_lens = None
        if key_padding_mask is not None:
            # Right-padded contract: valid tokens form a prefix, so the
            # mask reduces to a per-sample length.
            kv_lens = key_padding_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
        out = flash_mha(
            qkv, self.num_heads, self.head_dim,
            causal=False, kv_lens=kv_lens, impl=self.impl,
        )
        return self.out_proj(out)


class FORDETransformerBlock(torch.nn.Module):
    """LN -> attention -> residual; LN -> StatefulLayer -> residual.

    ``remat`` (a training call only, nn/remat.py): "block" recomputes the
    whole block in the backward, "mlp" only the StatefulLayer (its two
    (B, S, mlp_hidden) intermediates are the largest tensors of a block),
    None neither (the JAX package's ``nn.remat`` of the block, and
    ``remat_mlp``)."""

    def __init__(
        self,
        num_heads: int,
        head_dim: int,
        mlp_hidden_dim: int,
        d_model: int,
        specialist_gate: float = 0.1,
        attention_impl: str = "auto",
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        sense: bool = False,
        param_dtype: torch.dtype = torch.float32,
        device=None,
        remat: Optional[str] = None,
    ):
        super().__init__()
        self.remat = remat
        self.dropout_rate = dropout_rate
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.attn_norm = LayerNorm(d_model, **kw)
        self.attention = EncoderSelfAttention(
            d_model, num_heads, head_dim, impl=attention_impl, **kw
        )
        self.mlp_norm = LayerNorm(d_model, **kw)
        self.stateful = StatefulLayer(
            mlp_hidden_dim, d_model, specialist_gate=specialist_gate,
            sense=sense, **kw,
        )

    def forward(
        self,
        x: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        sense: bool = False,
    ) -> torch.Tensor:
        """``sense``: this call accumulates the StatefulLayer's fast-loop
        statistics (nn/stateful.py)."""
        if self.remat == "block" and torch.is_grad_enabled():
            dropout = not deterministic and self.dropout_rate > 0
            return remat.checkpoint(self._forward, x, key_padding_mask, deterministic, sense,
                                    preserve_rng_state=dropout)
        return self._forward(x, key_padding_mask, deterministic, sense)

    def _forward(self, x, key_padding_mask, deterministic, sense):
        training = not deterministic
        attn_out = self.attention(self.attn_norm(x), key_padding_mask)
        x = x + F.dropout(attn_out, self.dropout_rate, training=training)
        if self.remat == "mlp" and torch.is_grad_enabled():
            mlp_out = remat.checkpoint(self.stateful, self.mlp_norm(x), sense)
        else:
            mlp_out = self.stateful(self.mlp_norm(x), sense)
        return x + F.dropout(mlp_out, self.dropout_rate, training=training)
