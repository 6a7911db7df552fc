"""FORDE decoder-only language model (port of
forde_tpu/models/decoder_lm.py).

Token + learned positional embeddings, pre-norm blocks of [NSA-or-causal
attention, mHC-or-plain residual, MoE-or-dense FFN, mHC-or-plain
residual], final norm, stream collapse, lm_head. The blocks are unrolled
(``layers.{i}``, the JAX package's ``layer_{i}``); a ``scan_layers``
checkpoint is split per layer when it is loaded (``interop``).

``forward`` is the teacher-forced pass (``lengths`` for right-padded
rows) or, given a ``cache`` from ``init_cache``, the cached pass: a
prefill at the cache's position counter or one token per row at
``positions``. The cache is updated in place. Logits are fp32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.core.config import LLMConfig
from forde_tpu_torch.nn.attention import CausalSelfAttention, NativeSparseAttention
from forde_tpu_torch.nn.hyper_connections import (
    HyperConnectionStream,
    ManifoldHyperConnection,
    StreamCollapser,
)
from forde_tpu_torch.nn.layers import Dense, LayerNorm
from forde_tpu_torch.nn.moe import MoEStatefulLayer


class DecoderBlock(torch.nn.Module):
    """Pre-norm decoder block."""

    def __init__(self, config: LLMConfig, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtypes.compute, param_dtype=cfg.dtypes.param, device=device)
        self.attn_norm = LayerNorm(cfg.d_model, **kw)
        if cfg.use_sparse_attention:
            self.sparse_attention = NativeSparseAttention(
                cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.window_size,
                cfg.compression_ratio, cfg.top_k_global, impl=cfg.attention_impl,
                max_decode_len=cfg.max_seq_len, **kw,
            )
        else:
            self.causal_attention = CausalSelfAttention(
                cfg.d_model, cfg.num_heads, cfg.head_dim, impl=cfg.attention_impl,
                max_decode_len=cfg.max_seq_len, **kw,
            )
        mhc = dict(param_dtype=cfg.dtypes.param, device=device)
        if cfg.use_hyper_connections:
            self.mhc_attn = ManifoldHyperConnection(cfg.num_streams, cfg.sinkhorn_iterations, **mhc)
        self.ffn_norm = LayerNorm(cfg.d_model, **kw)
        if cfg.use_moe:
            self.moe = MoEStatefulLayer(
                cfg.num_experts, cfg.top_k_experts, cfg.expert_hidden_dim, cfg.d_model,
                cfg.moe_aux_loss_weight, cfg.moe_dispatch, **kw,
            )
        else:
            self.ffn_up = Dense(cfg.d_model, cfg.expert_hidden_dim, **kw)
            self.ffn_down = Dense(cfg.expert_hidden_dim, cfg.d_model, **kw)
        if cfg.use_hyper_connections:
            self.mhc_ffn = ManifoldHyperConnection(cfg.num_streams, cfg.sinkhorn_iterations, **mhc)

    @property
    def attention(self) -> torch.nn.Module:
        return self.sparse_attention if self.config.use_sparse_attention else self.causal_attention

    def forward(
        self,
        x: torch.Tensor,
        streams: Optional[torch.Tensor],
        lengths: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        positions: Optional[torch.Tensor] = None,
        capture: Optional[List[torch.Tensor]] = None,
        update_stats: bool = False,
        deterministic: bool = True,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """Returns (output, streams, moe aux loss). ``capture``: a list
        that receives this block's attention input (the ``attn_norm``
        output), which ``nsa_prefill`` builds the caches from."""
        cfg = self.config
        rate = 0.0 if deterministic else cfg.dropout_rate
        working = streams[:, :, 0, :] if cfg.use_hyper_connections else x
        attn_input = self.attn_norm(working)
        if capture is not None:
            capture.append(attn_input)
        if cache is not None:
            name = "sparse_attention" if cfg.use_sparse_attention else "causal_attention"
            attn_out = self.attention.decode(attn_input, cache[name], positions)
        elif cfg.use_sparse_attention:
            attn_out = self.sparse_attention(attn_input, lengths)
        else:
            attn_out = self.causal_attention(attn_input)
        attn_out = F.dropout(attn_out, rate, training=rate > 0)
        if cfg.use_hyper_connections:
            streams, working = self.mhc_attn(streams, attn_out, 0)
        else:
            working = working + attn_out

        ffn_input = self.ffn_norm(working)
        if cfg.use_moe:
            ffn_out, aux = self.moe(ffn_input, update_stats)
        else:
            ffn_out = self.ffn_down(F.gelu(self.ffn_up(ffn_input), approximate="tanh"))
            aux = torch.zeros((), device=x.device)
        ffn_out = F.dropout(ffn_out, rate, training=rate > 0)
        if cfg.use_hyper_connections:
            streams, output = self.mhc_ffn(streams, ffn_out, 0)
        else:
            output, streams = working + ffn_out, None
        return output, streams, aux


class FORDEDecoderLM(torch.nn.Module):
    """Decoder-only LM with MoE + NSA + mHC. ``forward`` returns (logits
    fp32, total MoE aux loss)."""

    def __init__(self, config: LLMConfig, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dt, pdt = cfg.dtypes.compute, cfg.dtypes.param
        kw = dict(dtype=dt, param_dtype=pdt, device=device)
        self.token_embed = torch.nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=pdt, device=device)
        self.pos_embed = torch.nn.Embedding(cfg.max_seq_len, cfg.d_model, dtype=pdt, device=device)
        if cfg.use_hyper_connections:
            self.initial_streams = HyperConnectionStream(cfg.num_streams, cfg.d_model, **kw)
        self.layers = torch.nn.ModuleList(DecoderBlock(cfg, device) for _ in range(cfg.num_layers))
        if cfg.use_hyper_connections:
            self.stream_collapser = StreamCollapser(cfg.d_model, cfg.num_streams, **kw)
        self.final_norm = LayerNorm(cfg.d_model, **kw)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, **kw)
        if generator is not None:
            self.init_params(generator)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` with the JAX package's
        initialisers: embeddings N(0, 1/num_embeddings), Dense kernels
        N(0, 1/fan_in) (lm_head, router and stream expansion N(0, 0.02)),
        expert banks N(0, 1/fan_in), mixing logits N(0, 0.1); biases 0,
        norms 1, stream weights 1."""
        # Children before their parents, so that a module's own
        # initialiser (stream expansion, router) overrides its Dense's.
        for module in reversed(list(self.modules())):
            if isinstance(module, LayerNorm):
                module.reset_parameters()
            elif module is not self and hasattr(module, "init_params"):
                module.init_params(generator)
        for emb in (self.token_embed, self.pos_embed):
            emb.weight.normal_(0.0, emb.num_embeddings ** -0.5, generator=generator)
        self.lm_head.weight.normal_(0.0, 0.02, generator=generator)

    def init_cache(self, batch: int, device=None) -> dict:
        """An empty decode cache, the JAX package's tree: ``pos_index`` and
        one ``layer_{i}`` entry per block."""
        device = self.lm_head.weight.device if device is None else device
        cache = {"pos_index": torch.zeros((), dtype=torch.int32, device=device)}
        name = "sparse_attention" if self.config.use_sparse_attention else "causal_attention"
        for i, layer in enumerate(self.layers):
            cache[f"layer_{i}"] = {name: layer.attention.init_cache(batch, device)}
        return cache

    def forward(
        self,
        input_ids: torch.Tensor,
        lengths: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        positions: Optional[torch.Tensor] = None,
        capture: Optional[List[torch.Tensor]] = None,
        update_stats: bool = False,
        deterministic: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``lengths`` (B,): the ragged NSA forward of right-padded rows.
        ``cache``: the cached pass (prefill at ``pos_index``, or one token
        per row at ``positions`` (B,)). ``capture``: receives each block's
        attention input. ``update_stats``: the MoE layers add this call's
        router statistics to their buffers."""
        cfg = self.config
        dt = cfg.dtypes.compute
        b, s = input_ids.shape
        steps = torch.arange(s, device=input_ids.device)
        if cache is not None:
            offset = cache["pos_index"].to(torch.int64)
            cache["pos_index"] += s
            if positions is not None:
                position_ids = positions.to(torch.int64)[:, None] + steps[None, :]
            else:
                position_ids = (offset + steps)[None, :]
        else:
            position_ids = steps[None, :]
        x = self.token_embed(input_ids.to(torch.int64)).to(dt)
        x = x + self.pos_embed(position_ids).to(dt)
        x = F.dropout(x, cfg.dropout_rate, training=not deterministic and cfg.dropout_rate > 0)

        streams = self.initial_streams(x) if cfg.use_hyper_connections else None
        total_aux = torch.zeros((), device=x.device)
        for i, layer in enumerate(self.layers):
            x, streams, aux = layer(
                x, streams, lengths, None if cache is None else cache[f"layer_{i}"],
                positions, capture, update_stats, deterministic,
            )
            total_aux = total_aux + aux

        if cfg.use_hyper_connections:
            if cfg.reference_quirks:
                # The reference computes final_norm and drops it: lm_head
                # reads the raw collapsed streams.
                x = self.stream_collapser(streams)
            else:
                x = self.final_norm(self.stream_collapser(streams))
        else:
            x = self.final_norm(x)
        return self.lm_head(x).float(), total_aux
