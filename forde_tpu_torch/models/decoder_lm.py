"""FORDE decoder-only language model (port of
forde_tpu/models/decoder_lm.py).

Token + learned positional embeddings, pre-norm blocks of [NSA-or-causal
attention, mHC-or-plain residual, MoE-or-dense FFN, mHC-or-plain
residual], final norm, stream collapse, lm_head. The blocks are unrolled
(``layers.{i}``, the JAX package's ``layer_{i}``) in either layout:
``scan_layers`` is a checkpoint layout here (``interop.split_scan_layers``
on load, ``stack_scan_layers`` on save), since the port compiles no
program whose size the scan would shrink. With ``remat`` a training
forward recomputes each block in the backward (nn/remat.py); the
embedding, stream collapse, final norm, lm_head and loss are kept.

``forward`` is the teacher-forced pass (``lengths`` for right-padded
rows) or, given a ``cache`` from ``init_cache``, the cached pass: a
prefill at the cache's position counter or one token per row at
``positions``. The cache is updated in place. Logits are fp32.

``mesh`` (core/mesh.py) reaches every block: a training forward then
takes this rank's tokens (batch split over data, sequence over context,
its learned positions starting at rank * S_local) and the attention and
MoE sublayers run their multi-device paths. Tensor parallelism is set on
the modules by ``train.state.shard_model`` (parallel/tensor_parallel.py),
GPipe stages run through ``parallel.pipeline.pp_forward``, and FSDP-split
parameters are gathered per block (``parallel.fsdp.call``).

With ``config.quantized`` (int8 serving, ops/quant.py) the dense-causal
attention's ``qkv_proj``/``out_proj``, the dense FFN's ``ffn_up``/
``ffn_down``, the ``lm_head`` and the MoE expert bank hold int8 weights;
the NSA branches stay fp. Such a model takes its weights from
``ops.quant.quantize_params``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.core.config import LLMConfig
from forde_tpu_torch.nn import remat
from forde_tpu_torch.nn.attention import CausalSelfAttention, NativeSparseAttention
from forde_tpu_torch.nn.hyper_connections import (
    HyperConnectionStream,
    ManifoldHyperConnection,
    StreamCollapser,
)
from forde_tpu_torch.nn.layers import Dense, LayerNorm
from forde_tpu_torch.nn.moe import MoEStatefulLayer
from forde_tpu_torch.ops.quant import QDense
from forde_tpu_torch.parallel import fsdp


class DecoderBlock(torch.nn.Module):
    """Pre-norm decoder block."""

    def __init__(self, config: LLMConfig, device=None, mesh=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtypes.compute, param_dtype=cfg.dtypes.param, device=device)
        self.attn_norm = LayerNorm(cfg.d_model, **kw)
        if cfg.use_sparse_attention:
            self.sparse_attention = NativeSparseAttention(
                cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.window_size,
                cfg.compression_ratio, cfg.top_k_global, impl=cfg.attention_impl,
                max_decode_len=cfg.max_seq_len, mesh=mesh, **kw,
            )
        else:
            self.causal_attention = CausalSelfAttention(
                cfg.d_model, cfg.num_heads, cfg.head_dim, impl=cfg.attention_impl,
                max_decode_len=cfg.max_seq_len, quantized=cfg.quantized, mesh=mesh, **kw,
            )
        mhc = dict(param_dtype=cfg.dtypes.param, device=device)
        if cfg.use_hyper_connections:
            self.mhc_attn = ManifoldHyperConnection(cfg.num_streams, cfg.sinkhorn_iterations, **mhc)
        self.ffn_norm = LayerNorm(cfg.d_model, **kw)
        if cfg.use_moe:
            self.moe = MoEStatefulLayer(
                cfg.num_experts, cfg.top_k_experts, cfg.expert_hidden_dim, cfg.d_model,
                cfg.moe_aux_loss_weight, cfg.moe_dispatch, cfg.moe_capacity_factor, **kw,
                quantized=cfg.quantized, mesh=mesh,
            )
        elif cfg.quantized:
            self.ffn_up = QDense(cfg.d_model, cfg.expert_hidden_dim, dtype=kw["dtype"],
                                 device=device)
            self.ffn_down = QDense(cfg.expert_hidden_dim, cfg.d_model, dtype=kw["dtype"],
                                   device=device)
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

    def __init__(self, config: LLMConfig, device=None, generator: Optional[torch.Generator] = None,
                 mesh=None):
        super().__init__()
        cfg = self.config = config
        self.mesh = mesh
        dt, pdt = cfg.dtypes.compute, cfg.dtypes.param
        kw = dict(dtype=dt, param_dtype=pdt, device=device)
        self.token_embed = torch.nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=pdt, device=device)
        self.pos_embed = torch.nn.Embedding(cfg.max_seq_len, cfg.d_model, dtype=pdt, device=device)
        if cfg.use_hyper_connections:
            self.initial_streams = HyperConnectionStream(cfg.num_streams, cfg.d_model, **kw)
        self.layers = torch.nn.ModuleList(
            DecoderBlock(cfg, device, mesh) for _ in range(cfg.num_layers))
        if cfg.use_hyper_connections:
            self.stream_collapser = StreamCollapser(cfg.d_model, cfg.num_streams, **kw)
        self.final_norm = LayerNorm(cfg.d_model, **kw)
        if cfg.quantized:
            self.lm_head = QDense(cfg.d_model, cfg.vocab_size, dtype=dt, device=device)
        else:
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
        if self.config.quantized:
            raise ValueError("a quantized model takes its weights from "
                             "ops.quant.quantize_params, not from a random init")
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

    def set_mesh(self, mesh) -> "FORDEDecoderLM":
        """Put the model (e.g. one loaded from a checkpoint) on ``mesh``:
        every module that takes a mesh holds this one."""
        for module in self.modules():
            if "mesh" in vars(module):
                module.mesh = mesh
        return self

    def _context_offset(self, s_local: int) -> int:
        from forde_tpu_torch.core.mesh import AXIS_CONTEXT

        return 0 if self.mesh is None else self.mesh.coords[AXIS_CONTEXT] * s_local

    def init_cache(self, batch: int, device=None) -> dict:
        """An empty decode cache, the JAX package's tree: ``pos_index`` and
        one ``layer_{i}`` entry per block."""
        device = self.token_embed.weight.device if device is None else device
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
            # on a context shard the block starts at rank * S_local
            position_ids = (steps + self._context_offset(s))[None, :]
        x, streams = self.embed(input_ids, position_ids, deterministic)
        total_aux = torch.zeros((), device=x.device)
        # cfg.remat: each block's activations are recomputed in the backward
        # (the JAX package's nn.remat(DecoderBlock)); no-grad calls and the
        # cached and capture passes (serving) never are
        rematted = (cfg.remat and torch.is_grad_enabled() and cache is None
                    and capture is None)
        for i, layer in enumerate(self.layers):
            args = (x, streams, lengths, None if cache is None else cache[f"layer_{i}"],
                    positions, capture, update_stats, deterministic)
            if rematted and not fsdp.is_split(layer):
                x, streams, aux = remat.checkpoint(
                    layer, *args,
                    preserve_rng_state=not deterministic and cfg.dropout_rate > 0,
                )
            else:  # an FSDP-split block is recomputed in the backward anyway
                x, streams, aux = fsdp.call(layer, *args)
            total_aux = total_aux + aux
        return self.head(x, streams), total_aux

    def embed(self, input_ids: torch.Tensor, position_ids: torch.Tensor,
              deterministic: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The prologue: token + position embeddings (after dropout) and,
        with mHC, the initial streams."""
        cfg = self.config
        dt = cfg.dtypes.compute
        x = fsdp.call(self.token_embed, input_ids.to(torch.int64)).to(dt)
        x = x + fsdp.call(self.pos_embed, position_ids).to(dt)
        x = F.dropout(x, cfg.dropout_rate, training=not deterministic and cfg.dropout_rate > 0)
        streams = fsdp.call(self.initial_streams, x) if cfg.use_hyper_connections else None
        return x, streams

    def head(self, x: torch.Tensor, streams: Optional[torch.Tensor]) -> torch.Tensor:
        """The epilogue: stream collapse, final norm and the logits."""
        cfg = self.config
        if cfg.use_hyper_connections:
            x = fsdp.call(self.stream_collapser, streams)
            if not cfg.reference_quirks:
                # (the reference computes final_norm and drops it: lm_head
                # reads the raw collapsed streams)
                x = fsdp.call(self.final_norm, x)
        else:
            x = fsdp.call(self.final_norm, x)
        return self.logits(x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of the final hidden states; a column-parallel
        ``lm_head`` (tensor parallelism) gives this rank's vocabulary
        columns, all-gathered over the model axis."""
        logits = fsdp.call(self.lm_head, x).float()
        if self.lm_head.tp is not None:
            from forde_tpu_torch.parallel.collectives import all_gather

            logits = all_gather(logits, self.lm_head.tp[1], dim=-1)
        return logits
