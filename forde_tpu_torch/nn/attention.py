"""Attention modules of the decoder LM: Native Sparse Attention, its
sliding-window local branch, and dense causal attention (port of
forde_tpu/nn/attention.py).

Each module has a ``forward`` (the teacher-forced pass; NSA also takes
``lengths`` for right-padded rows), a ``decode`` step that reads and
updates an explicit cache, and ``init_cache``. A cache is a dict of
tensors with the JAX package's leaf names, updated IN PLACE by
``decode``: every leaf keeps its storage from step to step, which a decode
step captured in a CUDA graph needs (the decode loop owns the cache;
nothing else holds a reference).

Reference quirks kept: NSA's top-k selection is global per sequence
(stable: ties keep the lower index, as ``lax.top_k``); the compressed
branch pools the first ``num_pools * ratio`` positions with a modular
wrap and a pool-granular causal mask; masked small-KV scores are -1e9
(uniform attention for a query that sees no key); the branch gates are
static floats of the length (per-row tensors with ``lengths``, per-row
positions in decode), and a gated-off branch is computed and multiplied
by 0.

Given a ``mesh`` whose context axis is above 1 (training under context
parallelism), ``forward`` takes this rank's block of the sequence and the
attention runs over the global one: the sliding window through
``parallel.nsa_context.window_attention_cp``, dense causal attention
through ``parallel.ring_attention``, and NSA's global branches with the
global length in their gates and pool count, pool means all-gathered, a
global top-k over the all-gathered importance scores (the rows fetched by
``topk_select_cp``) and ``small_kv_attention_cp``. Decode and the ragged
forward stay single-device (serving).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from forde_tpu_torch.nn.layers import Dense
from forde_tpu_torch.ops import attention_ref
from forde_tpu_torch.ops.flash_attention import flash_attention
from forde_tpu_torch.ops.moe_dispatch import top_k_desc
from forde_tpu_torch.ops.nsa_attention import INVALID_KEY_POS, small_kv_attention
from forde_tpu_torch.ops.quant import QDense

Cache = Dict[str, torch.Tensor]


def _split_heads(x: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _qkv_heads(qkv: torch.Tensor, num_heads: int, head_dim: int):
    return tuple(_split_heads(t, num_heads, head_dim) for t in qkv.chunk(3, dim=-1))


def _context_group(mesh):
    """The context axis' group when it is above 1, else None."""
    from forde_tpu_torch.core.mesh import AXIS_CONTEXT

    if mesh is None or mesh.shape[AXIS_CONTEXT] == 1:
        return None
    return mesh.group(AXIS_CONTEXT)


def _counter(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def topk_insert(state, new_score, new_k, new_v, pos):
    """One insertion into the running top-k set of the NSA decode cache.

    ``state = (scores (B, K) fp32, idxs (B, K) int32, k (B, H, K, d),
    v)``; ``new_score (B,)``, ``new_k``/``new_v`` (B, H, 1, d), ``pos`` a
    scalar or (B,) source position. The new entry replaces the set's first
    minimum iff strictly greater, so ties keep the earlier index: the
    same winners as ``lax.top_k`` over the whole prefix. Returns the new
    state (new tensors).
    """
    scores, idxs, kk, vv = state
    slot = torch.argmin(scores, dim=1)  # the first minimum
    min_score = torch.gather(scores, 1, slot[:, None])[:, 0]
    accept = new_score > min_score
    upd = torch.nn.functional.one_hot(slot, scores.shape[1]).bool() & accept[:, None]
    scores = torch.where(upd, new_score[:, None], scores)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=idxs.device)
    idxs = torch.where(upd, pos[:, None] if pos.ndim == 1 else pos, idxs)
    sel = upd[:, None, :, None]
    kk = torch.where(sel, new_k.to(kk.dtype), kk)
    vv = torch.where(sel, new_v.to(vv.dtype), vv)
    return scores, idxs, kk, vv


class SlidingWindowAttention(torch.nn.Module):
    """Causal sliding-window attention (``0 <= q - k < window_size``) on
    the 4-D flash kernel. Its decode cache is a ring of the last
    ``window_size`` k/v rows: slot ``pos % w`` holds position ``pos``."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int, window_size: int = 512,
                 impl: str = "auto", dtype=torch.float32, max_decode_len: int = 2048,
                 param_dtype=torch.float32, device=None, mesh=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.window_size, self.impl, self.dtype = window_size, impl, dtype
        self.max_decode_len = max_decode_len
        self.mesh = mesh
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.qkv_proj = Dense(d_model, 3 * num_heads * head_dim, **kw)
        self.out_proj = Dense(num_heads * head_dim, d_model, **kw)

    def _qkv(self, x):
        return _qkv_heads(self.qkv_proj(x), self.num_heads, self.head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self._qkv(x)
        if _context_group(self.mesh) is not None:
            from forde_tpu_torch.parallel.nsa_context import window_attention_cp

            out = window_attention_cp(q, k, v, self.mesh, self.window_size, impl=self.impl)
        else:
            out = flash_attention(q, k, v, causal=True, window_size=self.window_size,
                                  impl=self.impl)
        return self.out_proj(_merge_heads(out))

    def ring_size(self) -> int:
        return min(self.window_size, self.max_decode_len)

    def init_cache(self, batch: int, device) -> Cache:
        shape = (batch, self.num_heads, self.ring_size(), self.head_dim)
        return {
            "cached_key": torch.zeros(shape, dtype=self.dtype, device=device),
            "cached_value": torch.zeros(shape, dtype=self.dtype, device=device),
            "cache_index": _counter(device),
        }

    def decode(self, x: torch.Tensor, cache: Cache,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row (its position: ``positions`` (B,), or the
        shared ``cache_index``) against the ring; or, with S > 1, a
        prefill from an empty cache: window attention over the call's own
        k/v, whose last ``w`` rows are written into the ring."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        w = self.ring_size()
        keys, values = cache["cached_key"], cache["cached_value"]
        if s == 1:
            idx = (positions.to(torch.int64) if positions is not None
                   else cache["cache_index"].to(torch.int64).expand(b))
            bidx = torch.arange(b, device=x.device)
            slot = torch.remainder(idx, w)
            keys[bidx, :, slot] = k[:, :, 0].to(keys.dtype)
            values[bidx, :, slot] = v[:, :, 0].to(values.dtype)
            cache["cache_index"] += 1
            # Slot j holds position idx - ((idx - j) mod w): within the
            # window by construction; slots not yet written (< 0) are masked.
            j = torch.arange(w, device=x.device)
            slot_pos = idx[:, None] - torch.remainder(idx[:, None] - j[None, :], w)
            out = attention_ref.mha_reference(q, keys, values, mask=(slot_pos >= 0)[:, None, None, :])
        else:
            out = flash_attention(q, k, v, causal=True, window_size=self.window_size,
                                  impl=self.impl)
            t = min(s, w)
            slots = torch.remainder(torch.arange(s - t, s, device=x.device), w)
            keys[:, :, slots] = k[:, :, s - t:].to(keys.dtype)
            values[:, :, slots] = v[:, :, s - t:].to(values.dtype)
            cache["cache_index"] += s
        return self.out_proj(_merge_heads(out))


class CausalSelfAttention(torch.nn.Module):
    """Dense causal attention; its decode cache holds ``max_decode_len``
    k/v rows. ``quantized``: int8 ``qkv_proj``/``out_proj`` (serving)."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int, impl: str = "auto",
                 dtype=torch.float32, max_decode_len: int = 2048,
                 param_dtype=torch.float32, device=None, quantized: bool = False,
                 mesh=None):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.impl, self.dtype, self.max_decode_len = impl, dtype, max_decode_len
        self.mesh = mesh
        hd = num_heads * head_dim
        if quantized:
            self.qkv_proj = QDense(d_model, 3 * hd, dtype=dtype, device=device)
            self.out_proj = QDense(hd, d_model, dtype=dtype, device=device)
        else:
            kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
            self.qkv_proj = Dense(d_model, 3 * hd, **kw)
            self.out_proj = Dense(hd, d_model, **kw)

    def _qkv(self, x):
        return _qkv_heads(self.qkv_proj(x), self.num_heads, self.head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self._qkv(x)
        if _context_group(self.mesh) is not None:
            from forde_tpu_torch.parallel.ring_attention import ring_attention

            out = ring_attention(q, k, v, self.mesh, causal=True)
        else:
            out = flash_attention(q, k, v, causal=True, impl=self.impl)
        return self.out_proj(_merge_heads(out))

    def init_cache(self, batch: int, device) -> Cache:
        shape = (batch, self.num_heads, self.max_decode_len, self.head_dim)
        return {
            "cached_key": torch.zeros(shape, dtype=self.dtype, device=device),
            "cached_value": torch.zeros(shape, dtype=self.dtype, device=device),
            "cache_index": _counter(device),
        }

    def decode(self, x: torch.Tensor, cache: Cache,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With ``positions`` (B,): one token per row at its own position
        (the ragged batch), masked per row. Without: the call's S tokens
        at the shared ``cache_index``, causal within the call."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        keys, values = cache["cached_key"], cache["cached_value"]
        k_pos = torch.arange(self.max_decode_len, device=x.device)
        if positions is not None:
            if s != 1:
                raise ValueError(f"per-row positions take one token per call, got {s}")
            bidx = torch.arange(b, device=x.device)
            pos = positions.to(torch.int64)
            keys[bidx, :, pos] = k[:, :, 0].to(keys.dtype)
            values[bidx, :, pos] = v[:, :, 0].to(values.dtype)
            cache["cache_index"] += 1
            mask = (k_pos[None, :] <= pos[:, None])[:, None, None, :]
        else:
            rows = cache["cache_index"].to(torch.int64) + torch.arange(s, device=x.device)
            keys.index_copy_(2, rows, k.to(keys.dtype))
            values.index_copy_(2, rows, v.to(values.dtype))
            cache["cache_index"] += s
            mask = (k_pos[None, :] <= rows[:, None])[None, None]
        out = attention_ref.mha_reference(q, keys, values, mask=mask)
        return self.out_proj(_merge_heads(out))


class NativeSparseAttention(torch.nn.Module):
    """Three-branch NSA: local (sliding-window flash) + gated compressed
    global + gated top-k, each global branch on the small-KV kernel."""

    def __init__(self, d_model: int, num_heads: int = 8, head_dim: int = 64,
                 window_size: int = 512, compression_ratio: int = 8, top_k_global: int = 64,
                 use_compressed: bool = True, use_top_k: bool = True, impl: str = "auto",
                 dtype=torch.float32, max_decode_len: int = 2048,
                 param_dtype=torch.float32, device=None, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.num_heads, self.head_dim = num_heads, head_dim
        self.window_size, self.compression_ratio = window_size, compression_ratio
        self.top_k_global = top_k_global
        self.use_compressed, self.use_top_k = use_compressed, use_top_k
        self.impl, self.dtype, self.max_decode_len = impl, dtype, max_decode_len
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        hd = num_heads * head_dim
        self.local_attention = SlidingWindowAttention(
            d_model, num_heads, head_dim, window_size, impl, dtype, max_decode_len,
            param_dtype, device, mesh,
        )
        if use_compressed:
            self.compressed_q_proj = Dense(d_model, hd, **kw)
            self.compressed_k_proj = Dense(d_model, hd, **kw)
            self.compressed_v_proj = Dense(d_model, hd, **kw)
            self.compressed_out_proj = Dense(hd, d_model, **kw)
            self.gate_compressed = Dense(d_model, d_model, **kw)
        if use_top_k:
            self.importance_scorer = Dense(d_model, 1, **kw)
            self.topk_q_proj = Dense(d_model, hd, **kw)
            self.topk_k_proj = Dense(d_model, hd, **kw)
            self.topk_v_proj = Dense(d_model, hd, **kw)
            self.topk_out_proj = Dense(hd, d_model, **kw)
            self.gate_top_k = Dense(d_model, d_model, **kw)

    def _heads(self, x):
        return _split_heads(x, self.num_heads, self.head_dim)

    # ---- teacher-forced forward ----------------------------------------

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lengths`` (B,): the ragged forward. ``x`` is right-padded and
        every position < lengths[i] computes what a forward of row i alone
        at its length would: per-row gates, pad importance at -inf, and
        per-row pool counts (pools past them are INVALID_KEY_POS keys)."""
        cp = _context_group(self.mesh)
        if cp is not None and lengths is not None:
            raise ValueError("the ragged NSA forward is a serving path: not under context "
                             "parallelism")
        s = x.shape[1] * (1 if cp is None else cp.size)  # the global length
        w, ratio = self.window_size, self.compression_ratio
        output = self.local_attention(x)
        if lengths is None:
            use_c = 1.0 if s - w > ratio else 0.0
            use_t = 1.0 if s > w else 0.0
        else:
            use_c = (lengths - w > ratio).to(x.dtype)[:, None, None]
            use_t = (lengths > w).to(x.dtype)[:, None, None]
        if self.use_compressed:
            gate_c = torch.sigmoid(self.gate_compressed(x))
            output = output + use_c * gate_c * self._compressed_global(x, lengths)
        if self.use_top_k:
            gate_t = torch.sigmoid(self.gate_top_k(x))
            output = output + use_t * gate_t * self._top_k(x, lengths)
        return output

    def _compressed_global(self, x, lengths):
        b, s, d_model = x.shape
        cp = _context_group(self.mesh)
        if cp is not None:
            s *= cp.size
        ratio = self.compression_ratio
        num_pools = max(max(s - self.window_size, ratio) // ratio, 1)
        if cp is not None:
            # Pooled on each rank, then all-gathered: num_pools * ratio <= S
            # here (S > window under context parallelism), so no pool wraps.
            from forde_tpu_torch.parallel.nsa_context import gather_pool_means_cp

            compressed = gather_pool_means_cp(x, self.mesh, ratio, num_pools)
        else:
            # The modular-wrap quirk: pool positions past S wrap to the start.
            pool_indices = torch.arange(num_pools * ratio, device=x.device) % s
            # jnp.mean of a bf16 array sums in fp32 and returns bf16.
            compressed = x[:, pool_indices].reshape(b, num_pools, ratio, d_model)
            compressed = compressed.float().mean(dim=2).to(x.dtype)
        q = self._heads(self.compressed_q_proj(x))
        k = self._heads(self.compressed_k_proj(compressed))
        v = self._heads(self.compressed_v_proj(compressed))
        # Pool p is visible to queries at positions >= (p + 1) * ratio.
        pool = torch.arange(num_pools, device=x.device)
        key_pos = ((pool + 1) * ratio)[None, :].expand(b, num_pools)
        if lengths is not None:
            np_row = torch.clamp(
                torch.clamp(lengths - self.window_size, min=ratio) // ratio, min=1
            )
            key_pos = torch.where(pool[None, :] < np_row[:, None], key_pos,
                                  torch.full_like(key_pos, INVALID_KEY_POS))
        out = self._small_kv(q, k, v, key_pos, cp)
        return self.compressed_out_proj(_merge_heads(out).to(x.dtype))

    def _small_kv(self, q, k, v, key_pos, cp):
        if cp is None:
            return small_kv_attention(q, k, v, key_pos, impl=self.impl)
        from forde_tpu_torch.parallel.nsa_context import small_kv_attention_cp

        return small_kv_attention_cp(q, k, v, key_pos, self.mesh, impl=self.impl)

    def _top_k(self, x, lengths):
        b, s, _ = x.shape
        cp = _context_group(self.mesh)
        importance = self.importance_scorer(x)[..., 0]
        if cp is not None:
            # a global top-k: the (B, S) scores are gathered, not the rows;
            # they only pick indices, so they carry no gradient
            importance = torch.cat(cp.all_gather(importance.detach()), dim=1)
            s = importance.shape[1]
        k_sel = min(self.top_k_global, s)
        if lengths is not None:
            pos = torch.arange(s, device=x.device)
            importance = torch.where(pos[None, :] < lengths[:, None], importance,
                                     torch.full_like(importance, -float("inf")))
        _, idx = top_k_desc(importance, k_sel)  # global per sequence
        if cp is not None:
            from forde_tpu_torch.parallel.nsa_context import topk_select_cp

            selected = topk_select_cp(x, idx, self.mesh)
        else:
            selected = x[torch.arange(b, device=x.device)[:, None], idx]
        q = self._heads(self.topk_q_proj(x))
        kk = self._heads(self.topk_k_proj(selected))
        vv = self._heads(self.topk_v_proj(selected))
        # Selected token j is visible to queries at positions >= its index.
        out = self._small_kv(q, kk, vv, idx, cp)
        return self.topk_out_proj(_merge_heads(out).to(x.dtype))

    # ---- streaming decode ---------------------------------------------

    def max_pools(self) -> int:
        return max(self.max_decode_len // self.compression_ratio, 1)

    def topk_size(self) -> int:
        return min(self.top_k_global, self.max_decode_len)

    def init_cache(self, batch: int, device) -> Cache:
        """The JAX package's NSA cache: the local ring, the running chunk
        sum and pool k/v, and the running top-k set (empty slots: score
        -inf, index max_decode_len)."""
        h, d = self.num_heads, self.head_dim
        cache = {"nsa_pos": _counter(device),
                 "local_attention": self.local_attention.init_cache(batch, device)}
        if self.use_compressed:
            d_model = self.compressed_q_proj.in_features
            pools = (batch, h, self.max_pools(), d)
            cache["comp_chunk_sum"] = torch.zeros(batch, d_model, dtype=torch.float32, device=device)
            cache["comp_k"] = torch.zeros(pools, dtype=self.dtype, device=device)
            cache["comp_v"] = torch.zeros(pools, dtype=self.dtype, device=device)
        if self.use_top_k:
            k_sel = self.topk_size()
            cache["topk_scores"] = torch.full((batch, k_sel), -float("inf"), device=device)
            cache["topk_idx"] = torch.full((batch, k_sel), self.max_decode_len,
                                           dtype=torch.int32, device=device)
            cache["topk_k"] = torch.zeros(batch, h, k_sel, d, dtype=self.dtype, device=device)
            cache["topk_v"] = torch.zeros(batch, h, k_sel, d, dtype=self.dtype, device=device)
        return cache

    def decode(self, x: torch.Tensor, cache: Cache,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row, at ``positions`` (B,) or the shared
        ``nsa_pos``: streaming semantics, each position computed at its
        own length. The gates read each row's length (position + 1)."""
        b, s, _ = x.shape
        if s != 1:
            raise ValueError(f"NSA decode takes one token per call, got {s}")
        cur = (positions.to(torch.int64) if positions is not None
               else cache["nsa_pos"].to(torch.int64).expand(b))
        w, ratio = self.window_size, self.compression_ratio
        output = self.local_attention.decode(x, cache["local_attention"], positions)
        seq_len = cur + 1
        if self.use_compressed:
            comp = self._compressed_decode(x, cur, cache)
            gate_c = torch.sigmoid(self.gate_compressed(x))
            use_c = (seq_len - w > ratio).to(x.dtype)
            output = output + use_c[:, None, None] * gate_c * comp
        if self.use_top_k:
            topk = self._top_k_decode(x, cur, cache)
            gate_t = torch.sigmoid(self.gate_top_k(x))
            use_t = (seq_len > w).to(x.dtype)
            output = output + use_t[:, None, None] * gate_t * topk
        cache["nsa_pos"] += 1
        return output

    def _compressed_decode(self, x, cur, cache):
        b = x.shape[0]
        ratio = self.compression_ratio
        new_sum = cache["comp_chunk_sum"] + x[:, 0, :].float()
        completes = torch.remainder(cur + 1, ratio) == 0  # this token closes a chunk
        pool_idx = torch.clamp((cur + 1) // ratio - 1, min=0)
        pool_mean = (new_sum / ratio).to(x.dtype)[:, None, :]
        new_k = self._heads(self.compressed_k_proj(pool_mean))[:, :, 0]
        new_v = self._heads(self.compressed_v_proj(pool_mean))[:, :, 0]
        bidx = torch.arange(b, device=x.device)
        sel = completes[:, None, None]
        for name, new in (("comp_k", new_k), ("comp_v", new_v)):
            buf = cache[name]
            buf[bidx, :, pool_idx] = torch.where(sel, new.to(buf.dtype), buf[bidx, :, pool_idx])
        cache["comp_chunk_sum"].copy_(torch.where(completes[:, None], 0.0, new_sum))
        # Pool p joins once seq_len - window >= (p + 1) * ratio; the one
        # query sits at position 0, so the thresholds shift by -cur.
        pool = torch.arange(self.max_pools(), device=x.device)
        key_pos = ((pool + 1) * ratio + self.window_size - 1)[None, :] - cur[:, None]
        q = self._heads(self.compressed_q_proj(x))
        out = small_kv_attention(q, cache["comp_k"], cache["comp_v"], key_pos, impl=self.impl)
        return self.compressed_out_proj(_merge_heads(out).to(x.dtype))

    def _top_k_decode(self, x, cur, cache):
        importance = self.importance_scorer(x)[:, 0, 0].float()
        new_k = self._heads(self.topk_k_proj(x))
        new_v = self._heads(self.topk_v_proj(x))
        names = ("topk_scores", "topk_idx", "topk_k", "topk_v")
        new_state = topk_insert(tuple(cache[n] for n in names), importance, new_k, new_v, cur)
        for name, t in zip(names, new_state):
            cache[name].copy_(t)
        _, ix, kk, vv = (cache[n] for n in names)
        # Kept row j is visible iff cur >= its source index (thresholds
        # shifted by -cur); empty slots sit at max_decode_len and stay masked.
        q = self._heads(self.topk_q_proj(x))
        out = small_kv_attention(q, kk, vv, ix.to(torch.int64) - cur[:, None], impl=self.impl)
        return self.topk_out_proj(_merge_heads(out).to(x.dtype))

