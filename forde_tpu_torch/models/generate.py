"""Autoregressive sampling for the decoder LM (port of
forde_tpu/models/generate.py).

* ``generate``: full recompute, one forward over the whole (B, P + N)
  buffer per new token. NSA's global top-k may pick positions not yet
  generated (its causal mask keeps them invisible), as in the reference.
* ``generate_cached``: one prefill over the prompt, then one cached decode
  step per new token (O(1) attention work each), for dense-causal and NSA
  configs. NSA prefills through ``nsa_prefill``.
* ``nsa_prefill``: one teacher-forced forward over the prompt, after
  which the NSA streaming caches are built from each layer's captured
  attention input (the local ring of k/v rows, the chunk sums and pool
  k/v, the running top-k set), exactly as token-by-token streaming would
  have left them.
* ``generate_ragged``: a right-padded batch of mixed-length prompts in one
  pass: each row prefills at its true length and decodes at its own
  position.
* ``prefill_prefix``: the cache of a shared prompt prefix (dense-causal
  configs), which ``generate_cached`` and ``generate_ragged`` continue
  from (``prefix_cache=``), tiled across their batch by
  ``tile_prefix_cache``, a copy: the decode writes its cache in place.
* ``generate_beam``: beam search over the cached decoder; each step
  gathers the surviving beams' cache rows into a new cache (eager), so
  every beam owns its rows.

Sampling: temperature 0 is greedy argmax; otherwise top-k and then
nucleus (top-p) filtering and a draw from ``generator`` (a
``torch.Generator`` on the logits' device). The JAX package's
``jax.random`` draws cannot be reproduced, so its greedy tokens are the
point of comparison. Every function runs under ``torch.no_grad``.

The decode step (``_decode_step``) reads and writes a ``DecodeState`` in
place, its step counter included, so that on the card it is captured once
into a CUDA graph (``core.graphs.StepGraph``) and replayed: the JAX
package's ``lax.scan`` of the step under ``jit``. The graph, its static
``DecodeState`` and the generator it draws from are kept on the model,
one per (batch, ragged or not, sampling settings, generator or none,
weights' storage), and each call copies its prefill's state into the
static one before the replays. ``cuda_graph=False`` runs the same step
eagerly (the control); on the CPU the step always runs eagerly.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import torch

from forde_tpu_torch.core import graphs
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.ops.moe_dispatch import top_k_desc
from forde_tpu_torch.ops.topk_replay import topk_replay


def _filter_logits(scaled: torch.Tensor, top_k: Optional[int], top_p: Optional[float]) -> torch.Tensor:
    """Top-k, then nucleus (top-p) filtering of (..., V) logits: masked
    entries become -inf. Top-k keeps every entry tied with the k-th
    largest; top-p keeps the smallest prefix of the descending order
    whose mass reaches top_p (the crossing token included)."""
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p} (0 would mask every token)")
    neg_inf = -float("inf")
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, neg_inf, scaled)
    if top_p is not None:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p  # mass before < p
        threshold = torch.where(keep, sorted_desc, -neg_inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < threshold, neg_inf, scaled)
    return scaled


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits) (-inf entries never drawn),
    by an exponential race: the argmax of p / E with E ~ Exp(1) per entry
    is drawn with probability p. Every op of it can be captured in a CUDA
    graph."""
    probs = torch.softmax(logits.float(), dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    race.clamp_(min=torch.finfo(race.dtype).tiny)  # p = 0 stays 0, never 0 / 0
    return torch.argmax(probs / race, dim=-1)


def _sample(next_logits, generator, temperature, top_k=None, top_p=None) -> torch.Tensor:
    if temperature == 0:
        return torch.argmax(next_logits, dim=-1)  # the first maximum
    return _categorical(_filter_logits(next_logits / temperature, top_k, top_p), generator)


def sample_rows(next_logits, generator, temps, top_ks=None, top_ps=None) -> torch.Tensor:
    """Per-row sampling parameters: ``temps`` (B,) (0 = greedy),
    ``top_ks`` (B,) int (0 = off), ``top_ps`` (B,) (1.0 = off). For rows
    with equal settings the masks are ``_filter_logits``'s."""
    greedy = torch.argmax(next_logits, dim=-1)
    scaled = next_logits / torch.clamp(temps, min=1e-6)[:, None]
    neg_inf = -float("inf")
    if top_ks is not None or top_ps is not None:
        v = scaled.shape[-1]
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        if top_ks is not None:
            kidx = torch.clamp(top_ks.to(torch.int64) - 1, 0, v - 1)
            kth = torch.gather(sorted_desc, -1, kidx[:, None])
            kth = torch.where(top_ks[:, None] > 0, kth, neg_inf)
            scaled = torch.where(scaled < kth, neg_inf, scaled)
            # masking only cuts the tail: the order needs no second sort
            sorted_desc = torch.where(sorted_desc < kth, neg_inf, sorted_desc)
        if top_ps is not None:
            probs = torch.softmax(sorted_desc, dim=-1)
            keep = torch.cumsum(probs, dim=-1) - probs < top_ps[:, None]
            threshold = torch.where(keep, sorted_desc, -neg_inf).amin(dim=-1, keepdim=True)
            scaled = torch.where(scaled < threshold, neg_inf, scaled)
    sampled = _categorical(scaled, generator)
    return torch.where(temps == 0.0, greedy, sampled)


@dataclasses.dataclass
class DecodeState:
    """What one decode step reads and writes, all in place: the model's
    ``cache``; ``token`` (B,) the token each row feeds next; ``done`` (B,)
    rows that emitted the EOS; ``positions`` (B,) each row's position at
    step 0 (the ragged batch) or None (the cache's own counters); ``t`` the
    steps taken (a device int64 scalar); ``out`` (B, max_seq_len) whose
    column t receives the token sampled at step t."""

    cache: dict
    token: torch.Tensor
    done: torch.Tensor
    positions: Optional[torch.Tensor]
    t: torch.Tensor
    out: torch.Tensor


def _decode_step(model, st: DecodeState, generator, sampling) -> torch.Tensor:
    """One cached step: feed ``st.token`` (at ``positions + t`` when
    given), sample, write the token at column t of ``st.out``, advance t.
    Returns the step's logits (B, V)."""
    temperature, top_k, top_p, eos_id, pad_id = sampling
    positions = None if st.positions is None else st.positions + st.t
    logits, _ = model(st.token[:, None], cache=st.cache, positions=positions)
    last = logits[:, 0, :]
    nxt = _sample(last, generator, temperature, top_k, top_p)
    nxt = torch.where(st.done, pad_id, nxt)
    if eos_id is not None:
        st.done.logical_or_(nxt == eos_id)
    st.out.index_copy_(1, st.t.reshape(1), nxt[:, None])
    st.token.copy_(nxt)
    st.t.add_(1)
    return last


def _fields(st: DecodeState) -> tuple:
    return tuple(getattr(st, f.name) for f in dataclasses.fields(st))


def _graph_key(model, st: DecodeState, sampling, generator) -> tuple:
    return (tuple(st.token.shape), st.token.device, st.positions is None, sampling,
            generator is None, graphs.tensor_ptrs(model))


def _decode(model, st: DecodeState, steps: int, generator, sampling,
            cuda_graph: bool) -> Tuple[Optional[torch.Tensor], DecodeState]:
    """``steps`` decode steps from ``st``: (the last step's logits, the
    state they leave). On CUDA with ``cuda_graph`` the steps replay the
    model's captured graph for these settings (captured on first use,
    whose warm-up is the first step), and the state returned is the
    graph's static one; otherwise they run eagerly on ``st``."""
    if steps <= 0:
        return None, st
    if steps > st.out.shape[1]:
        raise ValueError(f"{steps} decode steps exceed the token buffer ({st.out.shape[1]})")
    if not (cuda_graph and graphs.on_card(st.token)):
        for _ in range(steps):
            last = _decode_step(model, st, generator, sampling)
        return last, st

    cached = model.__dict__.setdefault("_decode_graphs", {})
    key = _graph_key(model, st, sampling, generator)
    entry = cached.get(key)
    if entry is None:
        static = DecodeState(*(graphs.clone_tree(f) for f in _fields(st)))
        own = None
        if generator is not None:
            # The graph draws from a generator of its own, which takes the
            # caller's state before the replays and hands it back after.
            own = torch.Generator(device=st.token.device)
            own.set_state(generator.get_state())
        # A weak reference: the graph, kept on the model, must not keep the
        # model alive (a replay does not call the function again).
        ref = weakref.ref(model)
        graph = graphs.StepGraph(lambda: _decode_step(ref(), static, own, sampling),
                                 generators=() if own is None else (own,))
        cached[key] = (graph, static, own)
        last, done_steps = graph.warmup_outputs, 1  # the warm-up was step 1
    else:
        graph, static, own = entry
        graphs.copy_tree_(_fields(static), _fields(st))
        if own is not None:
            own.set_state(generator.get_state())
        done_steps = 0
    for _ in range(steps - done_steps):
        last = graph.replay()
    if own is not None:
        generator.set_state(own.get_state())
    return last.clone(), static  # the graph's output buffer is rewritten by its next replay


def _first_state(model, cache, last_logits, generator, sampling, positions) -> DecodeState:
    temperature, top_k, top_p, eos_id, _ = sampling
    token = _sample(last_logits.float(), generator, temperature, top_k, top_p)
    done = torch.zeros_like(token, dtype=torch.bool)
    if eos_id is not None:
        done = token == eos_id
    dev = token.device
    return DecodeState(
        cache=cache, token=token, done=done, positions=positions,
        t=torch.zeros((), dtype=torch.int64, device=dev),
        out=torch.zeros(token.shape[0], model.config.max_seq_len, dtype=torch.int64, device=dev),
    )


def _generate(model, prompt_ids, lens, generator, max_new_tokens, temperature, top_k, top_p,
              eos_id, pad_id, cuda_graph,
              prefix_cache=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``generate_cached`` (``lens`` None) or ``generate_ragged``: (ids,
    the last decode step's logits (B, V), or None with one new token)."""
    b, p = prompt_ids.shape
    dev = prompt_ids.device
    sampling = (temperature, top_k, top_p, eos_id, pad_id)
    bidx = torch.arange(b, device=dev)
    if model.config.use_sparse_attention:
        if prefix_cache is not None:
            raise ValueError(_PREFIX_DENSE_ONLY)
        cache, last = nsa_prefill(model, prompt_ids, lens)
        positions = lens
    else:
        # A ragged buffer prefills as one; a pad row's k/v in the cache is
        # overwritten by the row's own token before any query sees it.
        if prefix_cache is None:
            cache = model.init_cache(b, dev)
        else:
            cache = tile_prefix_cache(prefix_cache, b)
        # A row's decode positions count the prefix (a device tensor, so
        # that a graphed decode reads it from its copied state).
        positions = None if lens is None else lens + cache["pos_index"].to(torch.int64)
        logits, _ = model(prompt_ids, cache=cache)
        last = logits[:, -1, :] if lens is None else logits[bidx, lens - 1]
    st = _first_state(model, cache, last, generator, sampling, positions)
    total = p + max_new_tokens
    if lens is None:
        ids = torch.zeros(b, total, dtype=torch.int64, device=dev)
        ids[:, :p] = prompt_ids
        first_col = torch.full((b,), p, dtype=torch.int64, device=dev)
    else:
        ids = torch.full((b, total), pad_id, dtype=torch.int64, device=dev)
        cols = torch.arange(total, device=dev)
        ids[:, :p] = torch.where(cols[None, :p] < lens[:, None], prompt_ids.to(torch.int64),
                                 ids[:, :p])
        first_col = lens
    ids[bidx, first_col] = st.token
    steps = max_new_tokens - 1
    last, st = _decode(model, st, steps, generator, sampling, cuda_graph)
    if steps > 0:
        cols = first_col[:, None] + 1 + torch.arange(steps, device=dev)[None, :]
        ids.scatter_(1, cols, st.out[:, :steps])
    return ids, last


@torch.no_grad()
def generate_cached(
    model: FORDEDecoderLM,
    prompt_ids: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 32,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    cuda_graph: bool = True,
    prefix_cache: Optional[dict] = None,
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt_ids`` (B, P)
    with the KV caches: (B, P + max_new_tokens), the prompt then the new
    tokens; a row that emitted ``eos_id`` continues with ``pad_id``. On
    CUDA the decode steps replay a CUDA graph unless ``cuda_graph`` is
    False.

    ``prefix_cache`` (dense-causal configs): a shared prefix's cache from
    ``prefill_prefix``. The prompt is the suffix, prefilled at the
    prefix's offset; the result holds suffix + continuation only, token
    for token what the concatenated prompt gives. The prefix cache itself
    is left as it was."""
    return _generate(model, prompt_ids, None, generator, max_new_tokens, temperature, top_k,
                     top_p, eos_id, pad_id, cuda_graph, prefix_cache)[0]


@torch.no_grad()
def generate_ragged(
    model: FORDEDecoderLM,
    prompt_ids: torch.Tensor,
    prompt_lens: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 32,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    cuda_graph: bool = True,
    prefix_cache: Optional[dict] = None,
) -> torch.Tensor:
    """Mixed-length prompts in one batch: ``prompt_ids`` (B, P_max)
    right-padded, ``prompt_lens`` (B,) true lengths (>= 1). Every row
    prefills at its length and decodes at its own position. Row i's result
    is ``out[i, :prompt_lens[i] + max_new_tokens]``; the slack up to the
    buffer's end (B, P_max + max_new_tokens) is ``pad_id``. On CUDA the
    decode steps replay a CUDA graph unless ``cuda_graph`` is False.
    ``prefix_cache``: as in ``generate_cached``, every row a suffix of the
    shared prefix (dense-causal configs)."""
    return _generate(model, prompt_ids, prompt_lens.to(torch.int64), generator, max_new_tokens,
                     temperature, top_k, top_p, eos_id, pad_id, cuda_graph, prefix_cache)[0]


@torch.no_grad()
def nsa_prefill(model: FORDEDecoderLM, prompt_ids: torch.Tensor,
                lengths: Optional[torch.Tensor] = None):
    """Teacher-forced prefill of an NSA model: (cache, last logits (B, V)).

    One forward over the prompt captures each layer's attention input x;
    every cache leaf is a per-token or per-chunk function of x: the ring
    holds the last ``w`` k/v rows, the pools the k/v projections of the
    complete chunk means, ``comp_chunk_sum`` the fp32 sum of the
    incomplete chunk, and the top-k set is the replay of ``topk_insert``
    over the prompt's importance scores (``ops.topk_replay``, every layer
    and row in one call, on the device). The cache is new storage; a
    graphed decode copies it into its static cache.

    ``lengths`` (B,): the ragged path over a right-padded ``prompt_ids``.
    The forward masks per row, and the caches are built per row (gathered
    ring slots, chunks inside the row's length only, pad scores -inf in
    the replay), equal to each row's exact-length prefill. The position
    counters (``pos_index``, ``nsa_pos``, ``cache_index``) cannot hold
    mixed lengths: batch 1 gets the true length, otherwise 0, and such a
    cache is decoded with per-row ``positions``. The logits are each
    row's last real token's.
    """
    cfg = model.config
    b, p = prompt_ids.shape
    dev = prompt_ids.device
    captured = []
    logits, _ = model(prompt_ids, lengths=lengths, capture=captured)
    cache = model.init_cache(b, dev)
    if lengths is None:
        counter = p
    else:
        lengths = lengths.to(torch.int64)
        counter = lengths[0] if b == 1 else 0
    cache["pos_index"].fill_(counter)

    ratio = cfg.compression_ratio
    pos = torch.arange(p, device=dev)
    topk_scores, topk_rows = [], []
    for i, (layer, x) in enumerate(zip(model.layers, captured)):
        nsa = layer.sparse_attention
        lc = cache[f"layer_{i}"]["sparse_attention"]
        lc["nsa_pos"].fill_(counter)

        # local branch: the ring of the last w k/v rows (slot = pos % w)
        la = lc["local_attention"]
        w = la["cached_key"].shape[2]
        _, k, v = nsa.local_attention._qkv(x)  # (B, H, P, d)
        if lengths is None:
            t = min(p, w)
            slots = torch.remainder(torch.arange(p - t, p, device=dev), w)
            la["cached_key"][:, :, slots] = k[:, :, p - t:].to(la["cached_key"].dtype)
            la["cached_value"][:, :, slots] = v[:, :, p - t:].to(la["cached_value"].dtype)
        else:
            # slot j holds the last position < len congruent to j mod w;
            # slots a short row never wrote stay zero
            j = torch.arange(w, device=dev)
            src = (lengths[:, None] - 1) - torch.remainder(lengths[:, None] - 1 - j[None, :], w)
            valid = (src >= 0)[:, None, :, None]
            idx = torch.clamp(src, 0, p - 1)[:, None, :, None].expand(-1, k.shape[1], -1, k.shape[3])
            for name, rows in (("cached_key", k), ("cached_value", v)):
                got = torch.gather(rows, 2, idx)
                la[name] = torch.where(valid, got, torch.zeros_like(got)).to(la[name].dtype)
        la["cache_index"].fill_(counter)

        # compressed branch: pools of the complete chunks, sum of the rest
        n_complete = p // ratio  # the padded buffer's chunk capacity
        if n_complete:
            means = x[:, : n_complete * ratio].reshape(b, n_complete, ratio, -1)
            means = means.float().mean(dim=2).to(x.dtype)
            ck = nsa._heads(nsa.compressed_k_proj(means))
            cv = nsa._heads(nsa.compressed_v_proj(means))
            if lengths is not None:
                cmask = (torch.arange(n_complete, device=dev)[None, :]
                         < (lengths // ratio)[:, None])[:, None, :, None]
                ck = torch.where(cmask, ck, torch.zeros_like(ck))
                cv = torch.where(cmask, cv, torch.zeros_like(cv))
            lc["comp_k"][:, :, :n_complete] = ck.to(lc["comp_k"].dtype)
            lc["comp_v"][:, :, :n_complete] = cv.to(lc["comp_v"].dtype)
        if lengths is None:
            lc["comp_chunk_sum"] = x[:, n_complete * ratio:].float().sum(dim=1)
        else:
            tmask = (pos[None, :] >= (lengths // ratio * ratio)[:, None]) & (
                pos[None, :] < lengths[:, None]
            )
            lc["comp_chunk_sum"] = torch.where(tmask[:, :, None], x, torch.zeros_like(x)).float().sum(dim=1)

        # top-k branch: scores now, the replay below for every layer at once
        scores = nsa.importance_scorer(x)[..., 0].float()  # (B, P)
        if lengths is not None:
            scores = torch.where(pos[None, :] < lengths[:, None], scores,
                                 torch.full_like(scores, -float("inf")))
        topk_scores.append(scores)
        topk_rows.append((nsa._heads(nsa.topk_k_proj(x)), nsa._heads(nsa.topk_v_proj(x))))

    k_sel = cache["layer_0"]["sparse_attention"]["topk_scores"].shape[1]
    kept, kept_idx = topk_replay(torch.stack(topk_scores).reshape(-1, p), k_sel, cfg.max_seq_len)
    kept, kept_idx = kept.reshape(-1, b, k_sel), kept_idx.reshape(-1, b, k_sel)
    for i, (tk, tv) in enumerate(topk_rows):
        lc = cache[f"layer_{i}"]["sparse_attention"]
        filled = (kept_idx[i] < p)[:, None, :, None]
        gidx = torch.clamp(kept_idx[i].to(torch.int64), max=p - 1)[:, None, :, None]
        gidx = gidx.expand(-1, tk.shape[1], -1, tk.shape[3])
        lc["topk_scores"], lc["topk_idx"] = kept[i], kept_idx[i]
        for name, rows in (("topk_k", tk), ("topk_v", tv)):
            got = torch.gather(rows, 2, gidx).to(lc[name].dtype)
            lc[name] = torch.where(filled, got, lc[name])

    if lengths is None:
        return cache, logits[:, -1, :]
    return cache, logits[torch.arange(b, device=dev), lengths - 1]


_PREFIX_DENSE_ONLY = ("prefix caching supports dense-causal configs only (NSA streaming "
                      "caches depend on what follows the prefix)")


@torch.no_grad()
def prefill_prefix(model: FORDEDecoderLM, prefix_ids: torch.Tensor) -> dict:
    """The cache of a shared prompt prefix (1, L), reusable by every
    request: its position counters stand at L. ``generate_cached`` and
    ``generate_ragged`` continue from it (``prefix_cache=``), copying it
    across their batch. Dense-causal configs only: NSA's pools and top-k
    set depend on what follows the prefix."""
    if model.config.use_sparse_attention:
        raise ValueError(_PREFIX_DENSE_ONLY)
    if prefix_ids.shape[0] != 1:
        raise ValueError(f"a prefix is one sequence, got batch {prefix_ids.shape[0]}")
    cache = model.init_cache(1, prefix_ids.device)
    model(prefix_ids, cache=cache)
    return cache


def _map_cache_batch(cache: dict, fn) -> dict:
    """A new cache tree: ``fn(leaf)`` of every leaf with a batch axis (axis
    0), a copy of every position counter (0-d)."""
    return {k: _map_cache_batch(v, fn) if isinstance(v, dict)
            else (fn(v) if v.ndim else v.clone()) for k, v in cache.items()}


def tile_prefix_cache(prefix_cache: dict, b: int) -> dict:
    """A batch-1 prefix cache repeated across ``b`` rows, in new storage
    (counters copied too): the decode writes the cache it is given in
    place, and the prefix must stay as it was for the next request."""
    return _map_cache_batch(prefix_cache, lambda x: x.repeat_interleave(b, dim=0))


def prefix_length(prefix_cache: dict) -> torch.Tensor:
    """Token length of a prefix cache (its model-level position counter)."""
    return prefix_cache["pos_index"]


@torch.no_grad()
def generate_beam(
    model: FORDEDecoderLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int = 32,
    beam_size: int = 4,
    length_penalty: float = 0.0,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
):
    """Beam search over the cached decoder: the prompt is prefilled once per
    row (NSA through ``nsa_prefill``), its cache repeated beam-major; each
    step expands every beam by the vocabulary, keeps each row's
    ``beam_size`` best continuations (ties to the lower index, as
    ``lax.top_k``), and gathers the surviving beams' cache rows into a new
    cache, so that each beam owns its rows. Returns the best beam (B, P +
    max_new_tokens).

    ``eos_id``: a beam that emits it is finished: it extends only with
    ``pad_id`` at logprob 0, so its score stays. Final scores are the
    summed logprobs over ``gen_len ** length_penalty`` (gen_len counts a
    finished beam's tokens up to its EOS; 0 = the plain sum).
    """
    b, p = prompt_ids.shape
    k = beam_size
    dev = prompt_ids.device
    if model.config.use_sparse_attention:
        cache, last = nsa_prefill(model, prompt_ids)
    else:
        cache = model.init_cache(b, dev)
        logits, _ = model(prompt_ids, cache=cache)
        last = logits[:, -1, :]
    cache = _map_cache_batch(cache, lambda x: x.repeat_interleave(k, dim=0))
    logprobs0 = torch.log_softmax(last.float(), dim=-1)
    vocab = logprobs0.shape[-1]
    top_lp, top_tok = top_k_desc(logprobs0, k)  # (B, k)
    scores = top_lp.reshape(b * k)
    token = top_tok.reshape(b * k)
    ids = torch.zeros(b * k, p + max_new_tokens, dtype=torch.int64, device=dev)
    ids[:, :p] = prompt_ids.repeat_interleave(k, dim=0)
    ids[:, p] = token
    done = torch.zeros(b * k, dtype=torch.bool, device=dev)
    gen_len = torch.ones(b * k, dtype=torch.int64, device=dev)
    if eos_id is not None:
        done = token == eos_id
    pad_only = torch.full((vocab,), -float("inf"), device=dev)
    pad_only[pad_id] = 0.0
    row_base = (torch.arange(b, device=dev) * k)[:, None]

    for cur in range(p + 1, p + max_new_tokens):
        logits, _ = model(token[:, None], cache=cache)
        lp = torch.log_softmax(logits[:, 0, :].float(), dim=-1)
        if eos_id is not None:
            lp = torch.where(done[:, None], pad_only[None, :], lp)
        cand = (scores[:, None] + lp).reshape(b, k * vocab)
        new_scores, flat = top_k_desc(cand, k)  # (B, k)
        rows = (row_base + torch.div(flat, vocab, rounding_mode="floor")).reshape(b * k)
        token = torch.remainder(flat, vocab).reshape(b * k)
        ids = ids[rows]
        ids[:, cur] = token
        cache = _map_cache_batch(cache, lambda x: x.index_select(0, rows))
        done = done[rows]
        gen_len = gen_len[rows] + (~done).to(torch.int64)
        if eos_id is not None:
            done = done | (token == eos_id)
        scores = new_scores.reshape(b * k)
    if length_penalty:
        scores = scores / gen_len.float() ** length_penalty
    best = torch.argmax(scores.reshape(b, k), dim=-1)  # the first maximum
    return ids.reshape(b, k, -1)[torch.arange(b, device=dev), best]


@torch.no_grad()
def generate(
    model: FORDEDecoderLM,
    prompt_ids: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 32,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
) -> torch.Tensor:
    """Full-recompute sampling: every new token runs one forward over the
    whole (B, P + max_new_tokens) buffer (not-yet-generated positions
    hold 0) and samples from the logits at the last filled position.
    Correct for every config; an NSA config's top-k may pick the unfilled
    positions, which its causal mask keeps invisible. The MoE stat buffers
    stay as loaded. Returns (B, P + max_new_tokens)."""
    b, p = prompt_ids.shape
    dev = prompt_ids.device
    ids = torch.zeros(b, p + max_new_tokens, dtype=torch.int64, device=dev)
    ids[:, :p] = prompt_ids
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for cur in range(p, p + max_new_tokens):
        logits, _ = model(ids)
        nxt = _sample(logits[:, cur - 1, :], generator, temperature, top_k, top_p)
        nxt = torch.where(done, pad_id, nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        ids[:, cur] = nxt
    return ids
