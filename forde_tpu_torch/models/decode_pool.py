"""Continuous batching (port of forde_tpu/models/decode_pool.py): a decode
pool of fixed capacity that requests join and leave token by token.

``generate_ragged`` decodes a closed batch: every row waits for the
slowest one, and a new request waits for the whole batch. The pool has
``rows`` decode slots, each with its own cache rows, position and
sampling settings:

* a request prefills into a free slot with a one-row prefill (NSA through
  ``nsa_prefill``), and its cache row is copied into the slot
  (``_insert_row``);
* one pooled step advances every slot one token at its own position
  (``_step_pool``), or ``decode_fuse`` tokens (``_step_pool_k``); an idle
  slot decodes a pad token into its own rows, which the next insert
  replaces whole;
* a slot frees as soon as its row emits the EOS or spends its budget, and
  the next queued request takes it on the following tick.

The state the pooled step reads and writes (``PoolState``: the cache, each
slot's token, position and sampling settings, the step's output tokens)
is one set of device tensors, written in place by admission, finishing and
cancelling. On the card each step is a CUDA graph replay
(``core.graphs.StepGraph``) that reads those tensors: one graph per
(filtered sampling or not, 1 or ``decode_fuse`` steps), at most four, all
over the same state, where the JAX package has at most two jitted step
programs and a fused one. The positions advance, and are clipped to
``max_seq_len - 1``, inside the step; they live on the device only.
The tokens of a tick come to the host in one read, after which the
``on_token`` callbacks fire. ``cuda_graph=False`` runs the same steps
eagerly (the control); on the CPU they always run eagerly.

The prefill runs at the prompt's exact length: the JAX package pads it to
a power of two to bound its compiles, and a CUDA program needs no such
bound. Chunked prefill (``prefill_chunk``, dense configs) runs one chunk
per tick, its last chunk at the length left, so a chunk never spills past
the cache's end. A prefix cache (``register_prefix``) is copied
(``tile_prefix_cache``) before a suffix prefill writes into it.

Spans and counters (``obs/spans.py``): ``pool.queue`` (a request's wait,
from ``submit`` to its slot), ``pool.prefill`` (its prompt's upload, the
prefill, its first token's sampling; ``prefill.forward`` and
``prefill.cache`` inside), ``pool.insert`` (its cache row and settings
into the slot, the first token's host read), each carrying the request's
id; ``pool.step`` (a pooled step and its host read); counters ``pool.submitted``, ``pool.admitted``, ``pool.steps`` and
``pool.rows_stepped`` (active rows times the steps they took).

Serves dense-causal and NSA configs; NSA refuses chunked prefill and
prefix caching, as in the reference. Sampling draws from a
``torch.Generator`` seeded from ``seed``: the same seed gives the same
tokens, but not the JAX package's ``jax.random`` draws, so greedy tokens
are the point of comparison with it. Call every method from one thread.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from forde_tpu_torch.core import graphs
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.models.generate import (
    nsa_prefill,
    prefill_prefix,
    sample_rows,
    tile_prefix_cache,
)
from forde_tpu_torch.obs import spans


def _first_token(last, generator, temp: float, topk: int, topp: float) -> torch.Tensor:
    """A request's first token (1,) from its prefill's last logits (1, V),
    sampled with its own settings (the filters skipped when off)."""
    dev = last.device
    filtered = topk > 0 or topp < 1.0
    return sample_rows(
        last.float(), generator, torch.full((1,), temp, device=dev),
        torch.full((1,), topk, device=dev) if filtered else None,
        torch.full((1,), topp, device=dev) if filtered else None,
    )


@torch.no_grad()
def _prefill_one(model, prompt, generator, temp, topk, topp):
    """Dense (1, P) prompt -> (its cache row, first token (1,))."""
    cache = model.init_cache(1, prompt.device)
    with spans.span("prefill.forward"):
        logits, _ = model(prompt, cache=cache)
    return cache, _first_token(logits[:, -1], generator, temp, topk, topp)


@torch.no_grad()
def _prefill_one_nsa(model, prompt, generator, temp, topk, topp):
    """NSA (1, P) prompt -> (its streaming cache row, first token (1,)):
    ``nsa_prefill`` at the prompt's exact length (the JAX package's padded
    bucket passes ``lengths``)."""
    cache, last = nsa_prefill(model, prompt)
    return cache, _first_token(last, generator, temp, topk, topp)


def _empty_row_cache(model) -> dict:
    """A fresh one-row cache (counters at 0) for chunked prefill."""
    return model.init_cache(1)


@torch.no_grad()
def _prefill_chunk(model, row_cache, chunk) -> torch.Tensor:
    """Advance one row's prefill by one chunk (1, c), in place: the cached
    pass writes the chunk's k/v at the row's offset and attends back over
    everything written, so a prompt in chunks is the same math as one
    prefill. Returns the chunk's last logits (1, V)."""
    logits, _ = model(chunk, cache=row_cache)
    return logits[:, -1]


@torch.no_grad()
def _prefill_suffix(model, prefix_cache, suffix, generator, temp, topk, topp):
    """Continue a copy of a shared prefix's cache with a (1, S) suffix ->
    (the row's cache, first token (1,)). The prefix cache is left as it
    was."""
    cache = tile_prefix_cache(prefix_cache, 1)
    logits, _ = model(suffix, cache=cache)
    return cache, _first_token(logits[:, -1], generator, temp, topk, topp)


def _insert_row(pool_cache: dict, row_cache: dict, slot: int) -> None:
    """Copy a one-row cache into pool slot ``slot``, in place: every leaf
    with a batch axis (axis 0); the 0-d position counters stay, since the
    pooled step decodes at per-slot positions."""
    for name, leaf in pool_cache.items():
        if isinstance(leaf, dict):
            _insert_row(leaf, row_cache[name], slot)
        elif leaf.ndim:
            leaf[slot].copy_(row_cache[name][0])


@dataclasses.dataclass
class PoolState:
    """What a pooled step reads and writes, all in place: the ``cache``
    (``rows`` rows); ``tokens`` (rows,) the token each slot feeds next and
    ``positions`` (rows,) its position; the per-slot sampling settings
    ``temps`` (0 = greedy), ``topks`` (0 = off), ``topps`` (1.0 = off);
    ``out`` (decode_fuse, rows), whose row i receives step i's tokens."""

    cache: dict
    tokens: torch.Tensor
    positions: torch.Tensor
    temps: torch.Tensor
    topks: torch.Tensor
    topps: torch.Tensor
    out: torch.Tensor


def _step_pool_k(model, st: PoolState, generator, filtered: bool, k: int) -> None:
    """Advance every slot ``k`` tokens at its own position, clipped to the
    cache's end. A slot past its EOS or budget keeps decoding into its own
    rows: the host discards those tokens and the next insert replaces the
    rows. ``filtered``: apply the slots' top-k / top-p (a vocabulary sort);
    without it only temperature and greedy apply."""
    limit = model.config.max_seq_len - 1
    for i in range(k):
        logits, _ = model(st.tokens[:, None], cache=st.cache,
                          positions=st.positions.clamp(max=limit))
        nxt = sample_rows(logits[:, 0].float(), generator, st.temps,
                          st.topks if filtered else None, st.topps if filtered else None)
        st.out[i].copy_(nxt)
        st.tokens.copy_(nxt)
        st.positions.add_(1)


def _step_pool(model, st: PoolState, generator, filtered: bool) -> None:
    """One token for every slot (``_step_pool_k`` with k = 1)."""
    _step_pool_k(model, st, generator, filtered, 1)


class DecodePool:
    """Host-side scheduler around the per-row prefills and the pooled step.

    Usage:
        pool = DecodePool(model, rows=8, temperature=0.0)
        rid = pool.submit([5, 17, 20], max_new_tokens=16, eos_id=None)
        while pool.pending():
            for rid, output_ids in pool.tick():
                ...  # finished requests, prompt + continuation

    ``tick()`` fills free slots from the queue (one prefill each), runs one
    pooled step, and returns the requests that finished this tick.
    """

    @torch.no_grad()
    def __init__(
        self,
        model: FORDEDecoderLM,
        rows: int = 8,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        prefill_chunk: Optional[int] = None,
        decode_fuse: int = 1,
        cuda_graph: bool = True,
    ):
        """``prefill_chunk`` (dense configs): prefill prompts in chunks of
        this many tokens, one chunk per tick, so that a long prompt delays
        the other slots by one chunk a tick rather than its whole prefill;
        token for token the one-shot prefill's.

        ``decode_fuse``: advance the pool this many tokens per step call,
        one graph on the card. Slots are independent, so greedy tokens
        equal the unfused pool's; an admission waits at most k - 1 steps,
        tokens past a slot's EOS or budget are discarded, and streamed
        tokens arrive in bursts of up to k. While a chunked prefill is in
        flight the pool takes single steps.

        ``cuda_graph``: on the card, replay each step from a CUDA graph
        (False: eager, the control)."""
        self._nsa = bool(model.config.use_sparse_attention)
        if self._nsa and prefill_chunk is not None:
            raise ValueError(
                "chunked prefill requires dense-causal configs: the NSA prefill is one "
                "teacher-forced forward (nsa_prefill); chunk-resumable NSA caches do not exist"
            )
        self.model = model
        self.rows = rows
        self.device = model.token_embed.weight.device
        # pool-level defaults; submit() may override them per request
        self.default_sampling = (
            float(temperature),
            0 if top_k is None else int(top_k),
            1.0 if top_p is None else float(top_p),
        )
        if prefill_chunk is not None:
            prefill_chunk = max(1, min(prefill_chunk, model.config.max_seq_len))
        self.prefill_chunk = prefill_chunk
        self.decode_fuse = max(1, int(decode_fuse))
        self.cuda_graph = cuda_graph

        dev = self.device
        self.static = PoolState(
            cache=model.init_cache(rows, dev),
            tokens=torch.zeros(rows, dtype=torch.int64, device=dev),
            positions=torch.zeros(rows, dtype=torch.int64, device=dev),
            temps=torch.zeros(rows, device=dev),
            topks=torch.zeros(rows, dtype=torch.int64, device=dev),
            topps=torch.ones(rows, device=dev),
            out=torch.zeros(self.decode_fuse, rows, dtype=torch.int64, device=dev),
        )
        # host mirrors of the filter settings: tick picks the filtered graph
        self.topks = np.zeros((rows,), np.int64)
        self.topps = np.ones((rows,), np.float32)
        self.active = np.zeros((rows,), bool)
        self._filling = [None] * rows  # chunked-prefill state per slot
        self._slot_req = [None] * rows  # per-slot request record
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._graphs = {}  # (filtered, k) -> StepGraph
        self.queue: List[dict] = []
        self._next_id = 0
        self._prefixes: List[tuple] = []  # (cache, length) per prefix id
        self.last_step_rows = 0  # rows active in the most recent step

    # ------------------------------------------------------------------

    @torch.no_grad()
    def register_prefix(self, prefix_ids) -> int:
        """One forward over a shared prompt prefix (a system prompt);
        returns a prefix id for ``submit(prefix_id=...)``. Its requests
        prefill only their suffix, from a copy of this cache. Dense
        configs only (``prefill_prefix`` refuses NSA)."""
        prefix_ids = [int(t) for t in prefix_ids]
        if not prefix_ids:
            raise ValueError("empty prefix")
        cache = prefill_prefix(self.model, torch.tensor([prefix_ids], device=self.device))
        self._prefixes.append((cache, len(prefix_ids)))
        return len(self._prefixes) - 1

    def submit(
        self, prompt_ids, max_new_tokens, eos_id=None, prefix_id=None,
        on_token=None, temperature=None, top_k=None, top_p=None,
    ) -> int:
        """Queue a request; returns its id (reported back by tick()).

        ``prefix_id``: continue from a ``register_prefix`` cache; the
        output holds prompt + continuation only. ``on_token``: a callback
        ``f(request_id, token)`` for every generated token, once the tick's
        tokens reach the host. ``temperature``/``top_k``/``top_p``: this
        request's sampling (None: the pool's default)."""
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise ValueError("empty prompt")
        plen = self.prefix_len(prefix_id) if prefix_id is not None else 0
        limit = self.model.config.max_seq_len
        if plen + len(prompt_ids) + max_new_tokens > limit:
            raise ValueError(f"prefix {plen} + prompt {len(prompt_ids)} + {max_new_tokens} "
                             f"> max_seq_len {limit}")
        d_temp, d_topk, d_topp = self.default_sampling
        rid = self._next_id
        self._next_id += 1
        self.queue.append({
            "id": rid, "prompt": prompt_ids, "max_new": max_new_tokens,
            "eos": eos_id, "prefix": prefix_id, "cb": on_token,
            "sampling": (d_temp if temperature is None else float(temperature),
                         d_topk if top_k is None else int(top_k),
                         d_topp if top_p is None else float(top_p)),
            "submitted_ns": time.perf_counter_ns(),
        })
        spans.count("pool.submitted")
        return rid

    def cancel(self, request_id: int) -> bool:
        """Abandon a request: drop it from the queue, abort its chunked
        prefill, or free its slot now (the next insert replaces the slot's
        rows). Returns whether the request was found; a cancelled request
        is never reported by tick()."""
        for i, req in enumerate(self.queue):
            if req["id"] == request_id:
                del self.queue[i]
                return True
        for slot in range(self.rows):
            st = self._filling[slot]
            if st is not None and st["req"]["id"] == request_id:
                self._filling[slot] = None
                return True
            req = self._slot_req[slot]
            if req is not None and req["id"] == request_id:
                self._finish(slot)
                return True
        return False

    def prefix_len(self, prefix_id: int) -> int:
        if not 0 <= prefix_id < len(self._prefixes):
            raise IndexError(f"unknown prefix_id {prefix_id}")
        return self._prefixes[prefix_id][1]

    def pending(self) -> bool:
        return (
            bool(self.queue)
            or bool(self.active.any())
            or any(st is not None for st in self._filling)
        )

    def active_rows(self) -> int:
        return int(self.active.sum())

    # ------------------------------------------------------------------

    def _fill_slots(self):
        for slot in range(self.rows):
            if self.active[slot] or self._filling[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            spans.interval("pool.queue", req["submitted_ns"], time.perf_counter_ns(),
                           request=req["id"])
            spans.count("pool.admitted")
            prefix = self._prefixes[req["prefix"]] if req["prefix"] is not None else None
            plen = prefix[1] if prefix is not None else 0
            if self.prefill_chunk is not None:
                # chunked admission: one chunk per tick from here on
                cache = (tile_prefix_cache(prefix[0], 1) if prefix is not None
                         else _empty_row_cache(self.model))
                self._filling[slot] = {"req": req, "cache": cache, "done": 0, "plen": plen}
                continue
            with spans.span("pool.prefill", request=req["id"]):
                prompt = torch.tensor([req["prompt"]], device=self.device)
                if prefix is not None:
                    # unreachable for NSA pools: register_prefix refuses them
                    row_cache, token = _prefill_suffix(self.model, prefix[0], prompt,
                                                       self._gen, *req["sampling"])
                else:
                    prefill = _prefill_one_nsa if self._nsa else _prefill_one
                    row_cache, token = prefill(self.model, prompt, self._gen, *req["sampling"])
            self._activate_slot(slot, req, row_cache, token, plen)

    def _activate_slot(self, slot, req, row_cache, token, plen):
        """Prefill finished (one-shot or final chunk): copy the row into the
        pool and start decoding it."""
        p = req["prompt"]
        st = self.static
        with spans.span("pool.insert", request=req["id"]):
            _insert_row(st.cache, row_cache, slot)
            st.tokens[slot:slot + 1].copy_(token)
            st.positions[slot] = plen + len(p)
            self._set_sampling(slot, *req["sampling"])
            self.active[slot] = True
            first = int(token[0])  # the admission's one host read
        req["out"] = list(p) + [first]
        req["left"] = req["max_new"] - 1
        self._slot_req[slot] = req
        if req["cb"] is not None:
            req["cb"](req["id"], first)

    def _set_sampling(self, slot, temp, topk, topp):
        st = self.static
        self.topks[slot], self.topps[slot] = topk, topp
        st.temps[slot], st.topks[slot], st.topps[slot] = temp, topk, topp

    @torch.no_grad()
    def _advance_fills(self):
        """One prefill chunk per filling slot per tick."""
        c = self.prefill_chunk
        for slot in range(self.rows):
            st = self._filling[slot]
            if st is None:
                continue
            req = st["req"]
            p = req["prompt"]
            seg = p[st["done"]: st["done"] + c]
            last = _prefill_chunk(self.model, st["cache"], torch.tensor([seg], device=self.device))
            st["done"] += len(seg)
            if st["done"] >= len(p):
                self._filling[slot] = None
                token = _first_token(last, self._gen, *req["sampling"])
                self._activate_slot(slot, req, st["cache"], token, st["plen"])

    def _finish(self, slot):
        req = self._slot_req[slot]
        self.active[slot] = False
        self._slot_req[slot] = None
        # a parked slot's settings never force the filtered step on the others
        self._set_sampling(slot, 0.0, 0, 1.0)
        return req["id"], req["out"]

    def _step(self, filtered: bool, k: int) -> np.ndarray:
        """Run k pooled steps (a graph replay on the card); their tokens
        (k, rows), read to the host once."""
        st = self.static
        with spans.span("pool.step"):
            if not (self.cuda_graph and graphs.on_card(st.tokens)):
                _step_pool_k(self.model, st, self._gen, filtered, k)
            elif (filtered, k) in self._graphs:
                self._graphs[filtered, k].replay()
            else:
                # the warm-up of the capture is this call's step
                self._graphs[filtered, k] = graphs.StepGraph(
                    lambda: _step_pool_k(self.model, st, self._gen, filtered, k),
                    generators=(self._gen,))
            return st.out[:k].cpu().numpy()

    @torch.no_grad()
    def tick(self):
        """One scheduler round; returns [(request_id, output_ids), ...]
        finished this round."""
        finished = []
        self._fill_slots()
        if self.prefill_chunk is not None:
            self._advance_fills()
        # rows whose first (prefill-sampled) token already ends them
        for slot in range(self.rows):
            if not self.active[slot]:
                continue
            req = self._slot_req[slot]
            if req["left"] == 0 or req["out"][-1] == req["eos"]:
                finished.append(self._finish(slot))
        if not self.active.any():
            return finished

        self.last_step_rows = int(self.active.sum())
        # the unfiltered step skips the vocabulary sort; take it whenever no
        # slot asked for top-k / top-p
        filtered = bool(((self.topks > 0) | (self.topps < 1.0)).any())
        # Fuse unless a chunked prefill is in flight (chunks advance one per
        # tick). A queued request does not stop fusing: _fill_slots took a
        # free slot for each, so a queue means every slot is busy.
        fuse = self.decode_fuse
        if fuse > 1 and any(st is not None for st in self._filling):
            fuse = 1
        toks = self._step(filtered, fuse)
        spans.count("pool.steps", fuse)
        spans.count("pool.rows_stepped", self.last_step_rows * fuse)
        for slot in range(self.rows):
            if not self.active[slot]:
                continue
            req = self._slot_req[slot]
            for j in range(fuse):
                tok = int(toks[j, slot])
                req["out"].append(tok)
                req["left"] -= 1
                if req["cb"] is not None:
                    req["cb"](req["id"], tok)
                if req["left"] == 0 or tok == req["eos"]:
                    # the step's surplus tokens for this slot are discarded
                    finished.append(self._finish(slot))
                    break
        return finished
