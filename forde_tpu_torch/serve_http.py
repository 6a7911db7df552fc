"""HTTP serving daemon for the decoder LM (port of forde_tpu/serve_http.py),
on the standard library's ``http.server``:

  python -m forde_tpu_torch.serve_http --checkpoint_dir ckpt --port 8000
  python -m forde_tpu_torch.serve_http --checkpoint_dir ckpt --continuous --decode_fuse 4

  POST /generate   {"prompt_ids": [1,2,3], "max_new_tokens": 16}
                -> {"output_ids": [...], "prompt_len": 3, "batch_rows": 4}
  POST /prefix     {"prefix_ids": [...]} -> {"prefix_id": 0, "prefix_len": 3}
  GET  /healthz -> {"status": "ok", ...model and config summary...}
  GET  /stats   -> request, batch and token counters

Requests land in a queue and ONE worker thread drains it. It does all of
the device work: every prefill, decode step and graph capture, and the
prefill of a prefix that ``POST /prefix`` hands it, so that no CUDA call
of a second thread meets a graph capture.

Batch mode (the default, ``Batcher``): the worker takes the first request,
waits up to ``--batch_window_ms`` for more (at most ``--max_batch`` rows)
and decodes them as one ragged batch (``models/generate.generate_ragged``).
The row count rounds up to a power of two (pad rows repeat row 0 and are
dropped), so at most log2(max_batch) + 1 decode graphs are kept on the
model, each with its own copy of the decode state; prompts are padded to
the batch's longest, not to a power of two, since no compile is bounded
by it. Sampling comes from the server's flags; per-request
``max_new_tokens`` (<= ``--max_new_tokens``) trims the server maximum.

``--continuous``: continuous batching over ``models/decode_pool.DecodePool``
(dense and NSA configs; ``--max_batch`` is the pool's rows). Requests may
carry their own ``temperature``/``top_k``/``top_p`` and ``max_new_tokens``
(which bounds the decode work), ``"stream": true`` answers with
server-sent events (one ``data: {"token": t}`` per token as the pool emits
it, then ``data: {"output_ids": [...], "done": true}``), an SSE client that
disconnects has its slot freed on the next tick, and ``POST /prefix``
registers a shared prefix at run time (dense configs) that later bodies
name by ``prefix_id``. Each admission is a one-row prefill, run between
two pooled steps, that stalls every running row: until admissions are
batched, this mode trades throughput and time to first token against
batch mode for streaming, cancellation and per-request sampling.

``--prefix_ids`` (dense configs) is a server-level system prefix,
prefilled once at startup and continued by every request, in both modes.

Runs on CUDA unless ``--device cpu``; with no GPU visible it raises. It
refuses what ``serve`` refuses (``serve._NOT_PORTED``), and beam search
and speculative decoding, as the reference does.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from forde_tpu_torch import resolve_device
from forde_tpu_torch.serve import _parse_ids, _refuse_unported, build_parser, load_serving_model


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _server_prefix(model, args, device):
    """--prefix_ids as a server-level system prompt, prefilled once
    (``generate.prefill_prefix``): (prefix cache or None, its length)."""
    if not args.prefix_ids:
        return None, 0
    from forde_tpu_torch.models.generate import prefill_prefix

    prefix = _parse_ids(args.prefix_ids)
    cache = prefill_prefix(model, torch.tensor([prefix], device=device))
    print(f"[serve_http] system prefix prefilled once ({len(prefix)} tokens)")
    return cache, len(prefix)


@dataclass
class _Pending:
    prompt: list
    max_new: int
    done: threading.Event = field(default_factory=threading.Event)
    output: Optional[list] = None
    error: Optional[str] = None
    batch_rows: int = 0
    # SSE streaming (continuous mode): tokens land here as they are
    # sampled; None is the end-of-stream sentinel
    stream: Optional["queue.Queue"] = None
    # per-request sampling (continuous mode; None = the server's flag)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # per-request prefix (continuous mode): an id from POST /prefix;
    # None = the server-level --prefix_ids prefix, if any
    prefix_id: Optional[int] = None
    # cancellation (continuous mode): set when the client disconnects
    rid: Optional[int] = None  # the pool's request id once admitted
    cancelled: bool = False


@dataclass
class _Job:
    """Device work another thread hands the worker (POST /prefix)."""

    fn: Callable[[], object]
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None


class Batcher:
    """Queue + one decode worker. ``submit`` blocks the (per-request
    handler) thread until its row is decoded."""

    def __init__(self, config, model, args, device):
        self.config = config
        self.model = model
        self.args = args
        self.device = device
        self.prefix_cache, self.prefix_len = _server_prefix(model, args, device)
        self._gen = torch.Generator(device=device).manual_seed(args.seed)
        self.queue: "queue.Queue[_Pending]" = queue.Queue()
        self.stats = {
            "requests": 0,
            "batches": 0,
            "rows_decoded": 0,
            "rows_padding": 0,
            "tokens_generated": 0,
            "max_batch_rows": 0,
        }
        self._lock = threading.Lock()
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, prompt: list, max_new: int) -> _Pending:
        req = _Pending(prompt=prompt, max_new=max_new)
        with self._lock:
            self.stats["requests"] += 1
        self.queue.put(req)
        req.done.wait()
        return req

    def stop(self):
        self._running = False
        self._worker.join(timeout=5)

    # ------------------------------------------------------------------

    def _run(self):
        window = self.args.batch_window_ms / 1000.0
        while self._running:
            try:
                first = self.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + window
            while len(batch) < self.args.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._decode(batch)
            except Exception as e:  # report it to the batch's clients, keep serving
                traceback.print_exc()
                for req in batch:
                    req.error = f"{type(e).__name__}: {e}"
            for req in batch:
                req.done.set()

    def _decode(self, batch):
        with self._lock:
            self.stats["batches"] += 1
            self.stats["rows_decoded"] += len(batch)
            self.stats["max_batch_rows"] = max(self.stats["max_batch_rows"], len(batch))
        self._decode_ragged(batch)
        with self._lock:
            self.stats["tokens_generated"] += sum(
                len(r.output) - len(r.prompt) for r in batch if r.output is not None
            )

    def _decode_ragged(self, batch):
        from forde_tpu_torch.models.generate import generate_ragged

        args = self.args
        lens = [len(r.prompt) for r in batch]
        rows = _next_pow2(len(batch))
        with self._lock:
            self.stats["rows_padding"] += rows - len(batch)
        padded = np.full((rows, max(lens)), args.pad_id, np.int64)
        all_lens = np.full((rows,), lens[0], np.int64)
        for i, r in enumerate(batch):
            padded[i, : len(r.prompt)] = r.prompt
            all_lens[i] = len(r.prompt)
        padded[len(batch):, : lens[0]] = batch[0].prompt
        out = generate_ragged(
            self.model, torch.from_numpy(padded).to(self.device),
            torch.from_numpy(all_lens).to(self.device), self._gen,
            max_new_tokens=args.max_new_tokens, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id, pad_id=args.pad_id,
            prefix_cache=self.prefix_cache,
        ).cpu().numpy()
        for i, r in enumerate(batch):
            r.output = out[i, : len(r.prompt) + r.max_new].tolist()
            r.batch_rows = rows


class ContinuousBatcher:
    """Batcher's submit() contract, token by token: a request joins the
    decode pool (``models/decode_pool.DecodePool``) as soon as a slot is
    free, and leaves it when it ends. ``--max_batch`` is the pool's rows."""

    def __init__(self, config, model, args, device):
        self.config = config
        self.model = model
        self.args = args
        self.device = device
        self.pool = self._new_pool()
        self._prefix_id, self.prefix_len = None, 0
        if args.prefix_ids:
            prefix = _parse_ids(args.prefix_ids)
            self._prefix_id = self.pool.register_prefix(prefix)
            self.prefix_len = len(prefix)
            print(f"[serve_http] system prefix registered with the pool "
                  f"({self.prefix_len} tokens)")
        self.queue: "queue.Queue" = queue.Queue()  # _Pending or _Job
        self._cancel_q: "queue.Queue[_Pending]" = queue.Queue()
        self._inflight = {}
        self.stats = {
            "requests": 0,
            "ticks": 0,
            "max_active_rows": 0,
            "tokens_generated": 0,
        }
        self._lock = threading.Lock()
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _new_pool(self):
        from forde_tpu_torch.models.decode_pool import DecodePool

        a = self.args
        return DecodePool(self.model, rows=a.max_batch, temperature=a.temperature,
                          top_k=a.top_k, top_p=a.top_p, seed=a.seed,
                          prefill_chunk=a.prefill_chunk, decode_fuse=a.decode_fuse)

    def submit(self, prompt: list, max_new: int, **sampling) -> _Pending:
        req = _Pending(prompt=prompt, max_new=max_new, **sampling)
        with self._lock:
            self.stats["requests"] += 1
        self.queue.put(req)
        req.done.wait()
        return req

    def submit_stream(self, prompt: list, max_new: int, **sampling) -> _Pending:
        """Non-blocking submit for SSE: tokens arrive on ``req.stream`` as
        they are sampled (None = end of stream; ``req.output`` /
        ``req.error`` are final once it lands)."""
        req = _Pending(prompt=prompt, max_new=max_new, stream=queue.Queue(), **sampling)
        with self._lock:
            self.stats["requests"] += 1
        self.queue.put(req)
        return req

    def stop(self):
        self._running = False
        self._worker.join(timeout=5)

    def register_prefix(self, prefix_ids: list) -> tuple:
        """Runtime prefix registration (POST /prefix): the worker runs its
        prefill; this thread waits. Returns (prefix_id, prefix_len)."""
        job = _Job(lambda: self.pool.register_prefix(prefix_ids))
        self.queue.put(job)
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result, len(prefix_ids)

    def prefix_len_for(self, prefix_id: Optional[int]) -> int:
        if prefix_id is None:
            return self.prefix_len
        return self.pool.prefix_len(prefix_id)

    def cancel(self, req: _Pending):
        """The client went away: the worker, the only thread that changes
        the pool, cancels the request."""
        self._cancel_q.put(req)

    def _admit(self, item):
        if isinstance(item, _Job):
            try:
                item.result = item.fn()
            except Exception as e:  # handed back to the thread that asked
                item.error = e
            item.done.set()
            return
        req = item
        if req.cancelled:
            req.done.set()
            return
        on_token = None
        if req.stream is not None:
            on_token = lambda rid, tok, q=req.stream: q.put(tok)  # noqa: E731
        rid = self.pool.submit(
            req.prompt, req.max_new, eos_id=self.args.eos_id,
            prefix_id=req.prefix_id if req.prefix_id is not None else self._prefix_id,
            on_token=on_token,
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
        )
        req.rid = rid
        self._inflight[rid] = req

    def _drain_cancels(self):
        while True:
            try:
                req = self._cancel_q.get_nowait()
            except queue.Empty:
                return
            req.cancelled = True  # _admit skips it if it is still queued
            if req.rid is not None and req.rid in self._inflight:
                self.pool.cancel(req.rid)
                self._inflight.pop(req.rid)
                if req.stream is not None:
                    req.stream.put(None)
                req.done.set()

    def _serve_once(self):
        self._drain_cancels()
        if not self.pool.pending():
            try:
                self._admit(self.queue.get(timeout=0.2))
            except queue.Empty:
                pass
            return
        while True:
            try:
                self._admit(self.queue.get_nowait())
            except queue.Empty:
                break
        done = self.pool.tick()
        with self._lock:
            self.stats["ticks"] += 1
            self.stats["max_active_rows"] = max(self.stats["max_active_rows"],
                                                self.pool.last_step_rows)
        for rid, out in done:
            req = self._inflight.pop(rid)
            req.output = out
            req.batch_rows = self.pool.rows
            with self._lock:
                self.stats["tokens_generated"] += len(out) - len(req.prompt)
            if req.stream is not None:
                req.stream.put(None)  # end-of-stream sentinel
            req.done.set()

    def _run(self):
        # grad mode is per thread; every device call of the server runs here
        with torch.no_grad():
            while self._running:
                try:
                    self._serve_once()
                except Exception as e:  # fail the requests in flight, keep serving
                    traceback.print_exc()
                    err = f"{type(e).__name__}: {e}"
                    for req in self._inflight.values():
                        req.error = err
                        if req.stream is not None:
                            req.stream.put(None)
                        req.done.set()
                    self._inflight.clear()
                    self.pool = self._new_pool()
                    if self._prefix_id is not None:
                        self._prefix_id = self.pool.register_prefix(
                            _parse_ids(self.args.prefix_ids))


class _Handler(BaseHTTPRequestHandler):
    batcher = None  # set by make_server
    quiet: bool = True

    def log_message(self, fmt, *a):  # the stdlib default writes every request to stderr
        if not self.quiet:
            super().log_message(fmt, *a)

    def _send(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def do_GET(self):
        b = self.batcher
        if self.path == "/healthz":
            cfg = b.config
            self._send(200, {
                "status": "ok",
                "d_model": cfg.d_model,
                "num_layers": cfg.num_layers,
                "nsa": cfg.use_sparse_attention,
                "max_seq_len": cfg.max_seq_len,
                "max_new_tokens": b.args.max_new_tokens,
                "system_prefix_len": b.prefix_len,
            })
        elif self.path == "/stats":
            with b._lock:
                stats = dict(b.stats)
            self._send(200, stats)
        else:
            self._send(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path == "/prefix":
            self._register_prefix()
            return
        if self.path != "/generate":
            self._send(404, {"error": "unknown path"})
            return
        b = self.batcher
        continuous = isinstance(b, ContinuousBatcher)
        try:
            req = self._body()
            prompt = req.get("prompt_ids")
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int) and t >= 0 for t in prompt)):
                raise ValueError("prompt_ids must be a non-empty list of non-negative ints")
            max_new = int(req.get("max_new_tokens", b.args.max_new_tokens))
            if not 1 <= max_new <= b.args.max_new_tokens:
                raise ValueError(f"max_new_tokens must be in [1, {b.args.max_new_tokens}] "
                                 "(the server's maximum)")
            prefix_id = req.get("prefix_id")
            if prefix_id is not None:
                if not continuous:
                    raise ValueError("prefix_id requires --continuous")
                prefix_id = int(prefix_id)
                try:
                    plen = b.prefix_len_for(prefix_id)
                except IndexError:
                    raise ValueError(f"unknown prefix_id {prefix_id} (register via POST /prefix)")
            else:
                plen = b.prefix_len
            limit = b.config.max_seq_len - b.args.max_new_tokens - plen
            if len(prompt) > limit:
                raise ValueError(f"prompt length {len(prompt)} > {limit} "
                                 "(max_seq_len - server max_new_tokens - prefix)")
            stream = bool(req.get("stream", False))
            if stream and not continuous:
                raise ValueError("streaming requires the server to run with --continuous "
                                 "(token-granular decoding)")
            sampling = {}
            for name, cast in (("temperature", float), ("top_k", int), ("top_p", float)):
                if req.get(name) is not None:
                    sampling[name] = cast(req[name])
            if sampling and not continuous:
                raise ValueError("per-request sampling parameters require --continuous "
                                 "(batch mode samples with the server's flags)")
            if sampling.get("top_p") is not None and not 0.0 < sampling["top_p"] <= 1.0:
                raise ValueError("top_p must be in (0, 1]")
            if sampling.get("temperature", 1.0) < 0:
                raise ValueError("temperature must be >= 0")
            if sampling.get("top_k", 0) < 0:
                raise ValueError("top_k must be >= 0")
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        if prefix_id is not None:
            sampling["prefix_id"] = prefix_id
        if stream:
            self._stream(b, prompt, max_new, sampling)
            return
        res = b.submit(prompt, max_new, **sampling)
        if res.error is not None:
            self._send(500, {"error": res.error})
        else:
            self._send(200, {
                "output_ids": res.output,
                "prompt_len": len(prompt),
                "batch_rows": res.batch_rows,
            })

    def _stream(self, b, prompt, max_new, sampling):
        """Server-sent events: one ``data: {"token": t}`` event per token,
        then ``data: {"output_ids": ..., "done": true}``."""
        res = b.submit_stream(prompt, max_new, **sampling)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            while True:
                tok = res.stream.get()
                if tok is None:
                    break
                self.wfile.write(f"data: {json.dumps({'token': tok})}\n\n".encode())
                self.wfile.flush()
            res.done.wait()
            if res.error is not None:
                final = {"error": res.error, "done": True}
            else:
                final = {"output_ids": res.output, "prompt_len": len(prompt), "done": True}
            self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # the client went away mid-stream: free its slot rather than
            # finish a row nobody reads
            b.cancel(res)

    def _register_prefix(self):
        """POST /prefix {"prefix_ids": [...]} -> {"prefix_id", "prefix_len"}
        (continuous mode, dense configs): one prefill now; later /generate
        bodies pass ``prefix_id``."""
        b = self.batcher
        try:
            req = self._body()
            prefix = req.get("prefix_ids")
            if (not isinstance(prefix, list) or not prefix
                    or not all(isinstance(t, int) and t >= 0 for t in prefix)):
                raise ValueError("prefix_ids must be a non-empty list of non-negative ints")
            if not isinstance(b, ContinuousBatcher):
                raise ValueError("prefix registration requires --continuous")
            limit = b.config.max_seq_len - b.args.max_new_tokens - 1
            if len(prefix) > limit:
                raise ValueError(f"prefix length {len(prefix)} > {limit}")
            pid, plen = b.register_prefix(prefix)  # NSA: prefill_prefix's ValueError
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        self._send(200, {"prefix_id": pid, "prefix_len": plen})


def add_server_args(p):
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (printed at startup)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--max_batch", type=int, default=32,
                   help="most requests decoded together (continuous: the pool's rows)")
    p.add_argument("--batch_window_ms", type=float, default=30.0,
                   help="after the first queued request, wait this long for more before "
                        "decoding (batch mode)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: requests join and leave the decode pool token "
                        "by token (--max_batch = pool rows; dense and NSA configs). Each "
                        "admission is a one-row prefill that stalls the running rows, so "
                        "until admissions are batched this mode trades throughput and "
                        "time to first token for streaming, cancellation and per-request "
                        "sampling")
    p.add_argument("--prefill_chunk", type=int, default=None,
                   help="continuous mode, dense configs: prefill prompts in chunks of this "
                        "many tokens, one per tick (token-exact)")
    p.add_argument("--decode_fuse", type=int, default=1,
                   help="continuous mode: decode k tokens per step call (one CUDA graph); "
                        "admission waits at most k-1 steps and streamed tokens arrive in "
                        "bursts of up to k")
    return p


def make_server(args):
    """(ThreadingHTTPServer, batcher) without serving: the test entry;
    ``main`` wraps it with serve_forever."""
    _refuse_unported(args)
    device = resolve_device(args.device)
    if args.beam_size > 1 or args.draft_checkpoint_dir:
        raise SystemExit("serve_http composes with greedy/sampled cached decode only")
    config, model = load_serving_model(args, device)
    if args.prefix_ids and config.use_sparse_attention:
        raise SystemExit("--prefix_ids requires a dense-causal config (NSA caches depend on "
                         "what follows the prefix)")
    if args.continuous:
        if config.use_sparse_attention and args.prefill_chunk:
            raise SystemExit("--prefill_chunk requires a dense-causal config (the NSA prefill "
                             "is one teacher-forced forward)")
        batcher = ContinuousBatcher(config, model, args, device)
    else:
        batcher = Batcher(config, model, args, device)
    handler = type("Handler", (_Handler,), {"batcher": batcher})
    server = ThreadingHTTPServer((args.host, args.port), handler)
    return server, batcher


def main(argv: Optional[list] = None) -> None:
    args = add_server_args(build_parser()).parse_args(argv)
    server, batcher = make_server(args)
    host, port = server.server_address[:2]
    print(f"[serve_http] serving on http://{host}:{port} (max_batch={args.max_batch}, "
          f"window={args.batch_window_ms}ms, max_new_tokens={args.max_new_tokens}, "
          f"{'continuous' if args.continuous else 'batch'})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.stop()
        server.server_close()


if __name__ == "__main__":
    main()
