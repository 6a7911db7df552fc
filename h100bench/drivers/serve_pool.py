"""Serving of the decoder LM: an open loop of arrivals into
``models.decode_pool.DecodePool`` (``submit``/``tick``), greedy decoding
and no EOS, so that every budget is its request's exact output length.

Set-up builds the model with the harness's weights and the pool, and
warms it with a few requests of the mix's lengths (the prefill's kernels,
the pooled step's CUDA graph). The window offers ``generate.requests`` at
their scheduled arrivals for ``--seconds``, then waits up to ``drain_s``
for the last of them. Output tokens/s is every output token over the time
from the first arrival to the last completion. A request's TTFT runs from
its scheduled arrival to its first token on the host, queueing included;
its TPOT is (last token - first token) / (n - 1); a request that does not
finish counts in ``failed`` and misses both tails.

A traced run then offers the mix again, from an emptied pool, for
``trace_seconds`` under the profiler; the device metrics read that phase,
the host metrics the window.

Once the window has closed, the peak memory read and the pool freed, the
reference runs over a sample drawn from the seed of the finished requests,
the longest among them: its logits at every served position of the
prompt plus the served tokens, and the widest gap by which a served token
lies below the reference's best.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from h100bench import compare, generate
from h100bench.common import Outcome, RunContext, memory_peak, release, sync, tail
from h100bench.counts import lm as lm_counts
from h100bench.counts.peaks import OPS_PER_S
from h100bench.drivers.lm_train import build_model
from h100bench.reference import fp32
from h100bench.reference import lm as ref_lm
from h100bench.trace import DeviceTrace
from h100bench import weights


class Served:
    """What the host saw of one request."""

    def __init__(self, req: generate.Request, due: float):
        self.req, self.due = req, due
        self.submitted = self.first = self.last = None
        self.tokens: List[int] = []
        self.done: Optional[float] = None


def make_pool(ctx: RunContext, model):
    from forde_tpu_torch.models.decode_pool import DecodePool

    pool = DecodePool(model, rows=ctx.traffic["rows"], temperature=0.0,
                      seed=ctx.seed % 2 ** 63)
    if "unchanged" in ctx.faults:  # a step that leaves the pool's state as it was
        step = pool._step
        last = {}

        def stale(filtered, k):
            if "out" not in last:
                last["out"] = step(filtered, k)
            return last["out"]

        pool._step = stale
    if "token_altered" in ctx.faults:  # one token changed where the step returns it
        step = pool._step
        calls = {"n": 0}

        def altered(filtered, k):
            out = step(filtered, k).copy()
            calls["n"] += 1
            if calls["n"] % 7 == 3:
                out[0, :] = (out[0, :] + 1) % ctx.config["vocab_size"]
            return out

        pool._step = altered
    return pool


def warm(ctx: RunContext, pool) -> None:
    """Admit and finish a few requests of the mix's lengths: the prefills'
    libraries and the pooled step's graph are ready before the window."""
    mix = ctx.traffic
    reqs = generate.requests(dict(mix, rate_per_s=1.0), ctx.seed + 1, mix["warmup_requests"],
                             ctx.config["vocab_size"])
    for r in reqs:
        pool.submit(r.prompt, max_new_tokens=2)
    while pool.pending():
        pool.tick()
    sync(ctx.device)


def serve(ctx: RunContext, pool, reqs: List[generate.Request],
          trace: Optional[DeviceTrace] = None):
    """The open loop, until every request is served or ``drain_s`` after
    the window; with ``trace``, under the profiler for the mix's
    ``trace_seconds`` and no longer. Returns (served requests, per-tick
    records, loop start, decode flops of untraced steps)."""
    cfg, mix, spans = ctx.config, ctx.traffic, ctx.spans
    served: Dict[int, Served] = {}
    ticks = []  # (seconds, admitted, traced)
    flops = {"decode": 0.0}

    def on_token(rid, token):
        s = served[rid]
        now = time.perf_counter()
        if s.first is None:
            s.first = now
        else:
            pos = len(s.req.prompt) + len(s.tokens) - 1  # the decoded token's input position
            if not spans.annotate:
                flops["decode"] += lm_counts.decode_token_flops(cfg, pos)
        s.last = now
        s.tokens.append(int(token))

    fill, step = pool._fill_slots, pool._step
    admitted = {"n": 0}

    def fill_spanned():
        before = len(pool.queue)
        with spans.span("pool.admit"):
            fill()
        admitted["n"] += before - len(pool.queue)

    def step_spanned(filtered, k):
        with spans.span("pool.step"):
            return step(filtered, k)

    pool._fill_slots, pool._step = fill_spanned, step_spanned
    t0 = time.perf_counter()
    if trace is not None:
        trace.start()
    i, n = 0, len(reqs)
    while True:
        now = time.perf_counter()
        if trace is not None and now - t0 >= mix["trace_seconds"]:
            break
        while i < n and t0 + reqs[i].arrival <= now:
            r = reqs[i]
            rid = pool.submit(r.prompt, max_new_tokens=r.max_new, on_token=on_token)
            served[rid] = Served(r, t0 + r.arrival)
            served[rid].submitted = now
            i += 1
        if pool.pending():
            admitted["n"] = 0
            traced = spans.annotate
            with spans.span("pool.tick"):
                finished = pool.tick()
            ticks.append((spans.records[-1][2] - spans.records[-1][1], admitted["n"], traced))
            done = time.perf_counter()
            for rid, _ in finished:
                served[rid].done = done
        elif i < n:
            time.sleep(max(0.0, t0 + reqs[i].arrival - time.perf_counter()))
        else:
            break
        if now - t0 > ctx.seconds + mix["drain_s"]:
            break
    if trace is not None:
        trace.stop()
    pool._fill_slots, pool._step = fill, step
    return list(served.values()), ticks, t0, flops["decode"]


def reference_gaps(ctx: RunContext, sample: List[Served], precision: Optional[str] = None):
    """The widest gap of the served tokens under the fp32 reference, and,
    with ``precision``, the widest gap of the token that the reference in
    that precision puts first at the same positions (the control)."""
    cfg = ctx.config
    with fp32(), torch.no_grad():
        params = weights.make(weights.lm_specs(cfg), ctx.seed, ctx.device)
        gaps, control = [], []
        for s in sample:
            p = len(s.req.prompt)
            ids = torch.tensor([s.req.prompt + s.tokens[:-1]], device=ctx.device)
            logits, _, _ = ref_lm.forward(params, cfg, ids, prompt_len=p)
            logits = logits[0, p - 1:]
            gaps.append(compare.logit_gap(logits, torch.tensor(s.tokens, device=ctx.device)))
            if precision is not None:
                low, _, _ = ref_lm.forward(params, cfg, ids, prompt_len=p, prec=precision)
                control.append(compare.logit_gap(logits, low[0, p - 1:].argmax(-1)))
        return max(gaps), (max(control) if control else None)


def check_sample(ctx: RunContext, served: List[Served]) -> List[Served]:
    """The longest finished request and others drawn from the seed, up to
    ``check_tokens`` served tokens."""
    done = [s for s in served if s.done is not None]
    if not done:
        return []
    longest = max(done, key=lambda s: len(s.tokens))
    rng = np.random.default_rng(int(ctx.seed) + 2)
    sample, total = [longest], len(longest.tokens)
    for j in rng.permutation(len(done)):
        if total >= ctx.traffic["check_tokens"]:
            break
        if done[j] is not longest:
            sample.append(done[j])
            total += len(done[j].tokens)
    return sample


def setup(ctx: RunContext):
    model = build_model(ctx.config, ctx.seed, ctx.device)
    model.eval()
    pool = make_pool(ctx, model)
    warm(ctx, pool)
    return model, pool


def run(ctx: RunContext, started: float) -> Outcome:
    from forde_tpu_torch import kernels

    cfg, mix, dev, spans = ctx.config, ctx.traffic, ctx.device, ctx.spans
    model, pool = setup(ctx)
    reqs = generate.requests(mix, ctx.seed, ctx.seconds, cfg["vocab_size"])
    setup_s = time.perf_counter() - started
    kernels.reset_launches()
    served, ticks, t0, decode_flops = serve(ctx, pool, reqs)
    trace = None
    if ctx.trace:  # a traced phase once the window is served: the mix again, under the profiler
        trace = DeviceTrace(spans, dev)
        serve(ctx, pool, generate.requests(mix, ctx.seed + 1, mix["trace_seconds"],
                                           cfg["vocab_size"]), trace)
    peak = memory_peak(dev)
    launches = sum(kernels.launches.values())
    end = t0 + ctx.seconds
    backlog = sum(1 for s in served if s.due <= end and (s.first is None or s.first > end))
    del pool, model
    release(dev)

    finished = [s for s in served if s.done is not None]
    failed = len(served) - len(finished)
    ttft = [s.first - s.due for s in finished]
    tpot = [(s.last - s.first) / (len(s.tokens) - 1) for s in finished if len(s.tokens) > 1]
    out_tokens = sum(len(s.tokens) for s in finished)
    span_s = max(s.done for s in finished) - t0 if finished else float("nan")
    late = [s.submitted - s.due for s in served]
    sample = check_sample(ctx, served)
    gap, _ = reference_gaps(ctx, sample) if sample else (float("inf"), None)
    checks = compare.checks({"logit_gap": gap}, ctx.limits)
    ctx.say(f"requests {len(served)} finished {len(finished)}; backlog at the window's end "
            f"{backlog}; output tokens {out_tokens} over {span_s:.3f} s; ticks {len(ticks)}; "
            f"hand-kernel launches {launches}")
    ctx.say(f"generator lateness: mean {np.mean(late) * 1e3:.3f} ms, max {max(late) * 1e3:.3f} ms")
    ctx.say(f"TTFT p50 {tail(ttft, 0.5):.4f} s; TPOT p50 {tail(tpot, 0.5) * 1e3:.3f} ms; "
            f"checked {len(sample)} requests, {sum(len(s.tokens) for s in sample)} tokens")
    ctx.say(f"peak {peak / 2 ** 30:.2f} GiB; set-up {setup_s:.2f} s")
    untraced = [(d, a) for d, a, traced in ticks if not traced]
    idle_ticks = [d for d, a in untraced if a == 0]
    admit = spans.durations("pool.admit")
    n_admit = sum(a for _, a in untraced)
    facts = {
        "decode_step_ms": 1e3 * float(np.mean(idle_ticks)) if idle_ticks else None,
        "admit_ms": 1e3 * sum(admit) / n_admit if n_admit else None,
        "decode_flops": decode_flops,
        "decode_step_s": sum(spans.durations("pool.step")),
        "peak_ops_per_s": OPS_PER_S[cfg["dtype"]],
        "decode_least_s_per_step": lm_counts.decode_kernel_seconds(cfg, mix["rows"]),
        "traced_steps": sum(1 for r in spans.records if r[0] == "pool.step" and r[3]),
    }
    metrics = {
        "serve_ttft_p95_s": tail(ttft, 0.95),
        "serve_tpot_p95_ms": tail(tpot, 0.95) * 1e3,
        "serve_output_tokens_per_s": out_tokens / span_s,
        "setup_s": setup_s,
    }
    return Outcome(attempted=len(served), failed=failed, metrics=metrics, checks=checks,
                   memory_peak_bytes=peak, spans=spans,
                   facts={k: v for k, v in facts.items() if v is not None},
                   device=trace.summary() if trace is not None else None)


def served_sample(ctx: RunContext) -> List[Served]:
    """A short window at the cell's load, long enough to finish the mix's
    longest requests, and its checked sample."""
    model, pool = setup(ctx)
    reqs = generate.requests(ctx.traffic, ctx.seed, ctx.traffic["calibrate_seconds"],
                             ctx.config["vocab_size"])
    served, _, _, _ = serve(ctx, pool, reqs, None)
    del pool, model
    release(ctx.device)
    return check_sample(ctx, served)


def calibrate(ctx: RunContext, controls, faults):
    """(side, numbers) of the program, each control and each fault."""
    sample = served_sample(ctx)
    gap, _ = reference_gaps(ctx, sample)
    yield "program", {"logit_gap": gap, "tokens": sum(len(s.tokens) for s in sample)}
    for control in controls:
        _, low = reference_gaps(ctx, sample, control)
        yield f"control_{control}", {"logit_gap": low}
    for fault in faults:
        fctx = dataclasses.replace(ctx, faults={fault}, spans=type(ctx.spans)())
        gap, _ = reference_gaps(fctx, served_sample(fctx))
        yield f"fault_{fault}", {"logit_gap": gap}


def sweep(ctx: RunContext, rates, seconds: float):
    """Offered load against the pool at each rate, one set-up: the backlog
    at the window's end and both tails (finding the knee)."""
    model, pool = setup(ctx)
    for rate in rates:
        mix = dict(ctx.traffic, rate_per_s=rate)
        reqs = generate.requests(mix, ctx.seed, seconds, ctx.config["vocab_size"])
        rctx = dataclasses.replace(ctx, traffic=mix, seconds=seconds, spans=type(ctx.spans)())
        served, ticks, t0, _ = serve(rctx, pool, reqs, None)
        end = t0 + seconds
        finished = [s for s in served if s.done is not None]
        yield {
            "rate_per_s": rate, "requests": len(reqs), "finished": len(finished),
            "backlog": sum(1 for s in served if s.due <= end and (s.first is None or s.first > end)),
            "in_flight_or_queued": sum(1 for s in served if s.due <= end
                                       and (s.done is None or s.done > end)),
            "ttft_p95_s": tail([s.first - s.due for s in finished], 0.95),
            "tpot_p95_ms": 1e3 * tail([(s.last - s.first) / (len(s.tokens) - 1)
                                       for s in finished if len(s.tokens) > 1], 0.95),
            "output_tokens_per_s": sum(len(s.tokens) for s in finished)
            / (max(s.done for s in finished) - t0),
        }
    del pool, model
    release(ctx.device)
