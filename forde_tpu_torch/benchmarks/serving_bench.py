"""Serving throughput on one card: sequential vs ragged batch vs
continuous pool (port of benchmarks/serving_bench.py).

Drives the port's decode engines directly (no HTTP) on the reference's
synthetic mixed workload: R requests whose prompt lengths and token
budgets are drawn from power-of-two grids by ``np.random.RandomState(
seed)``, as the reference draws them. One JSON line per mode:

  sequential  - ``generate_cached`` per request, one at a time
  ragged      - one ``generate_ragged`` call over the whole closed batch
                (everyone pays the longest budget)
  continuous  - ``DecodePool`` with every request queued up front: slots
                refill the moment a row finishes
  prefix      - the same pool workload where every request shares a
                ``--prefix_len`` system prompt, without and with prefix
                caching (``register_prefix``); dense-causal only
  load        - ``--load_rate`` > 0: an open-loop Poisson arrival process
                (``np.random.RandomState(seed + 7)``) against the pool and
                against dynamic closed batches, with TTFT and TPOT p50/p99

On the card the decode steps replay CUDA graphs (the engines' default), and
the untimed warm-up pass captures them, as the reference's compiles its
programs. Every timed section ends in ``torch.cuda.synchronize()``.

Substitutions: ``scan_layers`` is a checkpoint layout in the port, not a
loop; the model's weights come from a ``torch.Generator`` seeded 0, not
JAX's key; the greedy engines take no random key.

The last line is ONE JSON object: ``serving_out_tok_per_s_continuous_pool``
(the ``out_tok_per_s`` of the ``continuous_pool`` line), with every other
mode's line, the peak GiB, the kernel launches of each mode's timed
section and the card in ``extra``.

    python3 -m forde_tpu_torch.benchmarks.serving_bench [--requests 32]
        [--rows 8] [--d_model 256] [--num_layers 4] [--bf16] [--nsa] ...
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from forde_tpu_torch import kernels, resolve_device
from forde_tpu_torch.benchmarks import peak_gib, reset_peak, result_line, sync


def build(args, device, config=None):
    """(config, model): the reference's LLMConfig from the flags, or
    ``config`` in its place, with seeded random weights."""
    from forde_tpu_torch.core.config import DTypePolicy, LLMConfig
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    cfg = config if config is not None else LLMConfig(
        vocab_size=50_304,
        d_model=args.d_model,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        head_dim=args.d_model // args.num_heads,
        max_seq_len=args.max_seq_len,
        num_experts=args.num_experts,
        top_k_experts=2,
        expert_hidden_dim=4 * args.d_model,
        use_sparse_attention=args.nsa,
        window_size=args.nsa_window,
        compression_ratio=4,
        use_moe=args.num_experts > 1,
        use_hyper_connections=False,
        scan_layers=args.scan_layers,
        dropout_rate=0.0,
    )
    if args.bf16:
        cfg = cfg.replace(dtypes=DTypePolicy.bf16())
    model = FORDEDecoderLM(cfg, device=device,
                           generator=torch.Generator(device=device).manual_seed(0))
    return cfg, model.eval()


def workload(args, cfg):
    """Mixed lengths/budgets drawn from pow2-ish grids (the reference's
    draws, in its order)."""
    rng = np.random.RandomState(args.seed)

    def grid(lo, hi):
        g, v = [], lo
        while v <= hi:
            g.append(v)
            v *= 2
        return g

    lens = rng.choice(grid(args.min_prompt, args.max_prompt), args.requests)
    budgets = rng.choice(grid(args.min_new, args.max_new), args.requests)
    prompts = [
        rng.randint(1, cfg.vocab_size, (n,)).tolist() for n in lens
    ]
    return prompts, budgets


def arrivals(args):
    """The Poisson arrival times (s) of the load mode."""
    rng = np.random.RandomState(args.seed + 7)
    gaps = rng.exponential(1.0 / args.load_rate, args.requests)
    return np.cumsum(gaps)


def _device(model):
    return model.token_embed.weight.device


def _counted(fn):
    """fn() with the kernel launches reset first: (its result, the
    launches it made)."""
    kernels.reset_launches()
    out = fn()
    return out, dict(kernels.launches)


def run_sequential(model, prompts, budgets, warm):
    from forde_tpu_torch.models.generate import generate_cached

    dev = _device(model)

    def once():
        outs = []
        for p, b in zip(prompts, budgets):
            out = generate_cached(
                model, torch.tensor([p], dtype=torch.int32, device=dev), None,
                max_new_tokens=int(b), temperature=0,
            )
            outs.append(out.cpu())  # host sync
        return outs

    if warm:
        once()

    def timed():
        t0 = time.perf_counter()
        once()
        sync(dev)
        return time.perf_counter() - t0

    return _counted(timed)


def run_ragged(model, prompts, budgets, warm):
    from forde_tpu_torch.models.generate import generate_ragged

    dev = _device(model)
    lens = np.array([len(p) for p in prompts], np.int32)
    pmax = int(lens.max())
    new = int(budgets.max())  # a closed batch pays the longest budget
    padded = np.zeros((len(prompts), pmax), np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p

    def once():
        out = generate_ragged(
            model, torch.from_numpy(padded).to(dev), torch.from_numpy(lens).to(dev), None,
            max_new_tokens=new, temperature=0,
        )
        return out.cpu()  # host sync

    if warm:
        once()

    def timed():
        t0 = time.perf_counter()
        once()
        sync(dev)
        return time.perf_counter() - t0

    return _counted(timed)


def run_pool(model, prompts, budgets, rows, warm, chunk=None, fuse=1):
    from forde_tpu_torch.models.decode_pool import DecodePool

    dev = _device(model)

    def once():
        pool = DecodePool(model, rows=rows, temperature=0.0,
                          prefill_chunk=chunk, decode_fuse=fuse)
        for p, b in zip(prompts, budgets):
            pool.submit(p, max_new_tokens=int(b))
        n_done, ticks = 0, 0
        while pool.pending():
            n_done += len(pool.tick())
            ticks += 1
        if n_done != len(prompts):
            raise RuntimeError(f"{n_done} of {len(prompts)} requests finished")
        return ticks

    if warm:
        once()

    def timed():
        t0 = time.perf_counter()
        ticks = once()
        sync(dev)
        return time.perf_counter() - t0, ticks

    return _counted(timed)


def run_prefix(model, prompts, budgets, rows, plen, warm, seed):
    """Shared-prefix workload through the pool, with and without prefix
    caching. Returns ((t_without, t_with), launches)."""
    from forde_tpu_torch.models.decode_pool import DecodePool

    dev = _device(model)
    rng = np.random.RandomState(seed + 1)
    prefix = rng.randint(1, 1000, (plen,)).tolist()

    def drain(pool, submit):
        for p, b in zip(prompts, budgets):
            submit(pool, p, int(b))
        n = 0
        while pool.pending():
            n += len(pool.tick())
        if n != len(prompts):
            raise RuntimeError(f"{n} of {len(prompts)} requests finished")

    def without():
        pool = DecodePool(model, rows=rows, temperature=0.0)
        drain(pool, lambda pl, p, b: pl.submit(
            prefix + p, max_new_tokens=b))

    def with_cache():
        pool = DecodePool(model, rows=rows, temperature=0.0)
        pid = pool.register_prefix(prefix)
        drain(pool, lambda pl, p, b: pl.submit(
            p, max_new_tokens=b, prefix_id=pid))

    if warm:
        without()
        with_cache()

    def timed():
        t0 = time.perf_counter()
        without()
        sync(dev)
        t_wo = time.perf_counter() - t0
        t0 = time.perf_counter()
        with_cache()
        sync(dev)
        t_w = time.perf_counter() - t0
        return t_wo, t_w

    return _counted(timed)


def _pctl(xs, q):
    return round(float(np.percentile(np.asarray(xs), q)), 4) if len(xs) else None


def run_load_pool(model, prompts, budgets, arrivals, rows,
                  chunk=None, prefix=None, warm=True, fuse=1):
    """Open-loop Poisson load against the continuous pool.

    Requests become visible at their arrival times; the pool is ticked
    continuously. Per request: TTFT = first sampled token's host-visible
    time minus ARRIVAL (queueing included), TPOT = mean inter-token gap
    after the first. Returns ((the latency records, makespan), launches)."""
    from forde_tpu_torch.models.decode_pool import DecodePool

    dev = _device(model)

    def once():
        pool = DecodePool(model, rows=rows, temperature=0.0,
                          prefill_chunk=chunk, decode_fuse=fuse)
        pid = pool.register_prefix(prefix) if prefix is not None else None
        rec = {}
        first = {}
        last = {}
        ntok = {}

        def on_token(rid, tok):
            now = time.perf_counter()
            if rid not in first:
                first[rid] = now
            last[rid] = now
            ntok[rid] = ntok.get(rid, 0) + 1

        t0 = time.perf_counter()
        nxt = 0
        done = 0
        while done < len(prompts):
            now = time.perf_counter() - t0
            while nxt < len(prompts) and arrivals[nxt] <= now:
                rid = pool.submit(
                    prompts[nxt], max_new_tokens=int(budgets[nxt]),
                    prefix_id=pid, on_token=on_token,
                )
                rec[rid] = {"arrival": t0 + arrivals[nxt], "idx": nxt}
                nxt += 1
            if pool.pending():
                done += len(pool.tick())
            elif nxt < len(prompts):
                time.sleep(max(0.0, arrivals[nxt] - (time.perf_counter() - t0)))
        sync(dev)
        makespan = time.perf_counter() - t0
        out = []
        for rid, r in rec.items():
            tt = first[rid] - r["arrival"]
            n = ntok[rid]
            tpot = (last[rid] - first[rid]) / (n - 1) if n > 1 else 0.0
            out.append({"ttft": tt, "tpot": tpot, "n": n})
        return out, makespan

    if warm:
        once()
    return _counted(once)


def run_load_ragged(model, prompts, budgets, arrivals, rows,
                    warm=True):
    """Open-loop load against a dynamic-batching closed-batch server:
    collect everything that has arrived, run one ``generate_ragged`` call
    over up to ``rows`` requests, repeat. Tokens only become visible when
    their batch completes, so TTFT = batch completion - arrival."""
    from forde_tpu_torch.models.generate import generate_ragged

    dev = _device(model)

    def run_batch(idxs):
        ps = [prompts[i] for i in idxs]
        lens = np.array([len(p) for p in ps], np.int32)
        pmax = int(lens.max())
        new = int(max(budgets[i] for i in idxs))
        padded = np.zeros((len(ps), pmax), np.int32)
        for j, p in enumerate(ps):
            padded[j, : len(p)] = p
        out = generate_ragged(
            model, torch.from_numpy(padded).to(dev), torch.from_numpy(lens).to(dev), None,
            max_new_tokens=new, temperature=0,
        )
        out.cpu()  # host sync

    def once():
        t0 = time.perf_counter()
        nxt = 0
        out = []
        while nxt < len(prompts):
            now = time.perf_counter() - t0
            if arrivals[nxt] > now:
                time.sleep(arrivals[nxt] - now)
            avail = [
                i for i in range(nxt, len(prompts))
                if arrivals[i] <= time.perf_counter() - t0
            ]
            batch = avail[:rows]
            run_batch(batch)
            fin = time.perf_counter()
            for i in batch:
                n = int(budgets[i])
                # closed batch: every token of the batch lands at once
                out.append({
                    "ttft": fin - (t0 + arrivals[i]), "tpot": 0.0, "n": n,
                })
            nxt = batch[-1] + 1
        sync(dev)
        return out, time.perf_counter() - t0

    if warm:
        once()
    return _counted(once)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--num_layers", type=int, default=4)
    ap.add_argument("--num_heads", type=int, default=4)
    ap.add_argument("--num_experts", type=int, default=8)
    ap.add_argument("--max_seq_len", type=int, default=1024)
    ap.add_argument("--min_prompt", type=int, default=16)
    ap.add_argument("--max_prompt", type=int, default=128)
    ap.add_argument("--min_new", type=int, default=16)
    ap.add_argument("--max_new", type=int, default=64)
    ap.add_argument("--nsa", action="store_true",
                    help="serve the reference's DEFAULT attention (NSA) instead of "
                         "dense-causal; prefix/chunked modes are skipped (NSA prefill is "
                         "one teacher-forced forward: no resumable cache)")
    ap.add_argument("--nsa_window", type=int, default=128)
    ap.add_argument("--scan_layers", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix_len", type=int, default=256,
                    help="shared system-prompt length for the prefix mode")
    ap.add_argument("--prefill_chunk", type=int, default=None,
                    help="continuous mode: chunked prefill size")
    ap.add_argument("--decode_fuse", type=int, default=0,
                    help="continuous mode: decode k tokens per dispatch "
                         "(0 = off); adds fused variants to the reports")
    ap.add_argument("--skip", default="",
                    help="comma list: sequential,ragged,continuous,prefix,load")
    ap.add_argument("--load_rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s) for the load mode; "
                         "0 disables it")
    ap.add_argument("--load_prefix", action="store_true",
                    help="load mode: give every request a shared cached "
                         "prefix of --prefix_len")
    ap.add_argument("--no_warm", action="store_true",
                    help="skip the untimed warmup pass")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, *, config=None) -> None:
    """The reference's modes, their lines, and the last JSON line.
    ``config``: an ``LLMConfig`` in place of the one the width flags
    build (a tiny width for a CPU run); not a flag."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    reset_peak(device)
    cfg, model = build(args, device, config)
    prompts, budgets = workload(args, cfg)
    tokens = int(budgets.sum())
    print(f"# backend={device.type} requests={args.requests} "
          f"prompt_len=[{args.min_prompt},{args.max_prompt}] "
          f"new=[{args.min_new},{args.max_new}] "
          f"output_tokens={tokens} rows={args.rows}", flush=True)
    skip = set(args.skip.split(","))
    if args.nsa:
        # prefix caching / chunked prefill are dense-only contracts
        # (models/decode_pool.py NSA limits): skip, don't crash.
        skip.add("prefix")
        args.prefill_chunk = None
        args.load_prefix = False
    warm = not args.no_warm
    lines, counts = {}, {}

    def emit(line, launched):
        print(json.dumps(line), flush=True)
        lines[line["mode"]] = line
        counts[line["mode"]] = launched

    if "sequential" not in skip:
        dt, n = run_sequential(model, prompts, budgets, warm)
        emit({
            "mode": "sequential", "wall_s": round(dt, 3),
            "out_tok_per_s": round(tokens / dt, 1),
        }, n)
    if "ragged" not in skip:
        dt, n = run_ragged(model, prompts, budgets, warm)
        padded_tokens = int(budgets.max()) * args.requests
        emit({
            "mode": "ragged_batch", "wall_s": round(dt, 3),
            "out_tok_per_s": round(tokens / dt, 1),
            "decoded_incl_padding": padded_tokens,
        }, n)
    if "continuous" not in skip:
        (dt, ticks), n = run_pool(
            model, prompts, budgets, args.rows, warm,
            chunk=args.prefill_chunk,
        )
        emit({
            "mode": "continuous_pool", "wall_s": round(dt, 3),
            "out_tok_per_s": round(tokens / dt, 1),
            "ticks": ticks, "prefill_chunk": args.prefill_chunk,
        }, n)
        if args.decode_fuse > 1:
            (dt, ticks), n = run_pool(
                model, prompts, budgets, args.rows, warm,
                chunk=args.prefill_chunk, fuse=args.decode_fuse,
            )
            emit({
                "mode": "continuous_pool_fused", "wall_s": round(dt, 3),
                "out_tok_per_s": round(tokens / dt, 1),
                "ticks": ticks, "decode_fuse": args.decode_fuse,
                "prefill_chunk": args.prefill_chunk,
            }, n)
    if "prefix" not in skip:
        plen = min(
            args.prefix_len,
            cfg.max_seq_len - args.max_prompt - args.max_new - 1,
        )
        (t_wo, t_w), n = run_prefix(
            model, prompts, budgets, args.rows, plen, warm,
            args.seed,
        )
        emit({
            "mode": "prefix_cached_pool", "prefix_len": plen,
            "wall_s_no_cache": round(t_wo, 3),
            "wall_s_cached": round(t_w, 3),
            "speedup": round(t_wo / t_w, 2),
        }, n)

    # ---- open-loop Poisson load: TTFT/TPOT p50/p99 ----
    if args.load_rate > 0 and "load" not in skip:
        times = arrivals(args)
        prefix = None
        if args.load_prefix:
            plen = min(
                args.prefix_len,
                cfg.max_seq_len - args.max_prompt - args.max_new - 1,
            )
            prefix = np.random.RandomState(args.seed + 1).randint(
                1, 1000, (plen,)
            ).tolist()

        def report(name, recs, makespan, launched, tpot_defined=True, **kw):
            ttft = [r["ttft"] for r in recs]
            tpot = [r["tpot"] for r in recs if r["n"] > 1]
            toks = sum(r["n"] for r in recs)
            out = {
                "mode": name, "arrival_rate_rps": args.load_rate,
                "makespan_s": round(makespan, 3),
                "out_tok_per_s": round(toks / makespan, 1),
                "ttft_p50_s": _pctl(ttft, 50), "ttft_p99_s": _pctl(ttft, 99),
                **kw,
            }
            if tpot_defined:
                out["tpot_p50_s"] = _pctl(tpot, 50)
                out["tpot_p99_s"] = _pctl(tpot, 99)
            emit(out, launched)

        (recs, mk), n = run_load_ragged(
            model, prompts, budgets, times, args.rows, warm
        )
        report("load_ragged_dynamic", recs, mk, n, tpot_defined=False)
        (recs, mk), n = run_load_pool(
            model, prompts, budgets, times, args.rows,
            chunk=None, prefix=prefix, warm=warm,
        )
        report("load_continuous", recs, mk, n,
               prefix_len=len(prefix) if prefix else 0)
        if args.decode_fuse > 1:
            (recs, mk), n = run_load_pool(
                model, prompts, budgets, times, args.rows,
                chunk=None, prefix=prefix, warm=warm,
                fuse=args.decode_fuse,
            )
            report("load_continuous_fused", recs, mk, n,
                   decode_fuse=args.decode_fuse,
                   prefix_len=len(prefix) if prefix else 0)
        if args.prefill_chunk:
            (recs, mk), n = run_load_pool(
                model, prompts, budgets, times, args.rows,
                chunk=args.prefill_chunk, prefix=prefix, warm=warm,
            )
            report("load_continuous_chunked", recs, mk, n,
                   prefill_chunk=args.prefill_chunk,
                   prefix_len=len(prefix) if prefix else 0)

    head = lines.get("continuous_pool")
    extra = {mode: line for mode, line in lines.items() if mode != "continuous_pool"}
    extra.update(peak_gib=peak_gib(device), launches=counts)
    print(result_line("serving_out_tok_per_s_continuous_pool",
                      None if head is None else head["out_tok_per_s"], "tokens/s", extra,
                      device), flush=True)


if __name__ == "__main__":
    main()
