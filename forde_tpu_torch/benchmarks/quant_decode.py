"""Decode throughput on one card: fp vs weight-only int8 serving (port
of benchmarks/quant_decode.py).

Single-stream (batch 1) KV-cache decode tokens/s at a weight-dominated
scale (the reference decoder's width by default, dense-causal, bf16):
``generate_cached`` of ``--new`` greedy tokens from a ``--prompt_len``
prompt of ones, once to warm up, then the best of ``--reps`` timed runs,
each ending in ``torch.cuda.synchronize()``; the same for the
``quantize_params`` copy of the model (int8 weights, ``ops/quant.py``).
On the card both decode from a CUDA graph. An int8 product runs
``torch._int_mm``, which takes more than 16 rows: at batch 1
``int8_matmul`` pads the one row to 17.

Substitutions: ``scan_layers`` is a checkpoint layout in the port, not a
loop; the weights come from a ``torch.Generator`` seeded 0.

Prints the reference's lines, then ONE JSON line:
``decode_tokens_per_sec_batch1_int8``, with the fp/bf16 rate, the int8
speed-up, each run's peak GiB and the launches of its timed runs, and the
card in ``extra``.

    python3 -m forde_tpu_torch.benchmarks.quant_decode [--d_model 512]
        [--layers 12] [--new 128] [--moe] [--nsa] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from forde_tpu_torch import kernels, resolve_device
from forde_tpu_torch.benchmarks import peak_gib, reset_peak, result_line, sync


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--new", type=int, default=128)
    p.add_argument("--prompt_len", type=int, default=32)
    p.add_argument("--moe", action="store_true")
    p.add_argument("--nsa", action="store_true")
    p.add_argument("--scan_layers", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None, *, config=None) -> None:
    """fp/bf16, then int8, and the lines. ``config``: an ``LLMConfig`` in
    place of the one the flags build (a tiny width for a CPU run); not a
    flag."""
    from forde_tpu_torch.core.config import DTypePolicy, LLMConfig
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.models.generate import generate_cached
    from forde_tpu_torch.ops.quant import quantize_params

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = config if config is not None else LLMConfig(
        vocab_size=50257,
        d_model=args.d_model,
        num_layers=args.layers,
        num_heads=args.heads,
        head_dim=args.d_model // args.heads,
        max_seq_len=2048,
        use_moe=args.moe,
        expert_hidden_dim=4 * args.d_model,
        use_sparse_attention=args.nsa,
        use_hyper_connections=False,
        dropout_rate=0.0,
        scan_layers=args.scan_layers,
        dtypes=DTypePolicy.bf16(),
    )
    model = FORDEDecoderLM(cfg, device=device,
                           generator=torch.Generator(device=device).manual_seed(0)).eval()
    prompt = torch.ones((1, args.prompt_len), dtype=torch.int32, device=device)
    qmodel = quantize_params(model)
    runs = {}

    def run(m, tag):
        reset_peak(device)
        out = generate_cached(m, prompt, None, max_new_tokens=args.new, temperature=0)
        sync(device)
        int(out[0, -1])
        best = float("inf")
        kernels.reset_launches()
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = generate_cached(m, prompt, None, max_new_tokens=args.new, temperature=0)
            sync(device)
            int(out[0, -1])
            best = min(best, time.perf_counter() - t0)
        rate = args.new / best
        runs[tag.strip()] = {"ms": best * 1e3, "peak_gib": peak_gib(device),
                             "launches": dict(kernels.launches)}
        print(f"{tag}: {best * 1e3:.1f} ms for {args.new} tokens "
              f"= {rate:,.0f} tok/s (batch 1)", flush=True)
        return rate

    fp = run(model, "fp/bf16")
    q = run(qmodel, "int8   ")
    print(f"int8 speedup: {q / fp:.2f}x", flush=True)
    extra = {"decode_tokens_per_sec_batch1_fp": fp, "int8_speedup": q / fp,
             "new_tokens": args.new, "reps": args.reps}
    for name in ("ms", "peak_gib", "launches"):
        extra[name] = {tag: r[name] for tag, r in runs.items()}
    print(result_line("decode_tokens_per_sec_batch1_int8", q, "tokens/s", extra, device),
          flush=True)


if __name__ == "__main__":
    main()
