"""Decoder-LM training throughput on one card: tokens/s (port of
benchmarks/decoder.py).

The reference's configuration: d_model 512, 12 layers, 8 heads x 64, 8
experts top-2, NSA window 512 at S = 2,048, mHC 4 streams, vocabulary
50,257, bf16 (the reference-default LLMConfig scale), batch 8 x 2,048
seeded tokens, dense against capacity MoE dispatch. Per dispatch 2
warm-up steps, a finite-loss check, then 10 timed steps ending in
``torch.cuda.synchronize()``; tokens/s = steps * batch * seq / dt.

Substitutions: ``scan_layers`` is a checkpoint layout in the port, not a
loop (DECODER_SEQ > 2,048 sets it, with remat, as the reference does);
``/ jax.device_count()`` is ``/ 1``: one process on one card. Weights
come from a ``torch.Generator`` seeded 0.

Prints the reference's line per dispatch and its JSON of both rates, then
ONE JSON line: ``decoder_tokens_per_sec_per_chip_dense``, with capacity's
rate, ms per step, peak GiB, the launches of each timed section and the
card in ``extra``.

    python3 -m forde_tpu_torch.benchmarks.decoder [--device cpu]

Env knobs: DECODER_SEQ, DECODER_BATCH.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from forde_tpu_torch import kernels, resolve_device
from forde_tpu_torch.benchmarks import peak_gib, release, reset_peak, result_line, sync


def decoder_config(dispatch: str, seq: int):
    from forde_tpu_torch.core.config import DTypePolicy, LLMConfig

    return LLMConfig(
        vocab_size=50257,
        d_model=512,
        num_layers=12,
        num_heads=8,
        head_dim=64,
        max_seq_len=seq,
        num_experts=8,
        top_k_experts=2,
        expert_hidden_dim=2048,
        window_size=512,
        compression_ratio=8,
        top_k_global=64,
        num_streams=4,
        sinkhorn_iterations=5,
        dropout_rate=0.0,
        moe_dispatch=dispatch,
        # long-context runs (DECODER_SEQ > 2048): scanned layers + remat,
        # as the reference's
        scan_layers=seq > 2048,
        remat=seq > 2048,
        dtypes=DTypePolicy.bf16(),
    )


def bench(dispatch: str, batch: int = 8, seq: int = 2048, steps: int = 10, *, device=None,
          config=None, stats: Optional[dict] = None) -> float:
    """Tokens/s of ``steps`` timed train steps under ``dispatch``.
    ``config``: an ``LLMConfig`` in place of the reference's (its
    ``moe_dispatch`` set to ``dispatch``). ``stats`` receives ms per step,
    the timed section's launches and the peak GiB."""
    from forde_tpu_torch.train.state import create_train_state
    from forde_tpu_torch.train.step import train_step

    device = resolve_device(device)
    cfg = (decoder_config(dispatch, seq) if config is None
           else config.replace(moe_dispatch=dispatch))
    reset_peak(device)
    state = create_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), 3e-4, 0.01, device=device,
    )
    rng = np.random.RandomState(0)
    b = {"input_ids": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(device)}
    for _ in range(2):
        state, m = train_step(state, b, aux_loss_weight=1.0)
    sync(device)
    loss = float(m["loss/total"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = train_step(state, b, aux_loss_weight=1.0)
    sync(device)
    float(m["loss/total"])
    dt = time.perf_counter() - t0
    tok_s = steps * batch * seq / dt / 1
    if stats is not None:
        stats.update(ms_per_step=dt / steps * 1e3, launches=dict(kernels.launches),
                     peak_gib=peak_gib(device))
    print(
        f"moe_dispatch={dispatch}: {dt / steps * 1000:.1f} ms/step  "
        f"{tok_s:,.0f} tok/s/chip",
        flush=True,
    )
    return tok_s


def main(argv=None, *, config=None, steps: int = 10) -> None:
    """Dense, then capacity, and the JSON lines. ``config`` (an
    ``LLMConfig``, a tiny width for a CPU run) and ``steps`` are not
    flags."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    seq = int(os.environ.get("DECODER_SEQ", "2048"))
    batch = int(os.environ.get("DECODER_BATCH", "8"))
    results, runs = {}, {}
    for dispatch in ("dense", "capacity"):
        runs[dispatch] = {}
        results[f"decoder_tokens_per_sec_per_chip_{dispatch}"] = round(
            bench(dispatch, batch=batch, seq=seq, steps=steps, device=device, config=config,
                  stats=runs[dispatch]), 1
        )
        release(device)
    print(json.dumps(results), flush=True)
    extra = {"decoder_tokens_per_sec_per_chip_capacity":
             results["decoder_tokens_per_sec_per_chip_capacity"],
             "batch": batch, "seq": seq, "steps": steps}
    for name in ("ms_per_step", "peak_gib", "launches"):
        extra[name] = {d: r[name] for d, r in runs.items()}
    print(result_line("decoder_tokens_per_sec_per_chip_dense",
                      results["decoder_tokens_per_sec_per_chip_dense"], "tokens/s/chip", extra,
                      device), flush=True)


if __name__ == "__main__":
    main()
