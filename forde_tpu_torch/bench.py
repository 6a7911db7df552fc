"""Headline benchmark of the port: image-text pairs/s of the dual
encoder's training step on one card (port of bench.py).

The reference's timed work, call for call: the full FORDE fast loop
(forward, contrastive loss, backward, optimizer, activation and gradient
sensing) in bf16 with bf16 Adam moments and ``forde_lite`` off, for the
presets ``vit_b16_hd128`` (the headline) and ``vit_b16`` at batch 128 and
``tiny_hd128`` at 512; the headline again at the production sensing
stride (``make_nosense_step`` between sensed steps); and ``tiny_hd128``
at sense 32 x 32 fused steps at batch 384, the median of 3 runs with the
min and max. Seeded inputs as the reference draws them; weights from a
``torch.Generator`` seeded 0. Every timed section ends in
``torch.cuda.synchronize()`` and a finite-loss check.

Substitutions:

* JAX's ``lax.scan`` of k steps in one jitted call (bench.py:114-160) is
  one call of the port's ``make_fused_step(cfg, k, sense_interval)``: on
  the card one CUDA graph of the k steps, over a stacked super-batch of k
  copies of the one batch (at ``tiny_hd128``, batch 384 and k = 32, 7.4 GB
  of fp32 images, and as much again in the graph's static copy). Its
  first call runs and captures the k steps, as the reference's first call
  compiles them.
* ``/ jax.device_count()`` is ``/ 1``: one process on one card.
* ``vs_baseline`` is null: the reference's 10,000 pairs/s/chip is a TPU
  v5e target, not the card's.

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"extra"}``; ``extra`` holds every other rate, and per run the kernel
launches of its timed section, its peak device memory, its ms per step
and the seconds of its first (warm-up) call, and the card.

Env knobs (the reference's): BENCH_PRESET (vit_b16|tiny|tiny_hd128|
vit_b16_hd128|both), BENCH_BATCH, BENCH_STEPS, BENCH_REMAT,
BENCH_ATTN_IMPL, BENCH_MOMENT_DTYPE, BENCH_SENSE_STRIDE (0 skips the
strided run), BENCH_SCAN, BENCH_SCAN_EXTRA, BENCH_SCAN_STRIDE,
BENCH_SCAN_REPS, BENCH_SCAN_BATCH. ``main(device=...)`` picks the device
(``cuda`` by default; it raises when no GPU is visible).

    python3 -m forde_tpu_torch.bench
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from forde_tpu_torch import kernels, resolve_device
from forde_tpu_torch.benchmarks import peak_gib, release, reset_peak, result_line, sync

DEFAULT_BATCH = {
    "vit_b16": 128, "tiny": 512, "tiny_hd128": 512, "vit_b16_hd128": 128,
}


def preset_config(preset: str):
    """The dual encoder configuration of ``preset``."""
    from forde_tpu_torch.core.config import (
        vit_b16_config,
        vit_b16_hd128_config,
        vit_tiny_config,
        vit_tiny_hd128_config,
    )

    return {
        "vit_b16": vit_b16_config,
        "tiny": vit_tiny_config,
        "tiny_hd128": vit_tiny_hd128_config,
        "vit_b16_hd128": vit_b16_hd128_config,
    }[preset]()


def run_preset(
    preset: str,
    batch_size: int,
    steps: int,
    sense_interval: int = 1,
    scan_k: int = 0,
    *,
    device=None,
    config=None,
    stats: Optional[dict] = None,
) -> float:
    """Pairs/s of ``steps`` timed training steps of ``preset`` (or of
    ``config``, a ``DualEncoderConfig`` in its place) at ``batch_size``,
    after the reference's warm-up. ``stats``, if given, receives the
    launches of the timed section, the peak GiB, ms per step and the
    first call's seconds."""
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.train.clip_step import (
        clip_train_step,
        create_clip_train_state,
        make_fused_step,
        make_nosense_step,
    )

    device = resolve_device(device)
    text_len = 64
    cfg = config if config is not None else preset_config(preset)
    cfg = cfg.replace(dtypes=DTypePolicy.bf16(), forde_lite=False)
    if os.environ.get("BENCH_REMAT"):
        cfg = cfg.replace(remat=os.environ["BENCH_REMAT"])
    if os.environ.get("BENCH_ATTN_IMPL"):
        cfg = cfg.replace(attention_kernel_impl=os.environ["BENCH_ATTN_IMPL"])

    reset_peak(device)
    state = create_clip_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), 1e-4, 0.01,
        moment_dtype=os.environ.get("BENCH_MOMENT_DTYPE", "bfloat16") or None,
        device=device,
    )

    rng = np.random.RandomState(0)
    host = {
        "image": rng.rand(batch_size, cfg.image_size, cfg.image_size, 3).astype(np.float32),
        "input_ids": rng.randint(1, cfg.vocab_size, (batch_size, text_len)).astype(np.int32),
        "attention_mask": np.ones((batch_size, text_len), np.int32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}

    nosense = make_nosense_step(cfg) if sense_interval > 1 else None
    stats = {} if stats is None else stats

    def finish(n: int, t0: float, metrics) -> float:
        sync(device)
        loss_sync = float(metrics["loss/contrastive"])
        dt = time.perf_counter() - t0
        if not np.isfinite(loss_sync):
            raise RuntimeError(f"non-finite loss {loss_sync}")
        stats.update(launches=dict(kernels.launches), peak_gib=peak_gib(device),
                     ms_per_step=dt / n * 1e3)
        return n * batch_size / dt / 1

    # Fused mode (BENCH_SCAN=k): k optimizer steps per call, the sensing
    # stride expressed statically as whole groups (one sensed step, then
    # stride - 1 unsensed), as the reference's scan of groups does.
    scan_k = scan_k or int(os.environ.get("BENCH_SCAN", "0"))
    if scan_k > 1:
        group = sense_interval if nosense is not None else 1
        n_groups = max(scan_k // group, 1)
        steps_per_call = n_groups * group
        fused = make_fused_step(cfg, steps_per_call, group, clip_train_step, nosense)
        stacked = fused.prepare({k: torch.stack([v] * steps_per_call) for k, v in batch.items()})
        t0 = time.perf_counter()
        state, metrics = fused(state, stacked)  # warm-up: the graph's capture
        sync(device)
        float(metrics["loss/contrastive"])
        stats["first_call_s"] = time.perf_counter() - t0
        calls = max(steps // steps_per_call, 1)
        kernels.reset_launches()
        t0 = time.perf_counter()
        for _ in range(calls):
            state, metrics = fused(state, stacked)
        return finish(calls * steps_per_call, t0, metrics)

    def one_step(i, state):
        if nosense is not None and i % sense_interval:
            return nosense(state, batch)
        return clip_train_step(state, batch)

    t0 = time.perf_counter()
    for i in range(2 if nosense is None else 2 * sense_interval):
        state, metrics = one_step(i, state)
    sync(device)
    float(metrics["loss/contrastive"])
    stats["first_call_s"] = time.perf_counter() - t0

    kernels.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = one_step(i, state)
    return finish(steps, t0, metrics)


def main(device=None, config=None) -> None:
    """The reference's runs and its one JSON line. ``config``: a
    ``DualEncoderConfig`` that takes the place of every preset's (a
    tiny width for a CPU run)."""
    device = resolve_device(device)
    preset = os.environ.get("BENCH_PRESET", "both")
    steps = int(os.environ.get("BENCH_STEPS", "20"))
    presets = (
        ["vit_b16_hd128", "vit_b16", "tiny_hd128"]
        if preset == "both"
        else [preset]
    )

    rates, runs = {}, {}

    def run(key, *args, **kw):
        runs.setdefault(key, [])
        runs[key].append({})
        rate = run_preset(*args, device=device, config=config, stats=runs[key][-1], **kw)
        release(device)
        return rate

    for p in presets:
        batch = int(os.environ.get("BENCH_BATCH", DEFAULT_BATCH[p]))
        rates[p] = round(run(p, p, batch, steps), 2)

    # The headline: vit_b16_hd128 at the production sensing stride.
    headline = presets[0]
    headline_key = headline
    stride = int(os.environ.get("BENCH_SENSE_STRIDE", "8"))
    if stride > 1:
        batch = int(os.environ.get("BENCH_BATCH", DEFAULT_BATCH[headline]))
        key = f"{headline}_sense{stride}"
        rates[key] = round(run(key, headline, batch, max(steps, 2 * stride), stride), 2)
        headline_key = key
    # tiny_hd128 at sense 32 x 32 fused steps, batch 384: the median of 3
    # runs with the min and max.
    scan_extra = int(os.environ.get("BENCH_SCAN_EXTRA", "32"))
    scan_stride = int(os.environ.get("BENCH_SCAN_STRIDE", "32"))
    scan_reps = int(os.environ.get("BENCH_SCAN_REPS", "3"))
    scan_batch = int(
        os.environ.get("BENCH_SCAN_BATCH", os.environ.get("BENCH_BATCH", "384"))
    )
    if preset == "both" and scan_stride > 1 and scan_extra > 1:
        key = f"tiny_hd128_sense{scan_stride}_scan{scan_extra}"
        samples = sorted(
            run(key, "tiny_hd128", scan_batch, max(steps, 3 * scan_extra), scan_stride,
                scan_k=scan_extra)
            for _ in range(scan_reps)
        )
        rates[key] = round(samples[len(samples) // 2], 2)
        rates[f"{key}_min"] = round(samples[0], 2)
        rates[f"{key}_max"] = round(samples[-1], 2)
    extra = {
        f"image_text_pairs_per_sec_per_chip_{p}_bf16": v
        for p, v in rates.items()
        if p != headline_key
    }
    for name in ("launches", "peak_gib", "ms_per_step", "first_call_s"):
        extra[name] = {k: [r[name] for r in rs] if len(rs) > 1 else rs[0][name]
                       for k, rs in runs.items()}
    print(result_line(f"image_text_pairs_per_sec_per_chip_{headline_key}_bf16",
                      rates[headline_key], "pairs/s/chip", extra, device), flush=True)


if __name__ == "__main__":
    main()
