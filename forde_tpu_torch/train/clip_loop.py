"""Dual-encoder (CLIP) training loop and CLI (port of
forde_tpu/train/clip_loop.py).

Contrastive steps with FORDE sensing every ``--sense_interval``-th step
(the other steps run the same update with sensing off), and every
``--slow_loop_interval`` steps the neuron slow loop (GMM, or Forde-lite)
re-specialises the StatefulLayers. Data are the synthetic pairs
(``--use_dummy_data``); ``--dummy_pool`` keeps that many batches on the
device and cycles them. With ``--checkpoint_dir`` the final parameters and
brain map are written in the port's checkpoint format, which
``forde_tpu_torch.embed`` serves. Runs on CUDA unless ``--device cpu``;
with no GPU visible it raises.

  python -m forde_tpu_torch.train.clip_loop --preset vit_b16 --bf16 \\
      --use_dummy_data --dummy_pool 2 --batch_size 128 --num_steps 16 \\
      --sense_interval 8 --slow_loop_interval 8 --moment_dtype bfloat16
  python -m forde_tpu_torch.train.clip_loop --device cpu --preset tiny \\
      --use_dummy_data --batch_size 2 --num_steps 4 --slow_loop_interval 2

``--fuse_steps k`` runs k steps per call of ``make_fused_step``: on the
card one CUDA graph of the k steps over a stacked super-batch.

Not ported yet (and not accepted): ``--ema_decay``,
``--tensor_parallelism``, ``--param_sharding``, ``--use_aligned_data``,
the retrieval eval, plots, ``--profile_dir`` and ``--resume``.
"""

from __future__ import annotations

import argparse
import itertools
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from forde_tpu_torch import resolve_device
from forde_tpu_torch.core.config import (
    BrainConfig,
    DTypePolicy,
    DualEncoderConfig,
    TowerConfig,
    vit_b16_config,
    vit_tiny_config,
    vit_tiny_hd128_config,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the FORDE dual encoder")
    p.add_argument("--preset", choices=["tiny", "tiny_hd128", "vit_b16", "custom"],
                   default="tiny")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--text_len", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup from 0 (the first step's LR is 0)")
    p.add_argument("--lr_schedule", choices=["constant", "cosine"], default="constant",
                   help="post-warmup LR: constant, or cosine decay to "
                        "min_lr_ratio*peak over --decay_steps")
    p.add_argument("--decay_steps", type=int, default=0,
                   help="cosine decay horizon (after warmup); 0 = derive "
                        "from num_steps - warmup")
    p.add_argument("--min_lr_ratio", type=float, default=0.0,
                   help="cosine floor as a fraction of the peak LR")
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--slow_loop_interval", type=int, default=100,
                   help="steps between brain updates (0 disables)")
    p.add_argument("--sense_interval", type=int, default=1,
                   help="run FORDE sensing every k-th step (1 = every step); "
                        "the slow loop reads time-averaged stats")
    p.add_argument("--fuse_steps", type=int, default=1,
                   help="run k optimizer steps per dispatch as ONE "
                        "captured CUDA graph over a stacked batch "
                        "(train/clip_step.make_fused_step) — removes "
                        "the per-step host dispatch from the step "
                        "cadence; identical math and step order to k "
                        "unfused steps (tests/test_torch_fuse_steps.py). "
                        "Must be a multiple of --sense_interval; "
                        "log/slow-loop cadences round up to fuse "
                        "boundaries.")
    p.add_argument("--forde_lite", action="store_true",
                   help="rule-based assignments instead of the GMM")
    p.add_argument("--gmm", action="store_true",
                   help="force GMM clustering (overrides a preset's forde_lite)")
    p.add_argument("--use_dummy_data", action="store_true",
                   help="synthetic pairs (the only data source ported)")
    p.add_argument("--dummy_pool", type=int, default=0,
                   help="with --use_dummy_data: keep this many batches on the "
                        "device and cycle them (0 = fresh host batches)")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="write the final params + brain here (port format)")
    p.add_argument("--experiment_name", type=str, default="forde_tpu_clip",
                   help="metrics go to runs/<name>_<time>/metrics.jsonl")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--moment_dtype", type=str, default=None,
                   help="Adam moment storage dtype (e.g. bfloat16); update "
                        "math stays fp32")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    # custom-preset model knobs
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--embed_dim", type=int, default=512)
    p.add_argument("--tower_layers", type=int, default=0,
                   help="custom preset: override both towers' num_layers")
    p.add_argument("--tower_dim", type=int, default=0,
                   help="custom preset: override both towers' d_model "
                        "(heads/head_dim/mlp scale with it)")
    return p


def config_from_args(args) -> DualEncoderConfig:
    if args.preset == "vit_b16":
        cfg = vit_b16_config()
    elif args.preset == "tiny":
        cfg = vit_tiny_config()
    elif args.preset == "tiny_hd128":
        cfg = vit_tiny_hd128_config()
    else:
        towers = {}
        if args.tower_dim or args.tower_layers:
            d = args.tower_dim or 512
            heads = max(2, d // 64)
            tower = TowerConfig(
                d_model=d, num_layers=args.tower_layers or 12,
                num_heads=heads, head_dim=d // heads, mlp_hidden_dim=4 * d,
            )
            towers = {"vision": tower, "text": tower}
        cfg = DualEncoderConfig(
            image_size=args.image_size, patch_size=args.patch_size,
            embed_dim=args.embed_dim, **towers,
        )
    if args.forde_lite:
        cfg = cfg.replace(forde_lite=True)
    if args.gmm:
        cfg = cfg.replace(forde_lite=False)
    if args.bf16:
        cfg = cfg.replace(dtypes=DTypePolicy.bf16())
    if args.text_len:
        cfg = cfg.replace(max_text_len=args.text_len)
    return cfg.replace(sense=True)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args: Optional[argparse.Namespace] = None) -> dict:
    """Run the loop; returns {"state", "final_metrics", "step",
    "pairs_per_sec", "brain_updates"}. Each brain update's
    record holds its step, latency, ``skipped``, and the sums of |grad_stats|
    and the sensed step counts just before the update and just after."""
    from forde_tpu_torch.brain.neuron_slow_loop import neuron_slow_loop_step
    from forde_tpu_torch.data.prefetch import prefetch_to_device
    from forde_tpu_torch.data.vl import SyntheticVLDataset
    from forde_tpu_torch.interop import flatten, state_dict_to_flax
    from forde_tpu_torch.nn.stateful import stateful_layers
    from forde_tpu_torch.obs.metrics import MetricsWriter, ThroughputMeter
    from forde_tpu_torch.train.checkpoint import save_params
    from forde_tpu_torch.train.clip_step import (
        clip_train_step,
        create_clip_train_state,
        make_fused_step,
        make_nosense_step,
        stack_batches,
    )

    if args is None:
        args = build_parser().parse_args([])
    if not args.use_dummy_data:
        raise NotImplementedError(
            "only --use_dummy_data is ported; the streamed Conceptual "
            "Captions pipeline is not"
        )
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    brain = BrainConfig()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.lr_schedule == "cosine" and args.decay_steps == 0:
        args.decay_steps = max(args.num_steps - args.warmup_steps, 1)
        print(f"cosine decay over {args.decay_steps} steps (derived from the run length)")

    t_init = time.perf_counter()
    state = create_clip_train_state(
        cfg, generator, args.learning_rate, args.weight_decay,
        warmup_steps=args.warmup_steps, moment_dtype=args.moment_dtype,
        lr_schedule=args.lr_schedule, decay_steps=args.decay_steps,
        min_lr_ratio=args.min_lr_ratio, device=device,
    )
    n_params = sum(p.numel() for p in state.optimizer.params)
    print(f"state created in {time.perf_counter() - t_init:.1f}s "
          f"({n_params / 1e6:.1f}M params) on {device}", flush=True)

    nosense_step = make_nosense_step(cfg) if args.sense_interval > 1 else None
    fuse = max(1, args.fuse_steps)
    fused_step = None
    if fuse > 1:
        if args.sense_interval > 1 and fuse % args.sense_interval:
            raise SystemExit(
                f"--fuse_steps ({fuse}) must be a multiple of "
                f"--sense_interval ({args.sense_interval})"
            )
        # Host-side cadences fire on `step % interval == 0` and step now
        # advances by `fuse` per dispatch — round them up to boundaries.
        for name in ("log_interval", "slow_loop_interval"):
            v = getattr(args, name)
            if v > 0 and v % fuse:
                rounded = ((v + fuse - 1) // fuse) * fuse
                print(f"--{name} {v} -> {rounded} (rounded to a "
                      f"--fuse_steps boundary)")
                setattr(args, name, rounded)
        fused_step = make_fused_step(cfg, fuse, args.sense_interval, nosense_step=nosense_step)

    writer = MetricsWriter(f"runs/{args.experiment_name}_{datetime.now():%Y%m%d_%H%M%S}")
    dataset = SyntheticVLDataset(
        args.batch_size, args.num_steps, image_size=cfg.image_size,
        text_len=args.text_len, vocab_size=cfg.vocab_size, seed=args.seed,
        pool=args.dummy_pool,
    )
    if args.dummy_pool:
        # Device-resident pool: each distinct batch is copied once, its
        # images in the compute dtype (the model's first op casts them);
        # with --fuse_steps, pre-stacked super-batches.
        pool = []
        for b in itertools.islice(iter(dataset), max(args.dummy_pool, fuse)):
            db = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            db["image"] = db["image"].to(cfg.dtypes.compute)
            pool.append(db)
        if fused_step is not None:
            pool = [fused_step.prepare(sb) for sb in stack_batches(iter(pool), fuse)]
        batches = (pool[i % len(pool)] for i in range(args.num_steps // fuse))
    else:
        batches = prefetch_to_device(iter(dataset), device)
        if fused_step is not None:
            batches = (fused_step.prepare(sb) for sb in stack_batches(batches, fuse))

    meter = ThroughputMeter(items_per_step=args.batch_size * fuse)
    step, last, brain_updates = 0, {}, []
    metrics = None
    try:
        for batch in batches:
            if fused_step is not None:
                # the slow loop below runs only between fused calls
                state, metrics = fused_step(state, batch)
                step += fuse
            elif nosense_step is not None and step % args.sense_interval:
                state, metrics = nosense_step(state, batch)
                step += 1
            else:
                state, metrics = clip_train_step(state, batch)
                step += 1
            meter.step()

            if step % args.log_interval == 0:
                last = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(last["loss/contrastive"]):
                    raise FloatingPointError(f"non-finite loss at step {step}: {last}")
                writer.scalars(last, step)
                pps = meter.items_per_sec
                writer.scalar("Throughput/pairs_per_sec_per_chip", pps, step)
                print(f"step {step}: loss {last['loss/contrastive']:.4f} "
                      f"acc_i {last['contrastive/acc_img']:.2f} "
                      f"grad_norm {last['training/grad_norm']:.2f} "
                      f"{pps:,.0f} pairs/s/device", flush=True)
                if step <= args.log_interval:
                    meter.reset()  # the first window holds the warm-up

            if args.slow_loop_interval > 0 and step % args.slow_loop_interval == 0:
                layers = stateful_layers(state.model).values()
                before = (
                    float(sum(g.abs().sum() for g in state.grad_stats.values())),
                    int(sum(layer.step_count for layer in layers)),
                )
                # Drain the queued steps first: the latency is the update's own.
                _synchronize(device)
                t0 = time.perf_counter()
                diag = neuron_slow_loop_step(
                    state.model, state.grad_stats, state.grad_step_count, generator,
                    brain=brain, forde_lite=cfg.forde_lite,
                )
                _synchronize(device)
                dt_ms = (time.perf_counter() - t0) * 1000
                skipped = bool(diag["skipped"])
                after = (
                    float(sum(g.abs().sum() for g in state.grad_stats.values())),
                    int(sum(layer.step_count for layer in layers)),
                )
                brain_updates.append({
                    "step": step, "latency_ms": dt_ms, "skipped": skipped,
                    "grad_stats_abs_sum_before": before[0], "grad_stats_abs_sum_after": after[0],
                    "sensed_steps_before": before[1], "sensed_steps_after": after[1],
                })
                writer.scalar("SlowLoop/latency_ms", dt_ms, step)
                mode = "Forde-lite" if cfg.forde_lite else "GMM"
                print(f"[brain update @ {step}] mode={mode} {dt_ms:.1f}ms"
                      f"{' (skipped: no sensed step)' if skipped else ''}", flush=True)

            if step >= args.num_steps:
                break

        _synchronize(device)
        if metrics is not None and not last:
            last = {k: float(v) for k, v in metrics.items()}
        if args.checkpoint_dir:
            tree = state_dict_to_flax(state.model.state_dict())
            save_params(
                args.checkpoint_dir, cfg,
                flatten({"params": tree["params"], "brain": tree["brain"]}),
                {
                    "step": step, "moment_dtype": args.moment_dtype,
                    "warmup_steps": args.warmup_steps, "lr_schedule": args.lr_schedule,
                    "decay_steps": args.decay_steps, "min_lr_ratio": args.min_lr_ratio,
                },
            )
            print(f"checkpoint (params + brain, step {step}) written to {args.checkpoint_dir}")
    finally:
        writer.close()
    return {
        "state": state, "final_metrics": last, "step": step,
        "pairs_per_sec": meter.items_per_sec,
        "brain_updates": brain_updates,
    }


def main(argv: Optional[list] = None) -> dict:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
