"""Dual-encoder (CLIP) training loop and CLI (port of
forde_tpu/train/clip_loop.py).

Contrastive steps with FORDE sensing every ``--sense_interval``-th step
(the other steps run the same update with sensing off), and every
``--slow_loop_interval`` steps the neuron slow loop (GMM, or Forde-lite)
re-specialises the StatefulLayers. Data: the synthetic pairs
(``--use_dummy_data``; ``--dummy_pool`` keeps that many batches on the
device and cycles them), or the aligned pairs (``--use_aligned_data``,
rendered on the device from class ids, ``data/vl.AlignedDeviceRenderer``:
training on classes [0, 0.9 C) of ``--aligned_classes`` C). Every
``--eval_interval`` steps the retrieval eval (obs/retrieval.py) runs over
``--eval_batches`` held-out batches: ``seen_`` (new renders of training
classes) and ``unseen_`` (held-out classes) with aligned data, and with
``--ema_decay`` the same sets on the EMA weights (``ema_`` tags). With
``--checkpoint_dir`` the whole train state is saved every
``max(slow_loop_interval, 100)`` steps and at the end (``embed`` serves
it), ``--resume`` goes on from it, and SIGTERM/SIGINT stop the run at the
next step boundary and save. Runs on CUDA unless ``--device cpu``; with no
GPU visible it raises.

  python -m forde_tpu_torch.train.clip_loop --preset vit_b16 --bf16 \\
      --use_dummy_data --dummy_pool 2 --batch_size 128 --num_steps 16 \\
      --sense_interval 8 --slow_loop_interval 8 --moment_dtype bfloat16
  python -m forde_tpu_torch.train.clip_loop --device cpu --preset tiny \\
      --use_aligned_data --aligned_classes 64 --batch_size 4 --num_steps 4 \\
      --eval_interval 2 --eval_batches 2 --ema_decay 0.99 --slow_loop_interval 2

``--fuse_steps k`` runs k steps per call of ``make_fused_step``: on the
card one CUDA graph of the k steps (the EMA update included) over a
stacked super-batch.

``--profile_dir`` records a ``torch.profiler`` trace of the whole loop
(obs/profiler.py). ``--plots_dir`` draws the brain-map plots
(obs/plots.py) of the first two StatefulLayers (in the JAX package's
order of their layer paths) after every slow loop that was not skipped,
each into ``<plots_dir>/<layer path with "_" for "/">``
(``text_block_0_stateful``); it defaults to None (the JAX loop's default
is "plots") and raises before the first step where matplotlib cannot be
imported.

  python -m forde_tpu_torch.train.clip_loop --preset vit_b16 --bf16 \\
      --use_dummy_data --dummy_pool 2 --batch_size 128 --num_steps 16 \\
      --sense_interval 8 --slow_loop_interval 8 --fuse_steps 2 \\
      --profile_dir prof --plots_dir plots

Multi-device training: under torchrun every rank builds the global batch
from the seed and keeps its rows (``core.mesh.batch_sharding``) of a data
axis; ``--tensor_parallelism`` splits the towers' attention heads and
StatefulLayer hidden columns over a model axis (parallel/
tensor_parallel.py), and ``--param_sharding fsdp`` shards the parameters
and Adam moments over the data axis (parallel/fsdp.py). The step's loss,
statistics and gradients are the global batch's (train/clip_step.py),
rank 0 logs and writes the checkpoint, and the slow loop runs on every
rank alike. NCCL on the card (a fused step's CUDA graph holds its
collectives), gloo with ``--device cpu``:

  torchrun --standalone --nproc_per_node 4 -m forde_tpu_torch.train.clip_loop \
      --preset vit_b16 --bf16 --use_dummy_data --batch_size 512 --num_steps 16 \
      --tensor_parallelism 2 --param_sharding fsdp

Not ported yet (and not accepted): the streamed Conceptual Captions data
(a tokenizer and data in the repository).
"""

from __future__ import annotations

import argparse
import contextlib
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
    p.add_argument("--tensor_parallelism", type=int, default=1,
                   help="size of the model mesh axis: Megatron column/row layout for tower "
                        "attention + StatefulLayer projections (core/mesh.tp_param_spec)")
    p.add_argument("--param_sharding", choices=["replicated", "fsdp"], default="replicated",
                   help="fsdp = ZeRO-3-style param/moment sharding over the data axis")
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
    p.add_argument("--use_dummy_data", action="store_true", help="synthetic random pairs")
    p.add_argument("--dummy_pool", type=int, default=0,
                   help="with --use_dummy_data: keep this many batches on the "
                        "device and cycle them (0 = fresh host batches)")
    p.add_argument("--use_aligned_data", action="store_true",
                   help="procedurally aligned (image, caption) pairs rendered on the "
                        "device; learnable offline, eval on held-out classes")
    p.add_argument("--aligned_classes", type=int, default=4096)
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="save the train state here (port format)")
    p.add_argument("--resume", action="store_true",
                   help="restore the train state in --checkpoint_dir and go on from its step")
    p.add_argument("--experiment_name", type=str, default="forde_tpu_clip",
                   help="metrics go to runs/<name>_<time>/metrics.jsonl")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--moment_dtype", type=str, default=None,
                   help="Adam moment storage dtype (e.g. bfloat16); update "
                        "math stays fp32")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="> 0 keeps an EMA of the params inside the step (checkpointed; "
                        "the eval also reports EMA retrieval)")
    p.add_argument("--eval_interval", type=int, default=0,
                   help="steps between retrieval evals (0 disables)")
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the training loop here")
    p.add_argument("--plots_dir", type=str, default=None,
                   help="draw the brain-map plots of two layers here after each slow loop "
                        "(needs matplotlib; default: no plots)")
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


def _eval_sets(args, cfg, device) -> dict:
    """{prefix: held-out eval batches} of the retrieval eval, as the JAX
    loop builds them: with aligned data new renders of the training
    classes (``seen_``, sample seed + 2) and the held-out classes
    (``unseen_``, sample seed + 1), each sampled without replacement, in
    the training world (the same seed); with dummy data the first
    ``--eval_batches`` batches of the seed + 1 stream."""
    from forde_tpu_torch.data.vl import (
        AlignedDeviceRenderer,
        AlignedSyntheticVLDataset,
        SyntheticVLDataset,
        hold_out_eval,
    )

    if args.use_aligned_data:
        split = int(args.aligned_classes * 0.9)

        def rendered(lo, hi, sample_seed):
            return list(AlignedDeviceRenderer(AlignedSyntheticVLDataset(
                args.batch_size, args.eval_batches, image_size=cfg.image_size,
                text_len=args.text_len, vocab_size=cfg.vocab_size,
                num_classes=args.aligned_classes, class_range=(lo, hi), seed=args.seed,
                sample_seed=sample_seed, distinct=True,
            ), device).batches())

        return {"seen_": rendered(0, split, args.seed + 2),
                "unseen_": rendered(split, args.aligned_classes, args.seed + 1)}
    held, _ = hold_out_eval(SyntheticVLDataset(
        args.batch_size, args.eval_batches, image_size=cfg.image_size, text_len=args.text_len,
        vocab_size=cfg.vocab_size, seed=args.seed + 1,
    ), args.eval_batches)
    return {"": held}


def train(args: Optional[argparse.Namespace] = None) -> dict:
    """Run the loop; returns {"state", "final_metrics", "step",
    "pairs_per_sec", "brain_updates", "retrieval"}. Each brain update's
    record holds its step, latency, ``skipped``, and the sums of
    |grad_stats| and the sensed step counts just before the update and
    just after; ``retrieval`` holds each eval's step, seconds and
    metrics."""
    from forde_tpu_torch.brain.neuron_slow_loop import neuron_slow_loop_step
    from forde_tpu_torch.data.prefetch import prefetch_to_device
    from forde_tpu_torch.data.vl import (
        AlignedDeviceRenderer,
        AlignedSyntheticVLDataset,
        SyntheticVLDataset,
    )
    from forde_tpu_torch.core import mesh as mesh_lib
    from forde_tpu_torch.nn.stateful import stateful_layers
    from forde_tpu_torch.obs import profiler
    from forde_tpu_torch.obs.metrics import MetricsWriter, NullWriter, ThroughputMeter
    from forde_tpu_torch.obs.plots import require_matplotlib
    from forde_tpu_torch.obs.retrieval import evaluate_retrieval
    from forde_tpu_torch.train import checkpoint as ckpt_lib
    from forde_tpu_torch.train.clip_step import (
        clip_train_step,
        create_clip_train_state,
        make_fused_step,
        make_nosense_step,
        stack_batches,
    )
    from forde_tpu_torch.train.ema import init_ema, swap_in_ema, with_ema
    from forde_tpu_torch.train.state import shard_train_state

    if args is None:
        args = build_parser().parse_args([])
    if not (args.use_dummy_data or args.use_aligned_data):
        raise NotImplementedError(
            "only --use_dummy_data and --use_aligned_data are ported; the streamed Conceptual "
            "Captions pipeline is not (it waits for a tokenizer and data in the repository)"
        )
    if args.plots_dir:
        require_matplotlib()
    device = mesh_lib.local_device(resolve_device(args.device))
    mesh = None
    if mesh_lib.maybe_initialize_distributed(device) or args.tensor_parallelism > 1:
        mesh = mesh_lib.create_mesh_for_batch(args.batch_size, model=args.tensor_parallelism)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    shard = (lambda b: b) if mesh is None else (
        lambda b: {k: v.contiguous() for k, v in mesh_lib.shard_batch(b, mesh).items()})
    cfg = config_from_args(args)
    brain = BrainConfig()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.lr_schedule == "cosine" and args.decay_steps == 0:
        args.decay_steps = max(args.num_steps - args.warmup_steps, 1)
        say(f"cosine decay over {args.decay_steps} steps (derived from the run length)")

    t_init = time.perf_counter()
    state = create_clip_train_state(
        cfg, generator, args.learning_rate, args.weight_decay,
        warmup_steps=args.warmup_steps, moment_dtype=args.moment_dtype,
        lr_schedule=args.lr_schedule, decay_steps=args.decay_steps,
        min_lr_ratio=args.min_lr_ratio, device=device,
    )
    if args.ema_decay > 0:
        init_ema(state)
    n_params = sum(p.numel() for p in state.optimizer.params)
    say(f"state created in {time.perf_counter() - t_init:.1f}s "
        f"({n_params / 1e6:.1f}M params) on {device}", flush=True)
    shard_train_state(state, mesh, args.param_sharding)
    if mesh is not None:
        say(f"mesh: {mesh.shape} over {mesh.size} rank(s)", flush=True)
    train_meta = {
        "moment_dtype": args.moment_dtype, "warmup_steps": args.warmup_steps,
        "ema_decay": args.ema_decay, "lr_schedule": args.lr_schedule,
        "decay_steps": args.decay_steps, "min_lr_ratio": args.min_lr_ratio,
    }
    if args.checkpoint_dir and args.resume:
        ckpt_lib.resume_train_state(args.checkpoint_dir, state)

    nosense_step = make_nosense_step(cfg) if args.sense_interval > 1 else None
    sensed_step = clip_train_step
    if args.ema_decay > 0:
        sensed_step = with_ema(clip_train_step, args.ema_decay)
        if nosense_step is not None:
            nosense_step = with_ema(nosense_step, args.ema_decay)
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
        for name in ("log_interval", "slow_loop_interval", "eval_interval"):
            v = getattr(args, name)
            if v > 0 and v % fuse:
                rounded = ((v + fuse - 1) // fuse) * fuse
                say(f"--{name} {v} -> {rounded} (rounded to a --fuse_steps boundary)")
                setattr(args, name, rounded)
        fused_step = make_fused_step(cfg, fuse, args.sense_interval, sensed_step=sensed_step,
                                     nosense_step=nosense_step)

    writer = (MetricsWriter(f"runs/{args.experiment_name}_{datetime.now():%Y%m%d_%H%M%S}")
              if lead else NullWriter())
    eval_sets = _eval_sets(args, cfg, device) if args.eval_interval > 0 else {}
    stacked_sharding = None if mesh is None else mesh_lib.stacked_batch_sharding(mesh)
    if args.use_aligned_data:
        # Train on classes [0, 0.9 C); the eval's unseen_ classes are the rest.
        batches = AlignedDeviceRenderer(AlignedSyntheticVLDataset(
            args.batch_size, args.num_steps, image_size=cfg.image_size,
            text_len=args.text_len, vocab_size=cfg.vocab_size,
            num_classes=args.aligned_classes,
            class_range=(0, int(args.aligned_classes * 0.9)), seed=args.seed,
        ), device).batches()
        if fused_step is not None:
            batches = (fused_step.prepare(sb)
                       for sb in stack_batches(batches, fuse, sharding=stacked_sharding))
        else:
            batches = (shard(b) for b in batches)
    elif args.dummy_pool:
        dataset = SyntheticVLDataset(
            args.batch_size, args.num_steps, image_size=cfg.image_size,
            text_len=args.text_len, vocab_size=cfg.vocab_size, seed=args.seed,
            pool=args.dummy_pool,
        )
        # Device-resident pool: each distinct batch is copied once, its
        # images in the compute dtype (the model's first op casts them);
        # with --fuse_steps, pre-stacked super-batches.
        pool = []
        for b in itertools.islice(iter(dataset), max(args.dummy_pool, fuse)):
            db = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            db["image"] = db["image"].to(cfg.dtypes.compute)
            pool.append(db)
        if fused_step is not None:
            pool = [fused_step.prepare(sb)
                    for sb in stack_batches(iter(pool), fuse, sharding=stacked_sharding)]
        else:
            pool = [shard(b) for b in pool]
        batches = (pool[i % len(pool)] for i in range(args.num_steps // fuse))
    else:
        batches = prefetch_to_device(iter(SyntheticVLDataset(
            args.batch_size, args.num_steps, image_size=cfg.image_size,
            text_len=args.text_len, vocab_size=cfg.vocab_size, seed=args.seed,
        )), device)
        if fused_step is not None:
            batches = (fused_step.prepare(sb)
                       for sb in stack_batches(batches, fuse, sharding=stacked_sharding))
        else:
            batches = (shard(b) for b in batches)

    def save(step):
        ckpt_lib.save_train_state(args.checkpoint_dir, state, step, train_meta)

    meter = ThroughputMeter(items_per_step=args.batch_size * fuse)
    step, last, brain_updates, retrieval = state.step, {}, [], []
    metrics = None
    preempt = ckpt_lib.preemption_requests() if args.checkpoint_dir else contextlib.nullcontext([])
    try:
        with preempt as stop, profiler.trace(args.profile_dir, device) as traces:
            for batch in batches:
                if stop:
                    break
                if fused_step is not None:
                    # the slow loop and the eval below run only between fused calls
                    state, metrics = fused_step(state, batch)
                    step += fuse
                elif nosense_step is not None and step % args.sense_interval:
                    state, metrics = nosense_step(state, batch)
                    step += 1
                else:
                    state, metrics = sensed_step(state, batch)
                    step += 1
                meter.step()

                if step % args.log_interval == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(last["loss/contrastive"]):
                        raise FloatingPointError(f"non-finite loss at step {step}: {last}")
                    writer.scalars(last, step)
                    pps = meter.items_per_sec
                    writer.scalar("Throughput/pairs_per_sec_per_chip", pps, step)
                    say(f"step {step}: loss {last['loss/contrastive']:.4f} "
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
                        "grad_stats_abs_sum_before": before[0],
                        "grad_stats_abs_sum_after": after[0],
                        "sensed_steps_before": before[1], "sensed_steps_after": after[1],
                    })
                    writer.scalar("SlowLoop/latency_ms", dt_ms, step)
                    mode = "Forde-lite" if cfg.forde_lite else "GMM"
                    say(f"[brain update @ {step}] mode={mode} {dt_ms:.1f}ms"
                        f"{' (skipped: no sensed step)' if skipped else ''}", flush=True)
                    if args.plots_dir and lead and not skipped:
                        _plot(diag, step, args.plots_dir, brain)

                if args.eval_interval > 0 and step % args.eval_interval == 0 and eval_sets:
                    _synchronize(device)
                    t0 = time.perf_counter()
                    rmetrics = {}
                    for prefix, held in eval_sets.items():
                        rmetrics.update(evaluate_retrieval(state, held, prefix=prefix))
                        if args.ema_decay > 0:
                            with swap_in_ema(state):
                                rmetrics.update(evaluate_retrieval(state, held,
                                                                   prefix=f"ema_{prefix}"))
                        say(f"[retrieval/{prefix or 'eval'} @ {step}] i2t R@1 "
                            f"{rmetrics[f'retrieval/{prefix}i2t_recall@1']:.3f} t2i R@1 "
                            f"{rmetrics[f'retrieval/{prefix}t2i_recall@1']:.3f}", flush=True)
                    _synchronize(device)
                    retrieval.append({"step": step, "seconds": time.perf_counter() - t0,
                                      "metrics": rmetrics})
                    writer.scalars(rmetrics, step)

                if args.checkpoint_dir and step % max(args.slow_loop_interval, 100) == 0:
                    save(step)
                if step >= args.num_steps:
                    break

        _synchronize(device)
        if metrics is not None and not last:
            last = {k: float(v) for k, v in metrics.items()}
        if args.checkpoint_dir:
            save(step)
            say(f"checkpoint (train state, step {step}) written to {args.checkpoint_dir}",
                flush=True)
    finally:
        writer.close()
    return {
        "state": state, "final_metrics": last, "step": step,
        "pairs_per_sec": meter.items_per_sec,
        "brain_updates": brain_updates, "retrieval": retrieval, "traces": traces,
        "mesh": mesh,
    }


def plot_layers(names) -> dict:
    """{StatefulLayer module name: its plots' directory name} of the two
    layers the JAX loop plots: the first two by their sorted Flax layer
    paths, each named by its path with "_" for "/"
    (``text.blocks.0.stateful`` -> ``text_block_0_stateful``)."""
    from forde_tpu_torch.interop import flax_keys

    suffix = "/neuron_assignments"
    paths = {name: key[len("brain/"):-len(suffix)] for name, (key, _) in
             flax_keys(f"{n}.neuron_assignments" for n in names).items()}
    chosen = sorted(paths, key=lambda n: tuple(paths[n].split("/")))[:2]
    return {name.removesuffix(".neuron_assignments"): paths[name].replace("/", "_")
            for name in chosen}


def _plot(diag, step: int, plots_dir: str, brain) -> None:
    """The three brain-map plots of two layers after a neuron slow loop,
    as the JAX loop draws them (epoch 0, its feature names and labels)."""
    import os

    from forde_tpu_torch.obs import plots

    for name, tag in plot_layers(diag["layers"]).items():
        d = diag["layers"][name]
        a = d["assignments"].cpu().numpy()
        out = os.path.join(plots_dir, tag)
        plots.plot_brain_scan(plots.grid_of(a), 0, step, out)
        plots.plot_feature_space(d["stats"].cpu().numpy()[:, :2], a, 0, step, out,
                                 feature_names=("grad_gini", "grad_gdp"))
        plots.plot_census(a, 0, step, out, num_clusters=brain.num_clusters,
                          labels={0: "Generalist", 1: "Pooling", 2: "Specialist"})


def main(argv: Optional[list] = None) -> dict:
    from forde_tpu_torch.train.loop import _process_group_up

    started = not _process_group_up()
    try:
        return train(build_parser().parse_args(argv))
    finally:
        if started and _process_group_up():  # the group this run started
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
