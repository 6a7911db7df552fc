"""Training loop and CLI of the FORDE decoder LM (port of
forde_tpu/train/loop.py).

Shifted next-token steps (``train/step.py``), the metrics under the
reference's tags every ``--log_interval`` steps (a non-finite loss
raises), the MoE slow loop every ``--slow_loop_interval`` steps (timed
between two synchronizes), and with ``--checkpoint_dir`` a
``model_config.json`` + ``params.npz`` checkpoint that
``forde_tpu_torch.serve --checkpoint_dir`` serves. Data: seeded random
tokens (``--use_dummy_data``), the learnable Markov stream
(``--use_markov_data``) or a local corpus (``--data_file``: .npy ids or
byte-level text). Runs on CUDA unless ``--device cpu``; with no GPU
visible it raises.

  python -m forde_tpu_torch.train.loop --d_model 512 --num_layers 12 \\
      --num_heads 8 --window_size 512 --num_streams 4 --seq_len 2048 \\
      --batch_size 8 --bf16 --use_markov_data --steps_per_epoch 100 \\
      --slow_loop_interval 50 --checkpoint_dir ckpt
  python -m forde_tpu_torch.train.loop --device cpu --d_model 64 \\
      --num_layers 2 --num_heads 2 --window_size 16 --seq_len 64 \\
      --batch_size 2 --use_dummy_data --steps_per_epoch 4 \\
      --slow_loop_interval 2 --log_interval 2

Flags whose code is not ported raise ``NotImplementedError`` and name the
slice they wait for (ROADMAP.md); ``--plots_dir`` is one of them and
defaults to None, so the loop writes no plots.
"""

from __future__ import annotations

import argparse
import time
from datetime import datetime
from typing import List, Optional

import numpy as np
import torch

from forde_tpu_torch import resolve_device
from forde_tpu_torch.core.config import DTypePolicy, LLMConfig


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's flags (and ``--device``)."""
    p = argparse.ArgumentParser(description="Train the FORDE decoder LM")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps (0 = constant LR)")
    p.add_argument("--lr_schedule", choices=["constant", "cosine"], default="constant",
                   help="post-warmup LR: constant, or cosine decay to "
                        "min_lr_ratio*peak over --decay_steps")
    p.add_argument("--decay_steps", type=int, default=0,
                   help="cosine decay horizon (after warmup); 0 = derive "
                        "from steps_per_epoch*num_epochs - warmup")
    p.add_argument("--min_lr_ratio", type=float, default=0.0,
                   help="cosine floor as a fraction of the peak LR")
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--aux_loss_weight", type=float, default=0.01, help="MoE aux loss weight")
    p.add_argument("--grad_accum", type=int, default=1, help="(not ported beyond 1)")
    # model shape
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_experts", type=int, default=8)
    p.add_argument("--top_k_experts", type=int, default=2)
    p.add_argument("--window_size", type=int, default=128)
    p.add_argument("--num_streams", type=int, default=2)
    p.add_argument("--no_moe", action="store_true")
    p.add_argument("--no_nsa", action="store_true")
    p.add_argument("--no_mhc", action="store_true")
    # data
    p.add_argument("--use_dummy_data", action="store_true")
    p.add_argument("--data_file", type=str, default=None,
                   help="a local corpus: .npy token ids or raw text (byte-level "
                        "ids 0..255); packed seq_len windows, reshuffled per epoch")
    p.add_argument("--tokenizer", choices=["byte", "gpt2"], default="byte",
                   help="tokenization of a text --data_file (gpt2: not ported)")
    p.add_argument("--use_markov_data", action="store_true",
                   help="structured synthetic data with a known entropy floor")
    p.add_argument("--markov_active_vocab", type=int, default=8192)
    p.add_argument("--markov_p", type=float, default=0.85)
    # loop
    p.add_argument("--slow_loop_interval", type=int, default=100,
                   help="0 disables the brain update")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--checkpoint_interval", type=int, default=0,
                   help="steps between checkpoints; 0 = final only")
    p.add_argument("--resume", action="store_true", help="(not ported)")
    p.add_argument("--experiment_name", type=str, default="forde_tpu_llm",
                   help="metrics go to runs/<name>_<time>/metrics.jsonl")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--moe_dispatch", choices=["dense", "capacity", "ep"], default="dense",
                   help='"ep" (expert parallelism over a mesh) is not ported')
    p.add_argument("--moment_dtype", type=str, default=None,
                   help="Adam moment storage dtype (e.g. bfloat16); update math stays fp32")
    p.add_argument("--ema_decay", type=float, default=0.0, help="(not ported)")
    p.add_argument("--distill_from", type=str, default=None, help="(not ported)")
    p.add_argument("--distill_alpha", type=float, default=0.5)
    p.add_argument("--distill_temperature", type=float, default=2.0)
    p.add_argument("--init_from", type=str, default=None, help="(not ported)")
    p.add_argument("--lora_rank", type=int, default=0, help="(not ported)")
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--lora_targets", type=str, default=None, help="(not ported)")
    p.add_argument("--remat", action="store_true", help="(not ported)")
    p.add_argument("--scan_layers", action="store_true", help="(not ported)")
    p.add_argument("--expert_parallelism", type=int, default=1, help="(not ported beyond 1)")
    p.add_argument("--context_parallelism", type=int, default=1, help="(not ported beyond 1)")
    p.add_argument("--param_sharding", choices=["replicated", "fsdp"], default="replicated",
                   help="fsdp: not ported")
    p.add_argument("--pipeline_parallelism", type=int, default=1, help="(not ported beyond 1)")
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--tensor_parallelism", type=int, default=1, help="(not ported beyond 1)")
    p.add_argument("--profile_dir", type=str, default=None, help="(not ported)")
    p.add_argument("--plots_dir", type=str, default=None,
                   help="(not ported: the brain-map plots of obs/plots.py)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def config_from_args(args) -> LLMConfig:
    """The JAX package's derivation of the model config from the shape
    flags (vocab 50,257, experts 4 * d_model wide, head_dim = d_model //
    num_heads, at least 1,024 positions); the serve CLI uses it too."""
    return LLMConfig(
        vocab_size=50257,
        d_model=args.d_model,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        head_dim=args.d_model // args.num_heads,
        max_seq_len=max(args.seq_len, 1024),
        use_moe=not args.no_moe,
        num_experts=args.num_experts,
        top_k_experts=args.top_k_experts,
        expert_hidden_dim=4 * args.d_model,
        use_sparse_attention=not args.no_nsa,
        window_size=args.window_size,
        use_hyper_connections=not args.no_mhc,
        num_streams=args.num_streams,
        moe_dispatch=args.moe_dispatch,
        remat=False,
        scan_layers=False,
        dropout_rate=0.0,
        dtypes=DTypePolicy.bf16() if args.bf16 else DTypePolicy.fp32(),
    )


EXTRAS = "training extras (slice 6)"
MULTI = "multi-device (slice 7)"
TOKENIZER = "a tokenizer and data in the repository"
_NOT_PORTED = (
    (lambda a: a.ema_decay > 0, "--ema_decay", EXTRAS),
    (lambda a: a.distill_from, "--distill_from", EXTRAS),
    (lambda a: a.init_from, "--init_from", EXTRAS),
    (lambda a: a.lora_rank > 0 or a.lora_targets, "--lora_rank / --lora_targets", EXTRAS),
    (lambda a: a.grad_accum > 1, "--grad_accum > 1", EXTRAS),
    (lambda a: a.resume, "--resume", EXTRAS),
    (lambda a: a.remat, "--remat", EXTRAS),
    (lambda a: a.scan_layers, "--scan_layers", EXTRAS),
    (lambda a: a.profile_dir, "--profile_dir", EXTRAS),
    (lambda a: a.plots_dir, "--plots_dir", EXTRAS),
    (lambda a: a.moe_dispatch == "ep", "--moe_dispatch ep", MULTI),
    (lambda a: a.expert_parallelism > 1, "--expert_parallelism > 1", MULTI),
    (lambda a: a.context_parallelism > 1, "--context_parallelism > 1", MULTI),
    (lambda a: a.tensor_parallelism > 1, "--tensor_parallelism > 1", MULTI),
    (lambda a: a.pipeline_parallelism > 1, "--pipeline_parallelism > 1", MULTI),
    (lambda a: a.param_sharding == "fsdp", "--param_sharding fsdp", MULTI),
    (lambda a: a.data_file and a.tokenizer == "gpt2", "--tokenizer gpt2", TOKENIZER),
    (lambda a: not (a.data_file or a.use_markov_data or a.use_dummy_data),
     "the streamed corpus (no --data_file, --use_markov_data or --use_dummy_data)", TOKENIZER),
)


def _refuse_unported(args) -> None:
    for given, flag, slice_name in _NOT_PORTED:
        if given(args):
            raise NotImplementedError(
                f"{flag} is not ported to forde_tpu_torch yet (it waits for {slice_name}; "
                "see ROADMAP.md)"
            )


def _dataset(args, config: LLMConfig):
    from forde_tpu_torch.data import lm

    num_batches = args.steps_per_epoch * args.num_epochs
    if args.data_file:
        dataset = lm.create_text_file_dataset(
            args.data_file, args.batch_size, args.seq_len, num_batches=num_batches,
            tokenizer=args.tokenizer, seed=args.seed,
        )
        if dataset.vocab_hint > config.vocab_size:
            raise ValueError(f"{args.data_file} has ids up to {dataset.vocab_hint - 1} "
                             f">= model vocab {config.vocab_size}")
        print(f"local corpus {args.data_file}: {len(dataset.windows):,} windows of "
              f"{args.seq_len} tokens ({args.tokenizer} tokenization)")
        return dataset
    if args.use_markov_data:
        dataset = lm.create_markov_dataset(
            args.batch_size, args.seq_len, config.vocab_size, num_batches=num_batches,
            active_vocab=args.markov_active_vocab, p=args.markov_p, seed=args.seed,
        )
        print(f"markov data: active_vocab {dataset.active_vocab} p {dataset.p} unigram "
              f"floor {np.log(dataset.active_vocab):.3f} nats, perfect-model floor "
              f"{dataset.entropy_floor():.3f} nats")
        return dataset
    return lm.create_dummy_dataset(args.batch_size, args.seq_len, config.vocab_size,
                                   num_batches=num_batches)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _save(args, config, state, step: int) -> None:
    from forde_tpu_torch.interop import flatten, state_dict_to_flax
    from forde_tpu_torch.train.checkpoint import save_params

    save_params(
        args.checkpoint_dir, config,
        flatten(state_dict_to_flax(state.model.state_dict())),
        {"step": step, "moment_dtype": args.moment_dtype, "warmup_steps": args.warmup_steps,
         "ema_decay": args.ema_decay, "lr_schedule": args.lr_schedule,
         "decay_steps": args.decay_steps, "min_lr_ratio": args.min_lr_ratio},
    )


def train(args: Optional[argparse.Namespace] = None) -> dict:
    """Run the loop; returns {"state", "final_metrics", "step",
    "tokens_per_sec", "brain_updates"}. Each brain update's record holds
    its step, latency, ``skipped``, load imbalance, relative routing
    entropy and the number of router biases it moved."""
    from forde_tpu_torch.brain.slow_loop import moe_slow_loop_step
    from forde_tpu_torch.core.config import BrainConfig
    from forde_tpu_torch.data.prefetch import prefetch_to_device
    from forde_tpu_torch.obs.metrics import REFERENCE_TAGS, MetricsWriter, ThroughputMeter
    from forde_tpu_torch.train.state import create_train_state
    from forde_tpu_torch.train.step import train_step

    if args is None:
        args = build_parser().parse_args([])
    _refuse_unported(args)
    device = resolve_device(args.device)
    config = config_from_args(args)
    brain = BrainConfig()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.lr_schedule == "cosine" and args.decay_steps == 0:
        args.decay_steps = max(args.steps_per_epoch * args.num_epochs - args.warmup_steps, 1)
        print(f"cosine decay over {args.decay_steps} steps (derived from the run length)")

    t_init = time.perf_counter()
    state = create_train_state(
        config, generator, args.learning_rate, args.weight_decay,
        warmup_steps=args.warmup_steps, moment_dtype=args.moment_dtype,
        lr_schedule=args.lr_schedule, decay_steps=args.decay_steps,
        min_lr_ratio=args.min_lr_ratio, device=device,
    )
    n_params = sum(p.numel() for p in state.optimizer.params)
    print(f"state created in {time.perf_counter() - t_init:.1f}s "
          f"({n_params / 1e6:.1f}M params) on {device}", flush=True)
    dataset = _dataset(args, config)
    writer = MetricsWriter(f"runs/{args.experiment_name}_{datetime.now():%Y%m%d_%H%M%S}")
    meter = ThroughputMeter(items_per_step=args.batch_size * args.seq_len)
    step, last, brain_updates = 0, {}, []
    metrics = None
    try:
        for epoch in range(args.num_epochs):
            for batch in prefetch_to_device(iter(dataset), device):
                state, metrics = train_step(state, batch, aux_loss_weight=args.aux_loss_weight)
                step += 1
                meter.step()

                if step % args.log_interval == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(last["loss/total"]):
                        raise FloatingPointError(f"non-finite loss at step {step}: {last}")
                    writer.scalars({REFERENCE_TAGS.get(k, k): v for k, v in last.items()}, step)
                    tps = meter.items_per_sec
                    writer.scalar("Throughput/tokens_per_sec_per_chip", tps, step)
                    print(f"epoch {epoch} step {step}: loss {last['loss/total']:.4f} "
                          f"(lm {last['loss/lm']:.4f} aux {last['loss/aux']:.4f}) "
                          f"grad_norm {last['training/grad_norm']:.2f} {tps:,.0f} tok/s/chip",
                          flush=True)

                if config.use_moe and args.slow_loop_interval > 0 and (
                    step % args.slow_loop_interval == 0
                ):
                    _synchronize(device)  # the latency is the update's own
                    t0 = time.perf_counter()
                    diag = moe_slow_loop_step(state.model, config, generator, epoch=epoch,
                                              step=step, brain=brain, verbose=True)
                    _synchronize(device)
                    dt_ms = (time.perf_counter() - t0) * 1000
                    record = {"step": step, "latency_ms": dt_ms,
                              "skipped": bool(diag["skipped"]),
                              "load_imbalance": float(diag["load_imbalance"]),
                              "routing_entropy": float(diag["routing_entropy"]),
                              "updates_count": int(diag["updates_count"])}
                    brain_updates.append(record)
                    writer.scalars({f"SlowLoop/{k}": record[k] for k in
                                    ("latency_ms", "load_imbalance", "routing_entropy")}, step)

                if args.checkpoint_dir and args.checkpoint_interval > 0 and (
                    step % args.checkpoint_interval == 0
                ):
                    _save(args, config, state, step)

                if step >= args.steps_per_epoch * (epoch + 1):
                    break
        _synchronize(device)
        if metrics is not None and not last:
            last = {k: float(v) for k, v in metrics.items()}
        if args.checkpoint_dir:
            _save(args, config, state, step)
            print(f"checkpoint (step {step}) written to {args.checkpoint_dir}")
    finally:
        writer.close()
    return {"state": state, "final_metrics": last, "step": step,
            "tokens_per_sec": meter.items_per_sec, "brain_updates": brain_updates}


def main(argv: Optional[List[str]] = None) -> dict:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
