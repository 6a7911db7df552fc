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

The training extras: ``--ema_decay`` keeps an EMA of the trained tensors
(train/ema.py, checkpointed as ``ema_params``); ``--grad_accum N`` takes
each step from N microbatches; ``--init_from`` warm-starts from a
checkpoint (its config, a fresh optimizer), and with ``--lora_rank`` trains
LoRA adapters over that frozen base (train/lora.py); ``--distill_from``
trains against a teacher checkpoint's logits (train/distill.py). With
``--checkpoint_dir`` each save holds the whole train state
(``save_train_state``: params, EMA, stat buffers, Adam, the step);
``--resume`` restores it and goes on from its step (the data iterator
starts again from the top, as in the JAX package), and SIGTERM/SIGINT stop
the run at the next step boundary, save, and exit 0.

  python -m forde_tpu_torch.train.loop --device cpu --d_model 64 \\
      --num_layers 2 --num_heads 2 --window_size 16 --seq_len 64 \\
      --batch_size 4 --use_markov_data --steps_per_epoch 4 --grad_accum 2 \\
      --ema_decay 0.99 --slow_loop_interval 2 --checkpoint_dir ckpt --resume

The training extras' second part: ``--remat`` recomputes each block's
activations in the backward (nn/remat.py; the stat buffers still count
each forward once); ``--scan_layers`` writes every checkpoint in the JAX
package's scanned layout (``layers/block/...`` with a leading (L,) axis;
the model itself stays unrolled); ``--profile_dir`` records a
``torch.profiler`` trace of the whole loop (obs/profiler.py);
``--plots_dir`` draws the brain-map plots (obs/plots.py) after every slow
loop that was not skipped. ``--plots_dir`` defaults to None (the JAX
loop's default is "plots"), and where matplotlib cannot be imported it
raises before the first step.

  python -m forde_tpu_torch.train.loop --d_model 512 --num_layers 12 \\
      --num_heads 8 --window_size 512 --num_streams 4 --seq_len 8192 \\
      --batch_size 4 --bf16 --remat --scan_layers --use_markov_data \\
      --steps_per_epoch 100 --profile_dir prof --plots_dir plots

Multi-device training: under torchrun each rank builds the global batch
from the seed and takes its part (``train.step.lm_batch``) of a mesh
(core/mesh.py) of (data, expert, context, model, pipe):
``--expert_parallelism`` splits the expert banks (``--moe_dispatch ep``:
the all-to-all or psum dispatch of parallel/expert_parallel.py; dense and
capacity dispatch run as its psum variant), ``--context_parallelism``
splits the sequence (ring attention, or NSA's context-parallel branches),
``--tensor_parallelism`` splits the Megatron layers (heads, hidden
columns, the vocabulary where it divides; parallel/tensor_parallel.py),
``--pipeline_parallelism`` runs GPipe stages over the layers with
``--pp_microbatches`` (parallel/pipeline.py; with ``--scan_layers``, data
parallelism only, as in the JAX loop), ``--param_sharding fsdp`` shards
the parameters and moments over the data axis (parallel/fsdp.py), and data
absorbs the other ranks. NCCL on the card, gloo with ``--device cpu``;
rank 0 logs and writes the checkpoint, in the JAX package's layout, which
a run of another layout or world size resumes.

  torchrun --standalone --nproc_per_node 4 -m forde_tpu_torch.train.loop \
      --d_model 512 --num_layers 12 --num_heads 8 --window_size 512 \
      --num_streams 4 --seq_len 8192 --batch_size 2 --context_parallelism 2 \
      --use_markov_data --steps_per_epoch 100
  torchrun --standalone --nproc_per_node 4 -m forde_tpu_torch.train.loop \
      --device cpu --d_model 64 --num_layers 2 --num_heads 2 --window_size 16 \
      --seq_len 64 --batch_size 4 --expert_parallelism 2 --moe_dispatch ep \
      --use_markov_data --steps_per_epoch 4
  torchrun --standalone --nproc_per_node 4 -m forde_tpu_torch.train.loop \
      --device cpu --d_model 64 --num_layers 2 --num_heads 2 --window_size 16 \
      --seq_len 64 --batch_size 4 --tensor_parallelism 2 --param_sharding fsdp \
      --use_markov_data --steps_per_epoch 4

Flags whose code is not ported (the gpt2 tokenizer and the streamed
corpus) raise ``NotImplementedError`` and name what they wait for
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
import contextlib
import os
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
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step (must divide batch_size)")
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
    p.add_argument("--resume", action="store_true",
                   help="restore the train state in --checkpoint_dir and go on from its step")
    p.add_argument("--experiment_name", type=str, default="forde_tpu_llm",
                   help="metrics go to runs/<name>_<time>/metrics.jsonl")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--moe_dispatch", choices=["dense", "capacity", "ep"], default="dense",
                   help='"ep": explicit expert parallelism (all-to-all) over the mesh\'s '
                        'expert axis; needs --expert_parallelism > 1')
    p.add_argument("--moment_dtype", type=str, default=None,
                   help="Adam moment storage dtype (e.g. bfloat16); update math stays fp32")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="> 0 keeps an EMA of the trained params (checkpointed as ema_params)")
    p.add_argument("--distill_from", type=str, default=None,
                   help="teacher checkpoint: train against its logits (train/distill.py)")
    p.add_argument("--distill_alpha", type=float, default=0.5)
    p.add_argument("--distill_temperature", type=float, default=2.0)
    p.add_argument("--init_from", type=str, default=None,
                   help="warm start: config and params from this checkpoint, fresh optimizer")
    p.add_argument("--lora_rank", type=int, default=0,
                   help="> 0 trains LoRA adapters of this rank over the frozen --init_from base")
    p.add_argument("--lora_alpha", type=float, default=16.0, help="LoRA scale = alpha / rank")
    p.add_argument("--lora_targets", type=str, default=None,
                   help="comma-separated module/param names to adapt (default: "
                        "qkv_proj,out_proj,q_proj,k_proj,v_proj; add w_up,w_down for the "
                        "MoE expert banks)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each decoder block's activations in the backward")
    p.add_argument("--scan_layers", action="store_true",
                   help="checkpoints in the scanned layout (layers/block/... with a leading "
                        "(L,) axis), as the JAX package's --scan_layers writes them")
    p.add_argument("--expert_parallelism", type=int, default=1,
                   help="mesh expert-axis size (shards the stacked MoE experts)")
    p.add_argument("--context_parallelism", type=int, default=1,
                   help="mesh context-axis size (sequence sharding: ring attention, or "
                        "NSA's context-parallel branches)")
    p.add_argument("--param_sharding", choices=["replicated", "fsdp"], default="replicated",
                   help="fsdp: shard each param/moment's largest free dim over the data axis "
                        "(ZeRO-3: per-rank param + optimizer memory falls ~data-fold)")
    p.add_argument("--pipeline_parallelism", type=int, default=1,
                   help="mesh pipe-axis size: GPipe stages over the layers (needs "
                        "--scan_layers)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="GPipe microbatches per step (0 = 2 * pipeline_parallelism)")
    p.add_argument("--tensor_parallelism", type=int, default=1,
                   help="mesh model-axis size: Megatron tensor parallelism (core/mesh.py "
                        "tp_param_spec)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the training loop here")
    p.add_argument("--plots_dir", type=str, default=None,
                   help="draw the brain-map plots here after each slow loop (needs "
                        "matplotlib; default: no plots)")
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
        # serve's flags have neither (its random-init model is unrolled)
        remat=getattr(args, "remat", False),
        scan_layers=getattr(args, "scan_layers", False),
        dropout_rate=0.0,
        dtypes=DTypePolicy.bf16() if args.bf16 else DTypePolicy.fp32(),
    )


TOKENIZER = "a tokenizer and data in the repository"
_NOT_PORTED = (
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


def _dataset(args, config: LLMConfig, say=print):
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
        say(f"local corpus {args.data_file}: {len(dataset.windows):,} windows of "
            f"{args.seq_len} tokens ({args.tokenizer} tokenization)")
        return dataset
    if args.use_markov_data:
        dataset = lm.create_markov_dataset(
            args.batch_size, args.seq_len, config.vocab_size, num_batches=num_batches,
            active_vocab=args.markov_active_vocab, p=args.markov_p, seed=args.seed,
        )
        say(f"markov data: active_vocab {dataset.active_vocab} p {dataset.p} unigram "
            f"floor {np.log(dataset.active_vocab):.3f} nats, perfect-model floor "
            f"{dataset.entropy_floor():.3f} nats")
        return dataset
    return lm.create_dummy_dataset(args.batch_size, args.seq_len, config.vocab_size,
                                   num_batches=num_batches)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_meta(args) -> dict:
    """What the checkpoint records of the run (the JAX package's train
    meta): the optimizer's shape, the EMA and a LoRA run's adapters."""
    meta = {"moment_dtype": args.moment_dtype, "warmup_steps": args.warmup_steps,
            "ema_decay": args.ema_decay, "lr_schedule": args.lr_schedule,
            "decay_steps": args.decay_steps, "min_lr_ratio": args.min_lr_ratio}
    if args.lora_rank:
        from forde_tpu_torch.train.lora import parse_targets

        # the saved params ARE the adapters; serving merges them into the
        # base recorded here (checkpoint.load_lm_params)
        meta["lora"] = {"rank": args.lora_rank, "alpha": args.lora_alpha,
                        "targets": list(parse_targets(args.lora_targets)),
                        "base": os.path.abspath(args.init_from)}
    return meta


def _check_extras(args, config: LLMConfig) -> int:
    """The JAX loop's refusals of flag combinations it does not compose;
    returns the batch the mesh's data axis must divide (one microbatch
    under ``--grad_accum``)."""
    if args.lora_rank:
        if not args.init_from:
            raise ValueError("--lora_rank requires --init_from (LoRA fine-tunes a frozen base "
                             "checkpoint)")
        for given, name in ((args.distill_from, "--distill_from"),
                            (args.grad_accum > 1, "--grad_accum"),
                            (args.pipeline_parallelism > 1, "--pipeline_parallelism"),
                            (args.moe_dispatch == "ep", "--moe_dispatch ep"),
                            (args.context_parallelism > 1, "--context_parallelism"),
                            (args.tensor_parallelism > 1, "--tensor_parallelism"),
                            (args.param_sharding != "replicated", "--param_sharding fsdp")):
            if given:
                raise ValueError(f"--lora_rank does not compose with {name} yet (data "
                                 "parallelism composes)")
        if args.slow_loop_interval > 0 and config.use_moe:
            raise ValueError(
                "--lora_rank needs --slow_loop_interval 0: the brain update actuates router "
                "biases in the FROZEN base, which would drift it away from the checkpoint the "
                "serving merge reloads")
    if args.context_parallelism > 1 and not args.no_nsa:
        # NSA under CP needs the window to fit within one shard boundary
        # (the halo exchange, parallel/nsa_context.py) and ratio-aligned shards.
        per_shard = args.seq_len // args.context_parallelism
        if per_shard < args.window_size - 1:
            raise ValueError(
                f"--context_parallelism {args.context_parallelism} puts {per_shard} tokens per "
                f"shard < window_size-1 ({args.window_size - 1}); use fewer context shards")
    if args.context_parallelism > 1 and args.seq_len % args.context_parallelism:
        raise ValueError(f"--seq_len {args.seq_len} must divide by --context_parallelism "
                         f"{args.context_parallelism}")
    if args.moe_dispatch == "ep" and args.expert_parallelism <= 1:
        raise ValueError("--moe_dispatch ep requires --expert_parallelism > 1")
    pp = args.pipeline_parallelism
    mesh_batch = args.batch_size
    if pp > 1:
        if not args.scan_layers:
            raise ValueError("--pipeline_parallelism requires --scan_layers (the stacked layout "
                             "IS the stage slicing)")
        if args.num_layers % pp:
            raise ValueError(f"--pipeline_parallelism {pp} must divide --num_layers "
                             f"{args.num_layers}")
        mb = args.pp_microbatches or 2 * pp
        if args.batch_size % mb:
            raise ValueError(f"pp microbatches {mb} must divide --batch_size {args.batch_size}")
        # The pipeline composes with DP only (microbatch examples shard over
        # 'data'); the stages run their blocks un-meshed, as in the JAX loop.
        if args.moe_dispatch == "ep":
            raise ValueError("--pipeline_parallelism does not compose with --moe_dispatch ep "
                             "yet (stages run un-meshed); use dense/capacity dispatch")
        if args.context_parallelism > 1 or args.tensor_parallelism > 1:
            raise ValueError("--pipeline_parallelism composes with data parallelism only for "
                             "now — set --context_parallelism/--tensor_parallelism to 1")
        if args.distill_from:
            raise ValueError("--distill_from does not compose with --pipeline_parallelism yet "
                             "(the GPipe step has no teacher-forward slot)")
        mesh_batch = args.batch_size // mb  # the data axis splits ONE microbatch
    if args.grad_accum > 1:
        if pp > 1:
            raise ValueError("--grad_accum does not compose with --pipeline_parallelism (GPipe "
                             "already microbatches); use --pp_microbatches")
        if args.batch_size % args.grad_accum:
            raise ValueError(f"--grad_accum {args.grad_accum} must divide --batch_size "
                             f"{args.batch_size}")
        # the data axis shards ONE microbatch at a time
        mesh_batch = args.batch_size // args.grad_accum
    if args.distill_from and args.grad_accum > 1:
        raise ValueError("--distill_from does not compose with --grad_accum yet")
    return mesh_batch


def _mesh(args, mesh_batch: int, device: torch.device):
    """The run's mesh under torchrun (its process group started here), or
    None for one process with every axis at 1, exactly as before."""
    from forde_tpu_torch.core import mesh as mesh_lib

    distributed = mesh_lib.maybe_initialize_distributed(device)
    axes = dict(expert=args.expert_parallelism, context=args.context_parallelism,
                model=args.tensor_parallelism, pipe=args.pipeline_parallelism)
    if not distributed and all(v == 1 for v in axes.values()):
        return None
    mesh = mesh_lib.create_mesh_for_batch(mesh_batch, **axes)
    if mesh.rank == 0:
        print(f"mesh: {mesh.shape} over {mesh.size} rank(s)", flush=True)
    return mesh


def _zero_stats(model: torch.nn.Module) -> None:
    """The MoE stat buffers of a fresh state (a warm start keeps the base's
    params only, as the JAX loop does)."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("expert_usage", "step_count")):
                buf.zero_()


def _step_fn(args, state, device):
    """The step the flags choose: the GPipe step, LoRA, distillation,
    accumulation or the plain step, wrapped last by the EMA (as the JAX
    loop orders them)."""
    from forde_tpu_torch.train.step import make_accum_train_step, train_step

    if args.pipeline_parallelism > 1:
        from forde_tpu_torch.parallel.pipeline import make_pp_train_step

        step_fn = make_pp_train_step(state.mesh, _microbatches(args),
                                     aux_loss_weight=args.aux_loss_weight)
    elif args.lora_rank:
        from forde_tpu_torch.train.lora import lora_scale, make_lora_train_step

        step_fn = make_lora_train_step(lora_scale(args.lora_rank, args.lora_alpha),
                                       aux_loss_weight=args.aux_loss_weight)
    elif args.distill_from:
        from forde_tpu_torch.train.distill import load_teacher, make_distill_step

        teacher = load_teacher(args.distill_from, device, mesh=state.mesh)
        if teacher.config.vocab_size != state.model.config.vocab_size:
            raise ValueError("teacher/student vocab mismatch")
        print(f"distilling from {args.distill_from} "
              f"(alpha={args.distill_alpha}, T={args.distill_temperature})")
        step_fn = make_distill_step(teacher, aux_loss_weight=args.aux_loss_weight,
                                    alpha=args.distill_alpha,
                                    temperature=args.distill_temperature)
    elif args.grad_accum > 1:
        step_fn = make_accum_train_step(args.grad_accum, aux_loss_weight=args.aux_loss_weight)
    else:
        def step_fn(state, batch):
            return train_step(state, batch, aux_loss_weight=args.aux_loss_weight)
    if args.ema_decay > 0:
        from forde_tpu_torch.train.ema import with_ema

        step_fn = with_ema(step_fn, args.ema_decay)
    return step_fn


def _microbatches(args) -> int:
    """The batch's split: GPipe microbatches, or --grad_accum's."""
    if args.pipeline_parallelism > 1:
        return args.pp_microbatches or 2 * args.pipeline_parallelism
    return args.grad_accum


def train(args: Optional[argparse.Namespace] = None) -> dict:
    """Run the loop; returns {"state", "final_metrics", "step",
    "tokens_per_sec", "brain_updates"}. Each brain update's record holds
    its step, latency, ``skipped``, load imbalance, relative routing
    entropy and the number of router biases it moved."""
    from forde_tpu_torch.brain.slow_loop import moe_slow_loop_step
    from forde_tpu_torch.core.config import BrainConfig
    from forde_tpu_torch.data.prefetch import prefetch_to_device
    from forde_tpu_torch.obs import profiler
    from forde_tpu_torch.core.mesh import local_device
    from forde_tpu_torch.obs.metrics import (
        REFERENCE_TAGS,
        MetricsWriter,
        NullWriter,
        ThroughputMeter,
    )
    from forde_tpu_torch.obs.plots import require_matplotlib
    from forde_tpu_torch.train import checkpoint as ckpt_lib
    from forde_tpu_torch.train.state import create_train_state, shard_train_state
    from forde_tpu_torch.train.step import lm_batch

    if args is None:
        args = build_parser().parse_args([])
    _refuse_unported(args)
    if args.plots_dir:
        require_matplotlib()
    device = local_device(resolve_device(args.device))
    config = config_from_args(args)
    mesh_batch = _check_extras(args, config)
    mesh = _mesh(args, mesh_batch, device)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    base = None
    if args.init_from:
        # the checkpoint's layout (scan_layers) is the architecture; remat
        # is the one knob kept from the command line
        config, base = ckpt_lib.load_lm_params(args.init_from, device, mesh=mesh)
        config = config.replace(dropout_rate=0.0, remat=args.remat)
        base.config = base.config.replace(remat=args.remat)
        say(f"config loaded from {args.init_from}/model_config.json (CLI shape flags "
            f"ignored; scan_layers={config.scan_layers})")
        if args.seq_len > config.max_seq_len:
            raise ValueError(f"--seq_len {args.seq_len} exceeds the base model's max_seq_len "
                             f"{config.max_seq_len}")
    brain = BrainConfig()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.lr_schedule == "cosine" and args.decay_steps == 0:
        args.decay_steps = max(args.steps_per_epoch * args.num_epochs - args.warmup_steps, 1)
        say(f"cosine decay over {args.decay_steps} steps (derived from the run length)")

    t_init = time.perf_counter()
    if base is not None:
        base.train()
        _zero_stats(base)
    state = create_train_state(
        config, generator, args.learning_rate, args.weight_decay,
        warmup_steps=args.warmup_steps, moment_dtype=args.moment_dtype,
        lr_schedule=args.lr_schedule, decay_steps=args.decay_steps,
        min_lr_ratio=args.min_lr_ratio, device=device, model=base, mesh=mesh,
    )
    if args.lora_rank:
        from forde_tpu_torch.train import lora as lora_lib

        state = lora_lib.create_lora_train_state(
            state, args.lora_rank, generator, targets=lora_lib.parse_targets(args.lora_targets))
        n_adapt = lora_lib.adapter_param_count(state.lora)
        n_base = sum(p.numel() for p in state.model.parameters())
        say(f"LoRA rank {args.lora_rank}: {n_adapt:,} trainable adapter params over a frozen "
            f"{n_base:,}-param base ({100 * n_adapt / n_base:.2f}%)")
    elif base is not None:
        say(f"warm-started params from {args.init_from} (fresh optimizer, step 0)")
    if args.ema_decay > 0:
        from forde_tpu_torch.train.ema import init_ema

        init_ema(state)
    n_params = sum(p.numel() for p in state.optimizer.params)
    say(f"state created in {time.perf_counter() - t_init:.1f}s "
        f"({n_params / 1e6:.1f}M params) on {device}", flush=True)
    shard_train_state(state, mesh, args.param_sharding)
    train_meta = _train_meta(args)
    if args.checkpoint_dir and args.resume:
        ckpt_lib.resume_train_state(args.checkpoint_dir, state)
    step_fn = _step_fn(args, state, device)

    def save(step):
        ckpt_lib.save_train_state(args.checkpoint_dir, state, step, train_meta)

    dataset = _dataset(args, config, say)
    writer = (MetricsWriter(f"runs/{args.experiment_name}_{datetime.now():%Y%m%d_%H%M%S}")
              if lead else NullWriter())
    meter = ThroughputMeter(items_per_step=args.batch_size * args.seq_len)
    step, last, brain_updates = state.step, {}, []
    metrics = None
    preempt = ckpt_lib.preemption_requests() if args.checkpoint_dir else contextlib.nullcontext([])
    try:
        with preempt as stop, profiler.trace(args.profile_dir, device) as traces:
            for epoch in range(args.num_epochs):
                if stop:
                    break
                for batch in prefetch_to_device(iter(dataset), device):
                    if stop:
                        break
                    if mesh is not None:  # this rank's part of the global batch
                        batch = lm_batch(batch["input_ids"], mesh, _microbatches(args))
                    state, metrics = step_fn(state, batch)
                    step += 1
                    meter.step()

                    if step % args.log_interval == 0:
                        last = {k: float(v) for k, v in metrics.items()}
                        if not np.isfinite(last["loss/total"]):
                            raise FloatingPointError(f"non-finite loss at step {step}: {last}")
                        writer.scalars({REFERENCE_TAGS.get(k, k): v for k, v in last.items()},
                                       step)
                        tps = meter.items_per_sec
                        writer.scalar("Throughput/tokens_per_sec_per_chip", tps, step)
                        say(f"epoch {epoch} step {step}: loss {last['loss/total']:.4f} "
                            f"(lm {last['loss/lm']:.4f} aux {last['loss/aux']:.4f}) "
                            f"grad_norm {last['training/grad_norm']:.2f} {tps:,.0f} "
                            "tok/s/chip", flush=True)

                    if config.use_moe and args.slow_loop_interval > 0 and (
                        step % args.slow_loop_interval == 0
                    ):
                        _synchronize(device)  # the latency is the update's own
                        t0 = time.perf_counter()
                        # every rank runs it on the same reduced statistics with the
                        # same generator, so the router biases stay equal
                        diag = moe_slow_loop_step(state.model, config, generator, epoch=epoch,
                                                  step=step, brain=brain, verbose=lead)
                        _synchronize(device)
                        dt_ms = (time.perf_counter() - t0) * 1000
                        record = {"step": step, "latency_ms": dt_ms,
                                  "skipped": bool(diag["skipped"]),
                                  "load_imbalance": float(diag["load_imbalance"]),
                                  "routing_entropy": float(diag["routing_entropy"]),
                                  "updates_count": int(diag["updates_count"])}
                        brain_updates.append(record)
                        writer.scalars({f"SlowLoop/{k}": record[k] for k in
                                        ("latency_ms", "load_imbalance", "routing_entropy")},
                                       step)
                        if args.plots_dir and lead and not record["skipped"]:
                            _plot(diag, epoch, step, args.plots_dir, brain)

                    if args.checkpoint_dir and args.checkpoint_interval > 0 and (
                        step % args.checkpoint_interval == 0
                    ):
                        save(step)

                    if step >= args.steps_per_epoch * (epoch + 1):
                        break
        _synchronize(device)
        if metrics is not None and not last:
            last = {k: float(v) for k, v in metrics.items()}
        if args.checkpoint_dir:
            save(step)
            say(f"checkpoint (step {step}) written to {args.checkpoint_dir}", flush=True)
    finally:
        writer.close()
    return {"state": state, "final_metrics": last, "step": step,
            "tokens_per_sec": meter.items_per_sec, "brain_updates": brain_updates,
            "traces": traces, "mesh": mesh}


def _plot(diag, epoch: int, step: int, plots_dir: str, brain) -> None:
    """The three brain-map plots of a MoE slow loop, as the JAX loop draws
    them (its grid shape, feature names and census labels)."""
    from forde_tpu_torch.obs import plots

    assignments = diag["assignments"].cpu().numpy()
    plots.plot_brain_scan(plots.grid_of(assignments), epoch, step, plots_dir)
    plots.plot_feature_space(diag["cluster_features"].cpu().numpy(), assignments, epoch, step,
                             plots_dir, feature_names=("usage mean", "usage var"))
    plots.plot_census(assignments, epoch, step, plots_dir, num_clusters=brain.num_clusters,
                      labels={0: "Generalist", 1: "Specialist", 2: "Under-utilized"})


def main(argv: Optional[List[str]] = None) -> dict:
    started = not _process_group_up()
    try:
        return train(build_parser().parse_args(argv))
    finally:
        if started and _process_group_up():  # the group this run started
            import torch.distributed as dist

            dist.destroy_process_group()


def _process_group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


if __name__ == "__main__":
    main()
