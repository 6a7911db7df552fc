"""Evaluation CLI of the decoder LM: the perplexity of a checkpoint over a
dataset (port of forde_tpu/eval_lm.py).

Loads a checkpoint directory (``model_config.json`` + ``params.npz``,
written by either package's train.loop; a LoRA checkpoint arrives merged,
``--use_ema`` evaluates the EMA weights) and reports the mean next-token
cross-entropy and the perplexity over ``--num_batches`` batches, with the
shifted cross-entropy the train step optimizes, forward-only
(``train/step.eval_step``, batches through ``prefetch_to_device``). Runs
on CUDA unless ``--device cpu``; with no GPU visible it raises.

  python -m forde_tpu_torch.eval_lm --checkpoint_dir ckpt \\
      --data_file corpus.txt --seq_len 2048 --num_batches 50
  python -m forde_tpu_torch.eval_lm --device cpu --checkpoint_dir ckpt \\
      --use_markov_data --seq_len 64 --batch_size 2 --num_batches 4

Prints one JSON line: {"lm_loss", "perplexity", "aux_loss", "batches",
"tokens"}. The streamed corpus (no data flag) and ``--tokenizer gpt2``
need a tokenizer and data in the repository, and are refused.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

from forde_tpu_torch import resolve_device


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's flags (and ``--device``)."""
    p = argparse.ArgumentParser(description="FORDE decoder LM evaluation")
    p.add_argument("--checkpoint_dir", type=str, required=True,
                   help="a train.loop checkpoint (model_config.json + params.npz)")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--lora_base_dir", type=str, default=None,
                   help="override a LoRA checkpoint's recorded base path")
    p.add_argument("--data_file", type=str, default=None,
                   help=".npy token ids or raw text (byte-level ids)")
    p.add_argument("--tokenizer", choices=["byte", "gpt2"], default="byte",
                   help="tokenization of a text --data_file (gpt2: not ported)")
    p.add_argument("--use_dummy_data", action="store_true")
    p.add_argument("--use_markov_data", action="store_true")
    p.add_argument("--markov_active_vocab", type=int, default=8192)
    p.add_argument("--markov_p", type=float, default=0.85)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--num_batches", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def _dataset(args, config):
    from forde_tpu_torch.data import lm
    from forde_tpu_torch.train.loop import TOKENIZER

    if args.data_file and args.tokenizer == "gpt2":
        raise NotImplementedError(f"--tokenizer gpt2 is not ported to forde_tpu_torch yet (it "
                                  f"waits for {TOKENIZER}; see ROADMAP.md)")
    if args.data_file:
        dataset = lm.create_text_file_dataset(
            args.data_file, args.batch_size, args.seq_len, num_batches=args.num_batches,
            tokenizer=args.tokenizer, seed=args.seed,
        )
        if dataset.vocab_hint > config.vocab_size:
            raise ValueError(f"{args.data_file} has ids up to {dataset.vocab_hint - 1} "
                             f">= model vocab {config.vocab_size}")
        return dataset
    if args.use_markov_data:
        return lm.create_markov_dataset(
            args.batch_size, args.seq_len, config.vocab_size, num_batches=args.num_batches,
            active_vocab=args.markov_active_vocab, p=args.markov_p, seed=args.seed,
        )
    if args.use_dummy_data:
        return lm.create_dummy_dataset(args.batch_size, args.seq_len, config.vocab_size,
                                       num_batches=args.num_batches)
    raise NotImplementedError(
        "the streamed corpus (no --data_file, --use_markov_data or --use_dummy_data) is not "
        f"ported to forde_tpu_torch yet (it waits for {TOKENIZER}; see ROADMAP.md)")


def evaluate(args) -> dict:
    from forde_tpu_torch.data.prefetch import prefetch_to_device
    from forde_tpu_torch.train.checkpoint import load_lm_params, load_meta
    from forde_tpu_torch.train.state import TrainState
    from forde_tpu_torch.train.step import eval_step

    device = resolve_device(args.device)
    config, model = load_lm_params(args.checkpoint_dir, device, use_ema=args.use_ema,
                                   lora_base_dir=args.lora_base_dir)
    step = int(load_meta(args.checkpoint_dir)[1].get("step", 0))
    print(f"[eval] restored step {step} from {args.checkpoint_dir}")
    if args.use_ema:
        print("[eval] evaluating EMA weights")
    if args.seq_len > config.max_seq_len:
        raise ValueError(f"--seq_len {args.seq_len} exceeds the model's "
                         f"max_seq_len {config.max_seq_len}")
    dataset = _dataset(args, config)
    state = TrainState(model=model, optimizer=None)

    losses, auxes = [], []
    n_tokens = 0
    for batch in prefetch_to_device(iter(dataset), device):
        metrics = eval_step(state, batch)
        losses.append(float(metrics["loss/lm"]))
        auxes.append(float(metrics["loss/aux"]))
        n_tokens += int(batch["input_ids"].shape[0]) * (args.seq_len - 1)
    if not losses:
        raise ValueError("dataset produced no batches")
    lm_loss = float(np.mean(losses))
    out = {
        "lm_loss": round(lm_loss, 6),
        "perplexity": round(float(np.exp(lm_loss)), 4),
        "aux_loss": round(float(np.mean(auxes)), 6),
        "batches": len(losses),
        "tokens": n_tokens,
    }
    print(json.dumps(out))
    return out


def main(argv: Optional[list] = None) -> dict:
    return evaluate(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
