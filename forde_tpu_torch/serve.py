"""Inference CLI for the FORDE decoder LM (port of forde_tpu/serve.py).

Serves a checkpoint directory (``model_config.json`` + ``params.npz``,
train/checkpoint.py, written by either package) or, without one, seeded
random weights at the shape the flags give. Prompts are token ids:

  python -m forde_tpu_torch.serve --checkpoint_dir ckpt \\
      --prompt_ids 5,17,200 --max_new_tokens 16 --temperature 0
  python -m forde_tpu_torch.serve --checkpoint_dir ckpt \\
      --prompts_file prompts.txt --output_file out.jsonl --temperature 0

``--prompt_ids`` decodes one prompt with ``generate_cached``;
``--prompts_file`` (one comma-separated prompt per line) decodes the whole
mixed-length batch with ``generate_ragged``. Runs on CUDA unless
``--device cpu``; with no GPU visible it raises.

Not ported yet, and refused with the slice they wait for: beam search,
speculative decoding, int8 quantization, tensor-parallel serving and
shared prefixes (the generation-extras slice), EMA and LoRA weights (the
training-extras slice), text prompts (they need a tokenizer in the
repository), and capacity / expert-parallel MoE dispatch (the decoder
LM's training slice).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from forde_tpu_torch import resolve_device
from forde_tpu_torch.core.config import DTypePolicy, LLMConfig


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's flags (and ``--device``)."""
    p = argparse.ArgumentParser(description="FORDE decoder LM inference")
    # model shape (must match training; same flags as train.loop)
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
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--moe_dispatch", choices=["dense", "capacity", "ep"], default="dense")
    # serving
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="model_config.json + params.npz; omit for random init")
    p.add_argument("--prompt", type=str, default=None,
                   help="text prompt (not ported: needs a tokenizer)")
    p.add_argument("--prompt_ids", type=str, default=None,
                   help="comma-separated token ids")
    p.add_argument("--prefix_ids", type=str, default=None,
                   help="shared prompt prefix (not ported yet)")
    p.add_argument("--prompts_file", type=str, default=None,
                   help="batch serving: one prompt of comma-separated token ids "
                        "per line, decoded ragged in one batch; results print in "
                        "input order")
    p.add_argument("--text_prompts", action="store_true",
                   help="treat --prompts_file lines as text (not ported)")
    p.add_argument("--output_file", type=str, default=None,
                   help='write batch results as JSONL lines {"index", "prompt_ids", '
                        '"output_ids"}')
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=1.0, help="0 = greedy")
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None,
                   help="nucleus sampling: smallest probability mass >= top_p "
                        "(composable with --top_k)")
    p.add_argument("--beam_size", type=int, default=0, help="> 1: beam search (not ported)")
    p.add_argument("--eos_id", type=int, default=None,
                   help="stop a row once it emits this token (the rest is --pad_id)")
    p.add_argument("--pad_id", type=int, default=0)
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--tensor_parallelism", type=int, default=1, help="(not ported)")
    p.add_argument("--use_ema", action="store_true", help="(not ported)")
    p.add_argument("--lora_base_dir", type=str, default=None, help="(not ported)")
    p.add_argument("--draft_checkpoint_dir", type=str, default=None,
                   help="speculative decoding (not ported)")
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--quantize", choices=["int8"], default=None, help="(not ported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def config_from_args(args) -> LLMConfig:
    """The training CLI's derivation of the model config from the shape
    flags (forde_tpu/train/loop.py); it moves to the port's train/loop.py
    with the decoder LM's training slice."""
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


_NOT_PORTED = (
    (lambda a: a.beam_size > 1, "--beam_size > 1", "generation extras"),
    (lambda a: a.draft_checkpoint_dir, "--draft_checkpoint_dir",
     "generation extras"),
    (lambda a: a.quantize, "--quantize", "generation extras"),
    (lambda a: a.tensor_parallelism > 1, "--tensor_parallelism > 1",
     "generation extras"),
    (lambda a: a.prefix_ids, "--prefix_ids", "generation extras"),
    (lambda a: a.use_ema, "--use_ema", "training extras"),
    (lambda a: a.lora_base_dir, "--lora_base_dir", "training extras"),
    (lambda a: a.prompt is not None, "--prompt",
     "a tokenizer in the repository"),
    (lambda a: a.text_prompts, "--text_prompts",
     "a tokenizer in the repository"),
)


def _refuse_unported(args) -> None:
    for given, flag, slice_name in _NOT_PORTED:
        if given(args):
            raise NotImplementedError(
                f"{flag} is not ported to forde_tpu_torch yet (it waits for {slice_name}; "
                "see ROADMAP.md)"
            )


def load_serving_model(args, device):
    """(config, model in eval mode): the checkpoint, or seeded random
    weights at the flags' shape."""
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.train.checkpoint import load_lm_params, load_meta

    if args.checkpoint_dir:
        config, model = load_lm_params(args.checkpoint_dir, device)
        step = int(load_meta(args.checkpoint_dir)[1].get("step", 0))
        print(f"[serve] model config loaded from {args.checkpoint_dir}/model_config.json")
        print(f"[serve] restored step {step} from {args.checkpoint_dir}")
        return config, model
    config = config_from_args(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = FORDEDecoderLM(config, device=device, generator=gen)
    print("[serve] no --checkpoint_dir: random init (smoke mode)")
    return config, model.eval()


def _parse_ids(text: str) -> List[int]:
    return [int(t) for t in text.split(",") if t.strip()]


def main(argv: Optional[list] = None) -> List[List[int]]:
    """Serve per the flags; returns the output rows (prompt +
    continuation) in input order."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)
    from forde_tpu_torch.models.generate import generate_cached, generate_ragged

    config, model = load_serving_model(args, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    sampling = dict(
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id, pad_id=args.pad_id,
    )

    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = [_parse_ids(ln) for ln in f if ln.strip()]
        for i, pr in enumerate(prompts):
            if len(pr) + args.max_new_tokens > config.max_seq_len:
                raise ValueError(
                    f"prompt {i}: {len(pr)} + {args.max_new_tokens} tokens exceeds "
                    f"max_seq_len {config.max_seq_len}"
                )
        lens = torch.tensor([len(pr) for pr in prompts], dtype=torch.int64)
        padded = torch.full((len(prompts), int(lens.max())), args.pad_id, dtype=torch.int64)
        for i, pr in enumerate(prompts):
            padded[i, : len(pr)] = torch.tensor(pr)
        out = generate_ragged(model, padded.to(device), lens.to(device), gen, **sampling)
        out = out.cpu()
        results = [out[i, : int(n) + args.max_new_tokens].tolist() for i, n in enumerate(lens)]
        for i, row in enumerate(results):
            print(f"[{i}] token ids: {row}")
        if args.output_file:
            with open(args.output_file, "w") as f:
                for i, row in enumerate(results):
                    f.write(json.dumps({"index": i, "prompt_ids": prompts[i],
                                        "output_ids": row}) + "\n")
            print(f"[serve] wrote {len(results)} results to {args.output_file}")
        print(f"[serve] batch: {len(prompts)} prompts, ragged (1 batch)")
        return results

    if args.prompt_ids:
        ids = _parse_ids(args.prompt_ids)
    else:
        ids = [0]
        print("[serve] no prompt given; starting from token 0")
    if len(ids) + args.max_new_tokens > config.max_seq_len:
        raise ValueError(
            f"prompt + max_new_tokens exceeds max_seq_len ({len(ids)} + "
            f"{args.max_new_tokens} > {config.max_seq_len})"
        )
    out = generate_cached(model, torch.tensor([ids], device=device), gen, **sampling)
    row = out[0].cpu().tolist()
    print("token ids:", row)
    return [row]


if __name__ == "__main__":
    main()
