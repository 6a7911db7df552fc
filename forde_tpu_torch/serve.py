"""Inference CLI for the FORDE decoder LM (port of forde_tpu/serve.py).

Serves a checkpoint directory (``model_config.json`` + ``params.npz``,
train/checkpoint.py, written by either package) or, without one, seeded
random weights at the shape the flags give. Prompts are token ids:

  python -m forde_tpu_torch.serve --checkpoint_dir ckpt \\
      --prompt_ids 5,17,200 --max_new_tokens 16 --temperature 0
  python -m forde_tpu_torch.serve --checkpoint_dir ckpt \\
      --prompts_file prompts.txt --output_file out.jsonl --temperature 0

``--prompt_ids`` decodes one prompt with ``generate_cached`` (or
``generate_beam`` with ``--beam_size`` > 1, or ``generate_speculative``
with ``--draft_checkpoint_dir``); ``--prompts_file`` (one comma-separated
prompt per line) decodes the whole mixed-length batch with
``generate_ragged``. ``--prefix_ids`` prefills a shared prefix once and
continues every prompt from it (dense-causal configs); ``--quantize int8``
serves int8 weights (ops/quant.py; the draft's too). Runs on CUDA unless
``--device cpu``; with no GPU visible it raises.

``--use_ema`` serves a checkpoint's EMA weights, and a LoRA checkpoint is
served with its adapters merged into the base it records (or
``--lora_base_dir``; train/checkpoint.load_lm_params).

``--tensor_parallelism N`` serves under ``torchrun --nproc_per_node N``:
the model's Megatron layers split over a model axis of N ranks
(parallel/tensor_parallel.py; the decode caches hold each rank's heads),
int8 with ``--quantize`` too. Every rank decodes the same prompts; rank 0
prints and writes the output file.

  torchrun --standalone --nproc_per_node 2 -m forde_tpu_torch.serve \
      --checkpoint_dir ckpt --prompt_ids 5,17,200 --temperature 0 \
      --tensor_parallelism 2

Not ported yet, and refused: expert-parallel MoE dispatch in serving, and
text prompts (they need a tokenizer in the repository).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from typing import List, Optional

import torch

from forde_tpu_torch import resolve_device
from forde_tpu_torch.train.loop import config_from_args


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
                   help="shared prompt prefix (comma-separated token ids; e.g. a system "
                        "prompt): prefilled once and reused by every prompt this run "
                        "decodes; outputs hold prompt + continuation only. Dense configs; "
                        "not with --beam_size/--draft_checkpoint_dir")
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
    p.add_argument("--beam_size", type=int, default=0,
                   help="> 1 switches to beam search (overrides sampling)")
    p.add_argument("--eos_id", type=int, default=None,
                   help="stop a row once it emits this token (the rest is --pad_id)")
    p.add_argument("--pad_id", type=int, default=0)
    p.add_argument("--length_penalty", type=float, default=0.0,
                   help="beam search: scores / generated_len**penalty (only meaningful "
                        "with --eos_id)")
    p.add_argument("--tensor_parallelism", type=int, default=1,
                   help="model-parallel serving over N ranks (torchrun --nproc_per_node N): "
                        "Megatron layout (core/mesh.py tp_param_spec)")
    p.add_argument("--use_ema", action="store_true",
                   help="serve the EMA weights (a checkpoint trained with --ema_decay)")
    p.add_argument("--lora_base_dir", type=str, default=None,
                   help="override a LoRA checkpoint's recorded base path")
    p.add_argument("--draft_checkpoint_dir", type=str, default=None,
                   help="speculative decoding: a (smaller) draft model checkpoint with "
                        "model_config.json; both models dense-causal (--no_nsa) with one "
                        "vocabulary (models/speculative.py)")
    p.add_argument("--gamma", type=int, default=4,
                   help="speculative decoding: draft proposals per round")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="weight-only int8 serving: attention/FFN/lm_head weights and the "
                        "MoE expert bank quantized per channel at load, products in int8; "
                        "NSA branch projections stay fp (ops/quant.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


_NOT_PORTED = (
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
    weights at the flags' shape; int8 with ``--quantize``."""
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.ops.quant import quantize_params
    from forde_tpu_torch.train.checkpoint import load_lm_params, load_meta

    if args.checkpoint_dir:
        config, model = load_lm_params(args.checkpoint_dir, device, use_ema=args.use_ema,
                                       lora_base_dir=args.lora_base_dir)
        meta = load_meta(args.checkpoint_dir)[1]
        print(f"[serve] model config loaded from {args.checkpoint_dir}/model_config.json")
        if meta.get("lora"):
            print("[serve] LoRA checkpoint: adapters merged into the base weights at load")
        print(f"[serve] restored step {int(meta.get('step', 0))} from {args.checkpoint_dir}")
        if args.use_ema:
            print("[serve] serving EMA weights")
    elif args.use_ema:
        raise ValueError("--use_ema needs a --checkpoint_dir trained with --ema_decay")
    else:
        config = config_from_args(args)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = FORDEDecoderLM(config, device=device, generator=gen).eval()
        print("[serve] no --checkpoint_dir: random init (smoke mode)")
    if args.quantize:
        model = quantize_params(model)
        config = model.config
        print("[serve] int8 weight-only quantization applied (attention/FFN/lm_head kernels "
              "+ MoE expert bank; NSA branch projections stay fp)")
    return config, model


def _load_draft(args, device):
    """The draft model of speculative decoding (int8 too under --quantize)."""
    from forde_tpu_torch.ops.quant import quantize_params
    from forde_tpu_torch.train.checkpoint import load_lm_params, load_meta

    _, draft = load_lm_params(args.draft_checkpoint_dir, device)
    step = int(load_meta(args.draft_checkpoint_dir)[1].get("step", 0))
    print(f"[serve] speculative decoding: draft restored step {step} (gamma={args.gamma})")
    if args.quantize:
        draft = quantize_params(draft)
        print("[serve] draft quantized int8 too")
    return draft


def _tensor_parallel(args, model, device):
    """With ``--tensor_parallelism`` N > 1: the mesh (data 1, model N) over
    the process group torchrun started, ``model`` keeping this rank's
    slices. Otherwise None."""
    if args.tensor_parallelism <= 1:
        return None
    from forde_tpu_torch.core import mesh as mesh_lib
    from forde_tpu_torch.train.state import shard_model

    mesh_lib.maybe_initialize_distributed(device)
    mesh = mesh_lib.create_mesh(data=1, model=args.tensor_parallelism)
    shard_model(model, mesh)
    if mesh.rank == 0:
        print(f"[serve] mesh serving: {mesh.shape}")
    return mesh


def _parse_ids(text: str) -> List[int]:
    return [int(t) for t in text.split(",") if t.strip()]


def main(argv: Optional[list] = None) -> List[List[int]]:
    """Serve per the flags; returns the output rows (prompt +
    continuation) in input order."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    from forde_tpu_torch.core.mesh import local_device

    device = local_device(resolve_device(args.device))
    started = args.tensor_parallelism > 1 and not _process_group_up()
    try:
        config, model = load_serving_model(args, device)
        mesh = _tensor_parallel(args, model, device)
        if mesh is None or mesh.rank == 0:
            return _serve(args, config, model, device)
        with contextlib.redirect_stdout(io.StringIO()):  # rank 0 alone prints
            return _serve(args, config, model, device, write=False)
    finally:
        if started and _process_group_up():
            import torch.distributed as dist

            dist.destroy_process_group()


def _process_group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _serve(args, config, model, device, write: bool = True) -> List[List[int]]:
    from forde_tpu_torch.models import generate as G

    gen = torch.Generator(device=device).manual_seed(args.seed)
    sampling = dict(
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id, pad_id=args.pad_id,
    )

    prefix_cache, prefix_len = None, 0
    if args.prefix_ids:
        if config.use_sparse_attention:
            sys.exit("--prefix_ids requires a dense-causal config (NSA streaming caches depend "
                     "on what follows the prefix)")
        if args.beam_size > 1 or args.draft_checkpoint_dir:
            sys.exit("--prefix_ids composes with greedy/sampled cached decode only")
        prefix = _parse_ids(args.prefix_ids)
        prefix_len = len(prefix)
        prefix_cache = G.prefill_prefix(model, torch.tensor([prefix], device=device))
        print(f"[serve] shared prefix prefilled once ({prefix_len} tokens); outputs hold "
              "prompt + continuation only")

    if args.prompts_file:
        if args.beam_size > 1 or args.draft_checkpoint_dir:
            sys.exit("--prompts_file composes with greedy/sampled cached decode only (not "
                     "--beam_size/--draft_checkpoint_dir)")
        with open(args.prompts_file) as f:
            prompts = [_parse_ids(ln) for ln in f if ln.strip()]
        for i, pr in enumerate(prompts):
            if prefix_len + len(pr) + args.max_new_tokens > config.max_seq_len:
                raise ValueError(
                    f"prompt {i}: {prefix_len} (prefix) + {len(pr)} + {args.max_new_tokens} "
                    f"tokens exceeds max_seq_len {config.max_seq_len}"
                )
        lens = torch.tensor([len(pr) for pr in prompts], dtype=torch.int64)
        padded = torch.full((len(prompts), int(lens.max())), args.pad_id, dtype=torch.int64)
        for i, pr in enumerate(prompts):
            padded[i, : len(pr)] = torch.tensor(pr)
        out = G.generate_ragged(model, padded.to(device), lens.to(device), gen, **sampling,
                                prefix_cache=prefix_cache)
        out = out.cpu()
        results = [out[i, : int(n) + args.max_new_tokens].tolist() for i, n in enumerate(lens)]
        for i, row in enumerate(results):
            print(f"[{i}] token ids: {row}")
        if args.output_file and write:
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
    if prefix_len + len(ids) + args.max_new_tokens > config.max_seq_len:
        raise ValueError(
            f"prefix + prompt + max_new_tokens exceeds max_seq_len ({prefix_len} + {len(ids)} + "
            f"{args.max_new_tokens} > {config.max_seq_len})"
        )
    prompt = torch.tensor([ids], device=device)
    if args.draft_checkpoint_dir:
        from forde_tpu_torch.models.speculative import generate_speculative

        draft = _load_draft(args, device)
        out, stats = generate_speculative(model, draft, prompt, gen, gamma=args.gamma,
                                          **sampling, with_stats=True)
        r, g = stats["rounds"], stats["generated"]
        print(f"[serve] speculative: {g} tokens in {r} target forwards "
              f"({g / max(r, 1):.2f} tokens/forward)")
    elif args.beam_size > 1:
        out = G.generate_beam(model, prompt, max_new_tokens=args.max_new_tokens,
                              beam_size=args.beam_size, length_penalty=args.length_penalty,
                              eos_id=args.eos_id, pad_id=args.pad_id)
    else:
        out = G.generate_cached(model, prompt, gen, **sampling, prefix_cache=prefix_cache)
    row = out[0].cpu().tolist()
    print("token ids:", row)
    return [row]


if __name__ == "__main__":
    main()
