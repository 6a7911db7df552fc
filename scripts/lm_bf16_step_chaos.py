#!/usr/bin/env python3
"""How far apart two bf16 training steps of the decoder LM land, and why.

One training step of the reference-default decoder (chip_smoke.py's
SERVE_FLAGS width, seeded random weights, batches of 2 x 2,048 Markov
tokens) on four paths from the same weights: the kernel path in bf16
(twice), the all-plain path (every kernel replaced by its plain version)
in bf16 and in fp32. For each pair it prints the relative L2 of Adam's
first moment (0.1 x the clipped gradient) per parameter group, and the
share of NSA top-k selections and of MoE routing choices that differ.
A bf16 step at random initialisation is chaotic: these discrete choices
tie in bf16, so a pair of equally precise paths can read far apart.

Run on one GPU from the root of a checkout (about a minute):

  python3 scripts/lm_bf16_step_chaos.py
"""

import contextlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from forde_tpu_torch.core.config import DTypePolicy  # noqa: E402
from forde_tpu_torch.nn import attention as attention_mod  # noqa: E402
from forde_tpu_torch.ops import moe_dispatch  # noqa: E402
from forde_tpu_torch.train.step import train_step  # noqa: E402

GROUPS = ("token_embed", "pos_embed", "lm_head", "experts", "router", "attention", "mhc")
SEEDS = smoke.LM_PARITY_SEEDS


def one_step(cfg, weights, device, dtypes, plain, seed):
    """Adam's first moment by parameter name, and the NSA top-k and MoE
    routing choices of the step's forward."""
    batch = smoke.lm_batch(2, smoke.LM_SEQ, cfg.vocab_size, device, seed)
    state = smoke.lm_train_state(cfg, weights, device, dtypes)
    selected, routed = [], []
    top_k_desc, top_k_gating = attention_mod.top_k_desc, moe_dispatch.top_k_gating

    def record_top_k(x, k):
        values, idx = top_k_desc(x, k)
        selected.append(idx.clone())
        return values, idx

    def record_gating(logits, k):
        idx, probs = top_k_gating(logits, k)
        routed.append(idx.sort(-1).values)
        return idx, probs

    attention_mod.top_k_desc, moe_dispatch.top_k_gating = record_top_k, record_gating
    try:
        with smoke.plain_lm_kernels() if plain else contextlib.nullcontext():
            train_step(state, batch, aux_loss_weight=0.01)
    finally:
        attention_mod.top_k_desc, moe_dispatch.top_k_gating = top_k_desc, top_k_gating
    names = [n for n, _ in state.model.named_parameters()]
    mu = {n: m.detach().float().clone() for n, m in zip(names, state.optimizer.mu)}
    del state
    torch.cuda.empty_cache()
    return mu, selected, routed


def compare(a, b):
    mu_a, sel_a, route_a = a
    mu_b, sel_b, route_b = b
    out = {}
    for group in GROUPS + ("all",):
        names = [n for n in mu_a if group == "all" or group in n]
        x = torch.cat([mu_a[n].flatten() for n in names])
        y = torch.cat([mu_b[n].flatten() for n in names])
        out[group] = round(float((x - y).norm() / y.norm()), 4)
    out["topk_flips"] = round(sum(float((~torch.isin(x, y)).float().mean())
                                  for x, y in zip(sel_a, sel_b)) / len(sel_a), 4)
    out["routing_flips"] = round(sum(float((x != y).any(-1).float().mean())
                                     for x, y in zip(route_a, route_b)) / len(route_a), 4)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_bf16_step_chaos: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(smoke.nvidia_smi())
    cfg = smoke.serve_config()
    weights = smoke.lm_weights(cfg, device)
    bf16, fp32 = DTypePolicy.bf16(), DTypePolicy.fp32()
    for seed in SEEDS:
        kernel = one_step(cfg, weights, device, bf16, False, seed)
        again = one_step(cfg, weights, device, bf16, False, seed)
        plain16 = one_step(cfg, weights, device, bf16, True, seed)
        plain32 = one_step(cfg, weights, device, fp32, True, seed)
        for label, a, b in (("kernel bf16 vs plain bf16", kernel, plain16),
                            ("plain bf16 vs plain fp32", plain16, plain32),
                            ("kernel bf16 vs plain fp32", kernel, plain32),
                            ("kernel bf16 vs kernel bf16 again", kernel, again)):
            print(f"batch seed {seed}: {label}: {compare(a, b)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
