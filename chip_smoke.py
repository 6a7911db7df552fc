#!/usr/bin/env python3
"""Smoke test of forde_tpu_torch on one NVIDIA GPU (H100).

Drives the port's main paths through the entry points a user calls, and
holds every CUDA kernel of them against its plain PyTorch version:

  * the embedding path (``forde_tpu_torch.embed.main``) at the full width
    of the production ViT-B preset (``vit_b16_hd128``, bf16, seeded random
    weights);
  * the dual encoder's training path (``forde_tpu_torch.train.clip_loop.
    main``) at the full width of ``vit_b16`` in bf16, batch 128: 16
    contrastive steps with sensing every 8th, two GMM brain updates, and a
    checkpoint that ``embed.main`` then serves;
  * the decoder LM's serving path (``forde_tpu_torch.serve.main``) at the
    full width of the reference-default decoder (d 512, 12 layers, 8 heads
    x 64, NSA window 512, MoE top-2 of 8, 4 mHC streams, bf16), from a
    checkpoint of seeded random weights: a ragged batch of 8 prompts of
    640-1,920 tokens, greedy, and one sampled prompt of 1,536 tokens;
  * the decoder LM's training path (``forde_tpu_torch.train.loop.main``)
    at the same width on batches of 8 x 2,048 seeded Markov tokens: 6
    steps, the MoE slow loop every 3rd, a checkpoint that ``serve.main``
    then decodes from; and one step at 2 layers, batch 1, 8,192 tokens
    (the JAX package's streaming side, 960 NSA pools).

Phases:
  1. device: name, and name + power limit from nvidia-smi;
  2. build every kernel under forde_tpu_torch/csrc, one nvcc per source,
     all started together; ptxas's registers and spills per kernel, and
     the HMMA (tensor-core) count of the libraries with a bf16
     tensor-core route (flash_mha_fwd, flash_mha_bwd, small_kv_fwd,
     small_kv_bwd), which must not be 0;
  3. each kernel against its plain version on the card, fp32 and bf16, at
     the shapes of the paths (the training CLIs' shapes; the serving
     prefill and decode shapes, the streaming S = 8192, an odd S and a
     padded D) and the mask options (kv_lens with 0, kv_bound, causal +
     window; kv_len; INVALID_KEY_POS keys, keys all in the future, K not a
     multiple of 64; an lse cotangent), each backward kernel's bf16 error
     against its plain version's, small_kv_bwd bit-identical across two
     calls, and the output and gradients of ``flash_mha``,
     ``flash_attention`` and ``small_kv_attention`` on CUDA tensors
     against the kernels or the plain attention path;
  4. the embedding path: finite (N, 512) embeddings, 24 launches of
     flash_mha_fwd (12 + 12 layers), and the cosine of each embedding
     against the same weights on the all-plain attention path;
  5. the dual encoder's training path: finite loss, the launches of each
     kernel (per sensed step 24 flash_mha_fwd, 24 flash_mha_bwd, 48
     moment_sums; per unsensed step 24 + 24 + 0), two brain updates that
     were not skipped, gradient statistics non-zero before each update and
     zero after, the checkpoint served by ``embed.main``, and the CLI's
     prefetch route delivering batches intact;
  6. step parity at ``vit_b16_hd128``: one sensed step on the kernel path
     against one on the all-plain path from the same weights, fp32 and
     bf16 (with the bf16-vs-fp32 plain control printed beside it);
  7. timing at ``vit_b16_hd128``, bf16, batch 128: encode time, sensed and
     unsensed step times, pairs/s at sensing every 8th step, the neuron
     slow loop, one encode and one sensed step under torch.profiler, and
     per kernel its time (and its device time alone), its plain
     version's, PyTorch's one-call equivalent where there is one (timed as
     a yardstick only, the port never calls it) and the least time the
     card could take; the attention kernels also at ``vit_b16``'s D = 64
     shapes;
  8. the serving path: ``serve.main`` from the checkpoint, ids in the
     vocabulary, the prompts kept, and exact launches (per prefill 12
     flash_fwd and 24 small_kv_fwd, per decode step 0 and 24);
  9. serving parity: the greedy batch on the kernel path and on the
     all-plain path from the same weights, identical tokens in fp32, and
     in bf16 the relative L2 of the prefill's last logits beside the
     plain-bf16-vs-plain-fp32 control;
 10. serving time: time to first token and ms per output token of the
     8-prompt batch (kernel path vs all-plain path in turns), output
     tokens/s, one prefill and one decode step under torch.profiler, and
     per kernel its time, its plain version's, SDPA's with the same mask,
     and the bound;
 11. the LM training path: finite loss, exact launches (per step 12
     flash_fwd, 12 flash_bwd_dq, 12 flash_bwd_dkv, 24 small_kv_fwd, 24
     small_kv_bwd), two MoE slow loops that moved all 12 router biases,
     peak memory, the trained checkpoint served; the 8,192-token step;
 12. LM step parity (batch 2 x 2,048): the kernel path against the
     all-plain path (every kernel's plain version) and the plain attention
     path, fp32 and bf16, with the bf16-vs-fp32 control;
 13. LM training time (bf16, 8 x 2,048): step time, tokens/s, the MoE slow
     loop, one step under torch.profiler, and per backward kernel its
     time, its plain version's, SDPA's backward with the same mask, and the
     bound.

Prints the kernels' JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises: exit code != 0.
Run with no arguments on a machine with one GPU (about 3 minutes):

  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor; fp32 non-tensor

# Phase 3 tolerances on o, per element: |o - plain| <= atol + rtol *
# (|plain| + mag), where the plain version runs in fp32 on the same input
# values (a bf16 input is widened exactly) and mag = sum_c (p_c / l) |v_c|
# (fwd_magnitudes). The kernel sums exact products in fp32 too, so fp32
# differs by summation order (atol). In bf16 the kernel rounds the weights
# p to bf16 before the product with v, as the TPU kernel does
# (forde_tpu/ops/flash_attention.py:1024): a relative 2^-9 of each term,
# at most 2^-9 * mag; and it rounds o: 2^-9 of the value. rtol 2^-8 bounds
# the sum of the two. lse is fp32 in both types.
TOL_O = {"float32": (1e-4, 0.0), "bfloat16": (1e-4, 2.0 ** -8)}  # (atol, rtol)
TOL_LSE = 1e-4
# Phase 4: least cosine of each embedding against the same weights on the
# all-plain attention path in the same dtype. fp32 differs by summation
# order only. In bf16 both paths round activations at every layer, and a
# third of the neurons are binary steps that flip when a pre-activation
# rounds across 0; the plain path in bf16 against the plain path in fp32
# is printed beside it as the control.
MIN_COSINE_FP32 = 0.99999
MIN_COSINE_BF16 = 0.997
# flash_mha_bwd against its plain version run in fp32 on the same values,
# per element |Δ| <= atol + rtol * (|plain| + mag), mag the sum of the
# absolute terms the element adds up (bwd_magnitudes). fp32 differs by
# summation order (atol, and rtol for long sums). In bf16 the kernel rounds
# p (for dv) and ds (for dq, dk) to bf16, as the TPU kernel does, each a
# relative 2^-9 of a term, and rounds its output, 2^-9 of the value:
# rtol 2^-8 bounds the sum of the two.
TOL_BWD = {"float32": (1e-4, 1e-5), "bfloat16": (1e-4, 2.0 ** -8)}
# Gradients of flash_mha through the kernels against the plain path's
# autograd, fp32: summation order only.
TOL_GRAD = 1e-4
# moment_sums: fp32 sums in another order. The kernel adds a chunk of at
# most a few hundred rows in sequence, then ~100 chunk sums: each adds at
# most (rows + chunks) * 2^-24 ~ 3e-5 of m.
TOL_MOMENT_REL = 1e-4
# Phase 6: one sensed step of vit_b16_hd128 at this batch, kernel path vs
# all-plain path from the same weights; per quantity the relative L2
# difference: loss, grad_norm, act_stats, grad_stats, the gradients (as
# Adam's first moment), the update (each parameter leaf's change, median
# leaf) and the parameters after it. Beyond summation order, the
# multiplex's kinks at z = 0 (relu's derivative, the binary step) turn
# fp32 noise in a pre-activation near 0 into a whole unit of change, and
# Adam's first step, ~lr * sign(g), flips with the sign of a gradient at
# noise level, so the update differs by far more than the gradients. The
# parameters dilute that by |update| / |params| ~ 2.5e-3: an optimizer
# that leaves the weights unchanged reads ~2.5e-3 on params and 1.0 on the
# update. Readings (the same in every run): fp32 loss 8.0e-5, grad_norm
# 6.2e-5, act_stats 4.2e-5, grad_stats 2.3e-4, grads 7.1e-3, update
# 7.5e-2, params 1.9e-4; bf16 2.5e-3, 7.4e-3, 2.1e-3, 7.1e-3, 0.180,
# 0.490, 1.24e-3; control, plain bf16 vs plain fp32: 3.0e-4, 1.02e-2,
# 4.1e-3, 7.3e-3, 0.201, 0.517, 1.32e-3. fp32 bars at 4-10x the reading,
# those of update and params below a no-op optimizer's. bf16 bars between the reading
# and the control where the two differ by 10% or more (grad_norm,
# act_stats, grads: these separate lower precision); elsewhere (loss is
# above the control; grad_stats, update and params lie within 2-6% of it)
# at 2-4x the reading, or below a no-op optimizer's reading (update,
# params).
PARITY_BATCH = 16
PARITY_TOL = {
    "fp32": {"loss": 1e-3, "grad_norm": 1e-3, "act_stats": 5e-4, "grad_stats": 2e-3,
             "grads": 3e-2, "update": 0.3, "params": 1e-3},
    "bf16": {"loss": 1e-2, "grad_norm": 9e-3, "act_stats": 3e-3, "grad_stats": 1.5e-2,
             "grads": 0.19, "update": 0.75, "params": 2e-3},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    that cycle through ``fns`` (one closure per input copy, so that the
    inputs of consecutive calls do not sit in L2)."""
    import torch

    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(b, s, h, d, dtype_name, lens=None, backward=False) -> tuple:
    """(ms by bytes, ms by operations) of one fused-qkv attention forward
    or backward at the card's peaks. Bytes, forward: qkv read once, o and
    lse written once; backward: qkv, do and lse read, dqkv written; lens
    read. Operations: 2 * D per (query, visible key, head) for each
    product, two forward (q k^T, p v) and five backward (q k^T, do v^T,
    p^T do, ds^T q, ds k), counting the keys these inputs leave visible."""
    elem = 2 if dtype_name == "bfloat16" else 4
    qkv_bytes, o_bytes = b * s * 3 * h * d * elem, b * s * h * d * elem
    moved = (2 if backward else 1) * qkv_bytes + o_bytes + b * h * s * 4
    keys = b * s if lens is None else int(lens.clamp(max=s).sum())
    if lens is not None:
        moved += 4 * b
    ops = (10.0 if backward else 4.0) * h * d * s * keys
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def bound(bytes_ms: float, ops_ms: float) -> tuple:
    """(bound_ms, bound_by): the larger of the two times."""
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


# Every kernel of the main paths: csrc/<name>.cu.
KERNEL_SOURCES = ("flash_mha_fwd", "flash_mha_bwd", "moment_sums", "flash_fwd", "small_kv_fwd",
                  "flash_bwd", "small_kv_bwd")
# Libraries whose bf16 route runs on the tensor cores: their SASS must hold
# HMMA instructions.
TENSOR_CORE_SOURCES = ("flash_mha_fwd", "flash_mha_bwd", "small_kv_fwd", "small_kv_bwd")


def hmma_count(name: str) -> int:
    """HMMA instructions in the SASS of lib<name>, by the cuobjdump beside
    nvcc."""
    from forde_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-sass", str(build.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in out.splitlines())


def phase_build():
    """One nvcc per source, all started together; ptxas's registers and
    spills per kernel, and the HMMA count of the tensor-core libraries."""
    from concurrent.futures import ThreadPoolExecutor

    from forde_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(build.load, KERNEL_SOURCES))
    log(f"[build] {len(KERNEL_SOURCES)} kernel(s) ready in {time.perf_counter() - t0:.2f} s "
        f"under {build.BUILD_DIR}")
    for name, (secs, text) in build.build_log.items():
        log(f"[build] nvcc {name}: {secs:.2f} s")
        for line in text.splitlines():
            if ("Function properties for" in line or "registers" in line or "spill" in line
                    or "error" in line):
                log(f"[build]   {line.strip()}")
    for name in TENSOR_CORE_SOURCES:
        count = hmma_count(name)
        log(f"[build] lib{name}: {count} HMMA instructions in its SASS")
        if count == 0:
            raise AssertionError(f"lib{name} has no tensor-core (HMMA) instruction")


# (name, B, S, H, D, kv_lens, causal, window): the vision and text shapes
# of vit_b16_hd128 and of vit_b16 (the training CLI's preset), the S=197
# shape that needs kv_bound, the causal + window option, both presets'
# shapes at the batch of 128 (vit_b16_hd128's vision S = 197 padded to 200
# with kv_bound 197, as the path runs it), the shortest S and the longest
# (MAX_FUSED_SEQ) at D = 128.
CHECK_CASES = [
    ("vision_s200_h6_d128", 4, 200, 6, 128, None, False, None),
    ("text_s64_h4_d128_lens", 4, 64, 4, 128, [0, 1, 17, 64], False, None),
    ("text_s64_h8_d64_lens", 4, 64, 8, 64, [0, 1, 17, 64], False, None),
    ("s197_h12_d64_kv_bound", 2, 197, 12, 64, None, False, None),
    ("s128_h2_d64_causal_window32", 2, 128, 2, 64, None, True, 32),
    ("s200_h2_d128_causal_window32_lens", 3, 200, 2, 128, [200, 0, 5], True, 32),
    ("vision_b128_s200_h12_d64", 128, 200, 12, 64, None, False, None),
    ("text_b128_s64_h8_d64_lens", 128, 64, 8, 64, [0, 1, 17, 64] * 32, False, None),
    ("vision_b128_s200_h6_d128", 128, 197, 6, 128, None, False, None),
    ("text_b128_s64_h4_d128_lens", 128, 64, 4, 128, [0, 1, 17, 64] * 32, False, None),
    ("s8_h2_d128_lens", 3, 8, 2, 128, [8, 0, 3], False, None),
    ("s512_h2_d128_lens", 2, 512, 2, 128, [512, 300], False, None),
]
# flash_mha on CUDA tensors against the plain attention path: (name, B, S,
# H, D, kv_lens); S=197 goes through the entry point's padding to 200.
GRAD_CASES = [
    ("vision_s200_h6_d128", 2, 200, 6, 128, None),
    ("text_s64_h4_d128_lens", 4, 64, 4, 128, [0, 1, 17, 64]),
    ("text_s64_h8_d64_lens", 4, 64, 8, 64, [0, 1, 17, 64]),
    ("s197_h12_d64", 2, 197, 12, 64, None),
]


def fwd_magnitudes(qkv, lens, h, d, scale, window, causal, kv_bound):
    """(B, S, H*D) fp32: per element of o the sum of the absolute terms
    it adds up, sum_c (p_c / l) |v_c|, with the plain version's fp32
    weights. A rounding of p by a relative eps moves o by at most eps
    times this."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa

    b, s, _ = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    scores = q @ k.transpose(-1, -2) * scale
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    if mask is not None:
        scores = scores.masked_fill(~mask, fa.MASK_VALUE)
    w = torch.softmax(scores, dim=-1)
    return (w @ v.abs()).transpose(1, 2).reshape(b, s, h * d)


def bwd_magnitudes(qkv, lens, lse, do, h, d, scale, window, causal, kv_bound):
    """(B, S, 3*H*D) fp32: per element of dq, dk, dv the sum of the
    absolute terms it adds up (|ds|·|k|, |ds|ᵀ·|q|, |p|ᵀ·|do|), with the
    plain version's fp32 p and ds. A rounding of p or ds by a relative
    eps moves each element by at most eps times this."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa

    b, s, _ = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
    do4 = do.reshape(b, s, h, d).transpose(1, 2)
    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse)
    mask = fa._visible(s, qkv.device, causal, window, lens, kv_bound)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=p.device))
    dp = do4 @ v.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True)) * scale).abs()
    mag = torch.stack([ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(),
                       p.transpose(-1, -2) @ do4.abs()], dim=2)
    return mag.permute(0, 3, 2, 1, 4).reshape(b, s, 3 * h * d)


def held_against(got, want, atol, rtol_term) -> tuple:
    """(max |got - want|, worst |got - want| / (atol + rtol_term))."""
    diff = (got.float() - want).abs()
    return diff.max().item(), (diff / (atol + rtol_term)).max().item()


def phase_check_attention(device) -> tuple:
    """flash_mha_fwd and flash_mha_bwd against their plain versions run in
    fp32 on the same (exactly widened) inputs, the backward from the kernel
    forward's lse, at CHECK_CASES in fp32 and bf16; then flash_mha on CUDA
    tensors against the plain attention path, output and gradients (the
    regression check for an output with no grad_fn). Returns the worst
    max |error| of the forward and of the backward."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa

    worst_fwd = worst_bwd = 0.0
    gen = torch.Generator(device=device).manual_seed(SEED)
    for name, b, s, h, d, lens, causal, window in CHECK_CASES:
        x = torch.randn(b, s, 3 * h * d, device=device, generator=gen) * 0.5
        g = torch.randn(b, s, h * d, device=device, generator=gen)
        lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=device)
        s_pad = -(-s // 8) * 8
        kv_bound = s if (s_pad != s and not causal and lens is None) else None
        if s_pad != s:
            x = F.pad(x, (0, 0, 0, s_pad - s))
            g = F.pad(g, (0, 0, 0, s_pad - s))
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qkv, do = x.to(dt).contiguous(), g.to(dt).contiguous()
            args = (h, d, d ** -0.5, window, causal, kv_bound)
            o, lse = fa.flash_mha_fwd(qkv, lens_t, *args)
            dqkv = fa.flash_mha_bwd(qkv, lens_t, lse, do, *args)
            o_ref, lse_ref = fa.flash_mha_fwd_reference(qkv.float(), lens_t, *args)
            fwd_mag = fwd_magnitudes(qkv.float(), lens_t, *args)
            dqkv_ref = fa.flash_mha_bwd_reference(qkv.float(), lens_t, lse, do.float(), *args)
            mag = bwd_magnitudes(qkv.float(), lens_t, lse, do.float(), *args)
            torch.cuda.synchronize()

            atol, rtol = TOL_O[dtype_name]
            err, ratio = held_against(o, o_ref, atol, rtol * (o_ref.abs() + fwd_mag))
            lse_err = (lse - lse_ref).abs().max().item()
            ok = ratio <= 1.0 and lse_err <= TOL_LSE
            log(f"[check] fwd {name} {dtype_name}: max|o - plain| {err:.3e}, worst "
                f"|o - plain| / ({atol:g} + {rtol:g}(|plain| + mag)) {ratio:.3f} (tol 1), "
                f"max|lse - plain| {lse_err:.3e} (tol {TOL_LSE:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_mha_fwd disagrees with its plain version: {name} {dtype_name}")
            worst_fwd = max(worst_fwd, err)

            atol, rtol = TOL_BWD[dtype_name]
            err, ratio = held_against(dqkv, dqkv_ref, atol, rtol * (dqkv_ref.abs() + mag))
            finite = bool(torch.isfinite(dqkv).all())
            ok = ratio <= 1.0 and finite
            log(f"[check] bwd {name} {dtype_name}: max|dqkv - plain| {err:.3e}, worst "
                f"|Δ| / ({atol:g} + {rtol:g}(|plain| + mag)) {ratio:.3f} (tol 1), "
                f"finite {finite} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_mha_bwd disagrees with its plain version: {name} {dtype_name}")
            worst_bwd = max(worst_bwd, err)

            if lens is not None and 0 in lens:
                empty = lens_t == 0
                if o[empty].abs().max().item() != 0.0 or dqkv[empty].abs().max().item() != 0.0:
                    raise AssertionError(f"{name}: a kv_lens == 0 sample has a non-zero o or gradient")

    # flash_mha on CUDA tensors: autograd through the kernels against the
    # plain attention path (impl="reference"), fp32, same upstream weights.
    for name, b, s, h, d, lens in GRAD_CASES:
        x = torch.randn(b, s, 3 * h * d, device=device, generator=gen) * 0.5
        w = torch.randn(b, s, h * d, device=device, generator=gen)
        lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=device)
        outs, grads = [], []
        for impl in ("auto", "reference"):
            qkv = x.clone().requires_grad_(True)
            o = fa.flash_mha(qkv, h, d, kv_lens=lens_t, impl=impl)
            if o.grad_fn is None:
                raise AssertionError(f"flash_mha(impl={impl!r}) output has no grad_fn")
            (o * w).sum().backward()
            if qkv.grad is None:
                raise AssertionError(f"flash_mha(impl={impl!r}): qkv.grad is missing")
            outs.append(o.detach())
            grads.append(qkv.grad)
        o_err = (outs[0] - outs[1]).abs().max().item()
        err = (grads[0] - grads[1]).abs().max().item()
        ok = o_err <= TOL_O["float32"][0] and err <= TOL_GRAD
        log(f"[check] flash_mha on CUDA {name}: grad_fn present, max|o - plain path| "
            f"{o_err:.3e} (tol {TOL_O['float32'][0]:g}), max|dqkv - plain path| {err:.3e} "
            f"(tol {TOL_GRAD:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_mha disagrees with the plain path: {name}")
    return worst_fwd, worst_bwd


# (name, N, F, dtype): the vision and text z of vit_b16_hd128 at batch 128,
# fp32, and an N that is not a multiple of the row chunk.
MOMENT_CASES = [
    ("vision_z", 25600, 3072, "bfloat16"),
    ("text_z", 8192, 2048, "bfloat16"),
    ("text_z_fp32", 8192, 2048, "float32"),
    ("odd_n", 12345, 3072, "bfloat16"),
]


def phase_check_moments(device) -> float:
    """moment_sums against its plain version (fp32 sums of the same
    values). Per element |Δ| <= TOL_MOMENT_REL * m, m the sum of the
    absolute terms (Σ|x| for Σ|x| and Σx, Σx² for Σx²)."""
    import torch

    from forde_tpu_torch.ops import stat_sums

    worst = 0.0
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    for name, n, f, dtype_name in MOMENT_CASES:
        x = (torch.randn(n, f, device=device, generator=gen) + 0.25).to(getattr(torch, dtype_name))
        got = stat_sums.moment_sums(x)
        want = stat_sums.moment_sums_reference(x)
        torch.cuda.synchronize()
        mag = want[[0, 1, 0]]
        diff = (got - want).abs()
        err = diff.max().item()
        ratio = (diff / (TOL_MOMENT_REL * mag)).max().item()
        ok = ratio <= 1.0
        log(f"[check] moment_sums {name} ({n}, {f}) {dtype_name}: max|Δ| {err:.3e}, worst "
            f"|Δ| / ({TOL_MOMENT_REL:g}·m) {ratio:.3f} (tol 1) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"moment_sums disagrees with its plain version: {name}")
        worst = max(worst, err)
    return worst


def main_path_config():
    from forde_tpu_torch.core.config import DTypePolicy, vit_b16_hd128_config

    return vit_b16_hd128_config().replace(dtypes=DTypePolicy.bf16())


def build_model(cfg, device):
    """Seeded random weights, and a seeded mix of neuron types (every
    multiplex branch runs)."""
    import torch

    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder

    gen = torch.Generator(device=device).manual_seed(SEED)
    model = FORDEDualEncoder(cfg.replace(sense=False), device=device, generator=gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("neuron_assignments"):
                buf.copy_(torch.randint(0, 3, buf.shape, device=device, generator=gen))
    return model.eval()


def phase_main_path(device, workdir) -> dict:
    import torch

    from forde_tpu_torch import embed, interop, kernels
    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
    from forde_tpu_torch.train.checkpoint import save_params

    cfg = main_path_config()
    model = build_model(cfg, device)
    ckpt = os.path.join(workdir, "ckpt")
    npz = interop.flatten(interop.state_dict_to_flax(model.state_dict()))
    save_params(ckpt, cfg, npz, {"step": 0})

    rng = np.random.RandomState(SEED)
    images = [rng.rand(224, 224, 3).astype(np.float32) for _ in range(3)]
    images.append((rng.rand(256, 192, 3) * 255).astype(np.uint8))  # resized
    paths = []
    for i, img in enumerate(images):
        paths.append(os.path.join(workdir, f"img{i}.npy"))
        np.save(paths[-1], img)
    texts = ";".join(
        ",".join(str(t) for t in rng.randint(1, cfg.vocab_size, n))
        for n in (5, 17, 64, 80)  # the last one is truncated to 64
    )
    prefix = os.path.join(workdir, "emb")
    argv = ["--checkpoint_dir", ckpt, "--image_npy", ",".join(paths),
            "--text_ids", texts, "--out", prefix]

    kernels.reset_launches()
    t0 = time.perf_counter()
    embed.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"[main] embed.main (vit_b16_hd128 bf16, 4 images + 4 texts) took "
        f"{secs:.2f} s including the checkpoint load; launches {launches}")

    img = np.load(prefix + "_image.npy")
    txt = np.load(prefix + "_text.npy")
    if img.shape != (4, 512) or txt.shape != (4, 512):
        raise AssertionError(f"embedding shapes {img.shape} {txt.shape}")
    if not (np.isfinite(img).all() and np.isfinite(txt).all()):
        raise AssertionError("non-finite embeddings")
    per_pass = cfg.vision.num_layers + cfg.text.num_layers
    if launches.get("flash_mha_fwd", 0) != per_pass:
        raise AssertionError(
            f"flash_mha_fwd launched {launches.get('flash_mha_fwd', 0)} times, "
            f"expected {per_pass} (one per layer of both towers)"
        )

    # The same weights and inputs through the other paths: kernel or
    # all-plain attention, in bf16 and in fp32.
    from forde_tpu_torch.core.config import DTypePolicy

    x = torch.from_numpy(embed._load_images(",".join(paths), cfg.image_size)).to(device)
    ids, mask = (torch.from_numpy(a).to(device) for a in embed._load_texts(texts, cfg.max_text_len))

    def run(dtypes, impl):
        m = FORDEDualEncoder(
            cfg.replace(sense=False, dtypes=dtypes, attention_kernel_impl=impl),
            device=device,
        )
        m.load_state_dict(model.state_dict())
        with torch.inference_mode():
            out = m.eval().encode_image(x), m.encode_text(ids, mask)
        return np.concatenate([o.cpu().numpy() for o in out])

    def cosine(a, b):
        return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))

    got = np.concatenate([img, txt])
    plain32 = run(DTypePolicy.fp32(), "reference")
    plain16 = run(DTypePolicy.bf16(), "reference")
    cos32 = cosine(run(DTypePolicy.fp32(), "auto"), plain32).min()
    cos_bf16 = cosine(got, plain16).min()
    cos_plain_bf16 = cosine(plain16, plain32).min()
    log(f"[main] min cosine, kernel path vs plain path: fp32 {cos32:.7f} "
        f"(tol >= {MIN_COSINE_FP32}), bf16 {cos_bf16:.6f} (tol >= {MIN_COSINE_BF16}); "
        f"control, plain bf16 vs plain fp32: {cos_plain_bf16:.6f}, "
        f"kernel bf16 vs plain fp32: {cosine(got, plain32).min():.6f}")
    if not (cos32 >= MIN_COSINE_FP32 and cos_bf16 >= MIN_COSINE_BF16):
        raise AssertionError(f"kernel path vs plain path: cosine {cos32}, {cos_bf16}")
    return {"launches": launches, "model": model, "cfg": cfg,
            "min_cosine_fp32": float(cos32), "min_cosine_bf16": float(cos_bf16),
            "min_cosine_plain_bf16_vs_fp32": float(cos_plain_bf16)}


def phase_encode_timing(device, model, cfg) -> dict:
    """Encode time of 128 images + 128 texts, kernel path vs all-plain
    attention path in turns, and one encode under the profiler."""
    import torch

    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder

    batch = 128
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    images = torch.rand(batch, cfg.image_size, cfg.image_size, 3, device=device, generator=gen)
    lens = torch.randint(8, cfg.max_text_len + 1, (batch,), device=device, generator=gen)
    pos = torch.arange(cfg.max_text_len, device=device)
    mask = (pos[None, :] < lens[:, None]).to(torch.int32)
    ids = torch.randint(1, cfg.vocab_size, (batch, cfg.max_text_len), device=device,
                        generator=gen) * mask

    def encode(m):
        with torch.inference_mode():
            m.encode_image(images)
            m.encode_text(ids, mask)

    def encode_ms(m, reps=5):
        for _ in range(2):
            encode(m)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            encode(m)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    plain = FORDEDualEncoder(
        cfg.replace(sense=False, attention_kernel_impl="reference"), device=device
    )
    plain.load_state_dict(model.state_dict())
    plain.eval()
    # plain, kernel, kernel, plain: the two paths share the card in turns.
    p1, k1, k2, p2 = (encode_ms(m) for m in (plain, model, model, plain))
    kernel_ms = min(k1, k2)
    plain_ms = min(p1, p2)
    log(f"[time] encode 128 images + 128 texts: kernel path {k1:.3f} / {k2:.3f} ms, "
        f"plain path {p1:.3f} / {p2:.3f} ms (median of 5 each)")
    log(f"[time] pairs/s: kernel path {batch / kernel_ms * 1e3:.1f}, "
        f"plain path {batch / plain_ms * 1e3:.1f}")
    profile_device(lambda: encode(model), "one encode (128 images + 128 texts)")
    return {"encode_ms": kernel_ms, "plain_encode_ms": plain_ms,
            "pairs_per_s": batch / kernel_ms * 1e3}


def device_ms(fns, reps: int = 20, spin_cycles: int = 200_000_000) -> float:
    """Mean device time of one call: ``reps`` calls cycling through ``fns``
    are queued behind a spin kernel (``torch.cuda._sleep``, ~0.1 s), so the
    card runs them back to back and CUDA events around them time the card
    alone. cuda_ms reads the host instead when a call is shorter than its
    launch path."""
    import torch

    for fn in fns[:2]:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(run, label: str, top: int = 12) -> dict:
    """Device time by kernel over one call of ``run`` (after one warm-up
    call) under torch.profiler, and the device's idle share of the wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_ms = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = evt.cuda_time_total
        kernels_ms.append((total / 1e3, evt.count, evt.key))
    kernels_ms.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels_ms)
    idle = 1 - busy_ms / wall_ms
    log(f"[profile] {label}: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms, idle share {idle:.3f}")
    for ms, count, name in kernels_ms[:top]:
        log(f"[profile]   {ms:9.3f} ms {ms / busy_ms:6.3f}  x{count:<4d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle}


# The training path's command line (phase 5): full width of vit_b16 (the
# CLI's preset: vision 12 x 64, text 8 x 64 heads), bf16, batch 128, the
# GMM slow loop.
TRAIN_ARGV = [
    "--preset", "vit_b16", "--bf16", "--use_dummy_data", "--dummy_pool", "2",
    "--batch_size", "128", "--num_steps", "16", "--sense_interval", "8",
    "--slow_loop_interval", "8", "--moment_dtype", "bfloat16", "--warmup_steps", "4",
    "--log_interval", "8",
]


def launches_per_step(cfg, sensed: bool) -> dict:
    """Kernel launches of one training step: attention forward and
    backward once per layer of both towers; two moment sums per
    StatefulLayer (activations, gradient tap) on a sensed step."""
    layers = cfg.vision.num_layers + cfg.text.num_layers
    return {"flash_mha_fwd": layers, "flash_mha_bwd": layers,
            "moment_sums": 2 * layers if sensed else 0}


def phase_train_path(workdir) -> dict:
    import torch

    from forde_tpu_torch import embed, kernels
    from forde_tpu_torch.train import clip_loop

    ckpt = os.path.join(workdir, "train_ckpt")
    argv = TRAIN_ARGV + ["--checkpoint_dir", ckpt, "--seed", str(SEED)]
    args = clip_loop.build_parser().parse_args(argv)
    cfg = clip_loop.config_from_args(args)
    cwd = os.getcwd()
    os.chdir(workdir)  # the loop's metrics land in ./runs
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = clip_loop.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        os.chdir(cwd)
    loss = out["final_metrics"]["loss/contrastive"]
    log(f"[train] clip_loop.main ({' '.join(TRAIN_ARGV)}) took {secs:.2f} s; "
        f"final loss {loss:.4f}, launches {launches}")
    if not np.isfinite(loss) or out["step"] != args.num_steps:
        raise AssertionError(f"training path: loss {loss}, steps {out['step']}")

    n_sensed = len(range(0, args.num_steps, args.sense_interval))
    n_unsensed = args.num_steps - n_sensed
    sensed, unsensed = launches_per_step(cfg, True), launches_per_step(cfg, False)
    want = {k: n_sensed * sensed[k] + n_unsensed * unsensed[k] for k in sensed}
    if launches != want:
        raise AssertionError(
            f"training path launches {launches}, expected {want} "
            f"({n_sensed} sensed steps x {sensed} + {n_unsensed} unsensed x {unsensed})"
        )

    layers = cfg.vision.num_layers + cfg.text.num_layers
    updates = out["brain_updates"]
    for u in updates:
        log(f"[train] brain update @ {u['step']}: {u['latency_ms']:.2f} ms, skipped "
            f"{u['skipped']}, |grad_stats| {u['grad_stats_abs_sum_before']:.4g} -> "
            f"{u['grad_stats_abs_sum_after']:.4g}, sensed layer-steps "
            f"{u['sensed_steps_before']} -> {u['sensed_steps_after']}")
    if [u["step"] for u in updates] != [8, 16] or any(
        u["skipped"] or not u["grad_stats_abs_sum_before"] > 0
        or u["grad_stats_abs_sum_after"] != 0
        or u["sensed_steps_before"] != layers or u["sensed_steps_after"] != 0
        for u in updates
    ):
        raise AssertionError(f"brain updates of the training path: {updates}")

    # The trained checkpoint through the serving entry point.
    rng = np.random.RandomState(SEED + 4)
    img_path = os.path.join(workdir, "train_img.npy")
    np.save(img_path, rng.rand(cfg.image_size, cfg.image_size, 3).astype(np.float32))
    prefix = os.path.join(workdir, "train_emb")
    embed.main(["--checkpoint_dir", ckpt, "--image_npy", img_path,
                "--text_ids", "12,99,407;7,5", "--out", prefix])
    img, txt = np.load(prefix + "_image.npy"), np.load(prefix + "_text.npy")
    if img.shape != (1, cfg.embed_dim) or txt.shape != (2, cfg.embed_dim) or not (
        np.isfinite(img).all() and np.isfinite(txt).all()
    ):
        raise AssertionError(f"serving the trained checkpoint: {img.shape} {txt.shape}")
    log(f"[train] embed.main served the trained checkpoint: image {img.shape}, "
        f"text {txt.shape}, finite")
    return {"launches": launches, "seconds": secs, "final_loss": loss,
            "brain_update_ms": [u["latency_ms"] for u in updates]}


def check_prefetch(device) -> None:
    """The training CLI's data route without --dummy_pool: batches
    assembled in pinned host memory and copied ahead on a side stream
    arrive on the card intact."""
    import torch

    from forde_tpu_torch.data.prefetch import prefetch_to_device
    from forde_tpu_torch.data.vl import SyntheticVLDataset

    cfg = main_path_config()
    dataset = SyntheticVLDataset(
        16, 4, image_size=cfg.image_size, text_len=cfg.max_text_len,
        vocab_size=cfg.vocab_size, seed=SEED,
    )
    n = 0
    for host, dev in zip(dataset, prefetch_to_device(iter(dataset), device)):
        torch.cuda.synchronize()
        for k, v in host.items():
            if dev[k].device != device or not np.array_equal(dev[k].cpu().numpy(), v):
                raise AssertionError(f"prefetch_to_device: batch {n} {k} differs")
        n += 1
    log(f"[train] prefetch_to_device delivered {n} batches intact")


class plain_moment_sums:
    """Context: the StatefulLayers' moment sums take the plain version on
    CUDA tensors too (the all-plain path of phases 6 and 7)."""

    def __enter__(self):
        from forde_tpu_torch.ops import stat_sums

        self.saved = stat_sums.moment_sums
        stat_sums.moment_sums = stat_sums.moment_sums_reference
        return self

    def __exit__(self, *exc):
        from forde_tpu_torch.ops import stat_sums

        stat_sums.moment_sums = self.saved


def training_batch(cfg, batch: int, device, seed: int) -> dict:
    import torch

    from forde_tpu_torch.data.vl import SyntheticVLDataset

    host = next(iter(SyntheticVLDataset(
        batch, 1, image_size=cfg.image_size, text_len=cfg.max_text_len,
        vocab_size=cfg.vocab_size, seed=seed,
    )))
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def train_state(cfg, reference_state, device, impl="auto", moment_dtype="bfloat16"):
    """A fresh train state at ``cfg`` (sense on, attention ``impl``) whose
    model holds ``reference_state`` (a serving model's: the stat buffers
    start at 0)."""
    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
    from forde_tpu_torch.train.clip_step import create_clip_train_state

    cfg = cfg.replace(sense=True, attention_kernel_impl=impl)
    model = FORDEDualEncoder(cfg, device=device)
    missing, unexpected = model.load_state_dict(reference_state, strict=False)
    if unexpected or not all(k.endswith(("act_stats", "step_count")) for k in missing):
        raise KeyError(f"train state: unexpected {unexpected}, missing {missing}")
    return create_clip_train_state(
        cfg, None, 1e-4, 0.01, warmup_steps=0, moment_dtype=moment_dtype, model=model
    )


def phase_step_parity(device) -> dict:
    """One sensed step of vit_b16_hd128 on the kernel path against one on
    the all-plain path (plain attention, plain moment sums) from the same
    weights and batch; fp32 and bf16. Then the launches of one sensed and
    one unsensed step on the kernel path."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.nn.stateful import stateful_layers
    from forde_tpu_torch.train.clip_step import clip_train_step, make_nosense_step

    cfg = main_path_config().replace(sense=True)
    weights = build_model(cfg, device).state_dict()
    batch = training_batch(cfg, PARITY_BATCH, device, SEED + 5)

    def one_step(dtypes, impl):
        state = train_state(cfg.replace(dtypes=dtypes), weights, device, impl, moment_dtype=None)
        before = [p.detach().float().clone() for p in state.optimizer.params]
        if impl == "reference":
            with plain_moment_sums():
                state, m = clip_train_step(state, batch)
        else:
            state, m = clip_train_step(state, batch)
        layers = stateful_layers(state.model).values()
        return {
            "loss": m["loss/contrastive"].reshape(1),
            "grad_norm": m["training/grad_norm"].reshape(1),
            "act_stats": torch.cat([layer.act_stats.flatten() for layer in layers]),
            "grad_stats": torch.cat([g.flatten() for g in state.grad_stats.values()]),
            # Adam's first moment after one step: (1 - b1) * the clipped gradient
            "grads": torch.cat([m.flatten() for m in state.optimizer.mu]),
            # the change of each parameter leaf, and the parameters after it
            "update": [p.detach().float() - b for p, b in zip(state.optimizer.params, before)],
            "params": torch.cat([p.detach().flatten() for p in state.optimizer.params]),
        }

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    def rel(a, b):
        """Relative L2 per quantity; for the update, the median leaf's. Not
        held to a bar: the update's worst leaf and whole vector, and the
        share of gradient elements whose sign differs (Adam's first step
        moves each weight by about lr * sign(g), so a share f of flipped
        signs gives the whole update a relative L2 near 2 * sqrt(f))."""
        out = {k: rel_l2(a[k], b[k]) for k in a if k != "update"}
        leaves = [rel_l2(x, y) for x, y in zip(a["update"], b["update"])]
        out["update"] = float(np.median(leaves))
        out["update_worst_leaf"] = max(leaves)
        out["update_whole"] = rel_l2(torch.cat([x.flatten() for x in a["update"]]),
                                     torch.cat([y.flatten() for y in b["update"]]))
        out["grad_sign_flips"] = float((a["grads"].sign() != b["grads"].sign()).float().mean())
        return out

    k32 = one_step(DTypePolicy.fp32(), "auto")
    p32 = one_step(DTypePolicy.fp32(), "reference")
    k16 = one_step(DTypePolicy.bf16(), "auto")
    p16 = one_step(DTypePolicy.bf16(), "reference")
    readings = {"fp32": rel(k32, p32), "bf16": rel(k16, p16), "control": rel(p16, p32),
                "kernel_bf16_vs_plain_fp32": rel(k16, p32)}
    for name, r in readings.items():
        label = {"fp32": "kernel vs plain, fp32", "bf16": "kernel vs plain, bf16",
                 "control": "control: plain bf16 vs plain fp32",
                 "kernel_bf16_vs_plain_fp32": "kernel bf16 vs plain fp32"}[name]
        log(f"[parity] {label}: relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
    for name in ("fp32", "bf16"):
        for k, tol in PARITY_TOL[name].items():
            v = readings[name][k]
            if not v <= tol:
                raise AssertionError(f"step parity {name} {k}: {v:.3e} > {tol:g}")

    # Launches of one sensed and one unsensed step on the kernel path (bf16).
    state = train_state(cfg.replace(dtypes=DTypePolicy.bf16()), weights, device)
    per_step = {}
    for sensed, step in ((True, clip_train_step), (False, make_nosense_step(cfg))):
        kernels.reset_launches()
        step(state, batch)
        torch.cuda.synchronize()
        per_step["sensed" if sensed else "unsensed"] = got = dict(kernels.launches)
        want = {k: v for k, v in launches_per_step(cfg, sensed).items() if v}
        if got != want:
            raise AssertionError(f"launches of one {'sensed' if sensed else 'unsensed'} step: {got} != {want}")
    log(f"[parity] launches per step on the kernel path: {per_step}")
    return {"readings": readings, "launches_per_step": per_step}


def phase_train_timing(device) -> dict:
    """Step times at vit_b16_hd128, bf16, batch 128 (kernel path vs
    all-plain path in turns), pairs/s with sensing every 8th step, the
    neuron slow loop over the 24 layers, and one sensed step under the
    profiler."""
    import torch

    from forde_tpu_torch.brain.neuron_slow_loop import neuron_slow_loop_step
    from forde_tpu_torch.train.clip_step import clip_train_step, make_nosense_step

    cfg = main_path_config().replace(sense=True)
    weights = build_model(cfg, device).state_dict()
    batch = training_batch(cfg, 128, device, SEED + 6)
    batch["image"] = batch["image"].to(cfg.dtypes.compute)
    nosense = make_nosense_step(cfg)
    kernel_state = train_state(cfg, weights, device)
    plain_state = train_state(cfg, weights, device, impl="reference")

    def step_ms(state, step, plain=False, reps=5):
        def run():
            if plain:
                with plain_moment_sums():
                    step(state, batch)
            else:
                step(state, batch)
        for _ in range(2):
            run()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    p1 = step_ms(plain_state, clip_train_step, plain=True)
    k1 = step_ms(kernel_state, clip_train_step)
    k2 = step_ms(kernel_state, clip_train_step)
    p2 = step_ms(plain_state, clip_train_step, plain=True)
    sensed_ms, plain_sensed_ms = min(k1, k2), min(p1, p2)
    unsensed_ms = step_ms(kernel_state, nosense)
    plain_unsensed_ms = step_ms(plain_state, nosense, plain=True)
    pairs = 128 * 8 / (sensed_ms + 7 * unsensed_ms) * 1e3
    plain_pairs = 128 * 8 / (plain_sensed_ms + 7 * plain_unsensed_ms) * 1e3
    log(f"[time] train step, batch 128: sensed {k1:.2f} / {k2:.2f} ms (plain path "
        f"{p1:.2f} / {p2:.2f} ms), unsensed {unsensed_ms:.2f} ms (plain path "
        f"{plain_unsensed_ms:.2f} ms); median of 5 each")
    log(f"[time] pairs/s with sensing every 8th step: kernel path {pairs:.1f}, "
        f"plain path {plain_pairs:.1f}")

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    slow = []
    for _ in range(3):
        clip_train_step(kernel_state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diag = neuron_slow_loop_step(
            kernel_state.model, kernel_state.grad_stats, kernel_state.grad_step_count, gen
        )
        skipped = bool(diag["skipped"])
        torch.cuda.synchronize()
        slow.append((time.perf_counter() - t0) * 1e3)
        if skipped:
            raise AssertionError("the timed slow loop skipped its update")
    log(f"[time] neuron slow loop (GMM, {cfg.vision.num_layers} + {cfg.text.num_layers} layers): "
        f"{' / '.join(f'{t:.2f}' for t in slow)} ms")
    profile_device(lambda: neuron_slow_loop_step(
        kernel_state.model, kernel_state.grad_stats, kernel_state.grad_step_count, gen
    ), "one neuron slow loop (GMM)")

    prof = profile_device(lambda: clip_train_step(kernel_state, batch),
                          "one sensed train step (batch 128)")
    return {"sensed_step_ms": sensed_ms, "unsensed_step_ms": unsensed_ms,
            "plain_sensed_step_ms": plain_sensed_ms, "plain_unsensed_step_ms": plain_unsensed_ms,
            "pairs_per_s_sense8": pairs, "plain_pairs_per_s_sense8": plain_pairs,
            "slow_loop_ms": float(np.median(slow)), "sensed_step_idle_share": prof["idle_share"]}


def moment_bound(n, f, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one moment_sums: x read once and
    (3, F) fp32 written; 4 fp32 operations per element (abs-add, fused
    multiply-add, add) on the CUDA cores."""
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = n * f * elem + 3 * f * 4
    return moved / HBM_BYTES_PER_S * 1e3, 4.0 * n * f / PEAK_OPS_PER_S["float32"] * 1e3


def time_kernel(label, kernel_fns, plain_fns, library_fns, bytes_ms, ops_ms, **shape) -> dict:
    """CUDA-event ms of a kernel, its plain version and PyTorch's one-call
    equivalent (None: there is none), each cycling through its closures,
    beside the bound; and the kernel's device time alone (device_ms)."""
    k_ms, p_ms = cuda_ms(kernel_fns), cuda_ms(plain_fns)
    l_ms = None if library_fns is None else cuda_ms(library_fns)
    k_dev = device_ms(kernel_fns)
    b_ms, b_by = bound(bytes_ms, ops_ms)
    log(f"[time] {label}: kernel {k_ms:.4f} ms (device {k_dev:.4f}), plain {p_ms:.4f} ms, "
        f"library {'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by})")
    return {**shape, "dtype": "bfloat16", "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms}


def phase_kernel_timing(device, cfg, encode_ms) -> dict:
    """Per call of each kernel at the training shapes of vit_b16_hd128
    (bf16, batch 128, text lengths 4-64): kernel, plain version, the
    library yardstick (scaled_dot_product_attention's forward and its
    backward on the same q/k/v; none for the moment sums) and the bound;
    the attention kernels also at vit_b16's D = 64 shapes (the training
    CLI's preset; keys "vision_d64", "text_d64"). Inputs cycle through
    copies that together exceed the 50 MB L2."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.core.config import vit_b16_config
    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.ops import stat_sums

    batch = 128
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    lens = torch.randint(4, cfg.max_text_len + 1, (batch,), device=device,
                         generator=gen).to(torch.int32)
    pos = torch.arange(cfg.max_text_len, device=device)
    s_vision = (cfg.image_size // cfg.patch_size) ** 2 + 1
    s_vision = -(-s_vision // 8) * 8  # CLS + patches + registers
    d64 = vit_b16_config()
    out = {"flash_mha_fwd": {}, "flash_mha_bwd": {}, "moment_sums": {}}
    for name, tw, s, shape_lens in (
        ("vision", cfg.vision, s_vision, None),
        ("text", cfg.text, cfg.max_text_len, lens),
        ("vision_d64", d64.vision, s_vision, None),
        ("text_d64", d64.text, cfg.max_text_len, lens),
    ):
        h, d = tw.num_heads, tw.head_dim
        scale = d ** -0.5
        copies = max(2, -(-200_000_000 // (batch * s * 3 * h * d * 2)))
        args = (h, d, scale, None, False, None)
        attn_mask = None if shape_lens is None else (
            pos[None, None, None, :s] < shape_lens[:, None, None, None]
        )
        inputs = []
        for _ in range(copies):
            qkv = (torch.randn(batch, s, 3 * h * d, device=device, generator=gen) * 0.5).to(torch.bfloat16)
            do = torch.randn(batch, s, h * d, device=device, generator=gen).to(torch.bfloat16)
            _, lse = fa.flash_mha_fwd(qkv, shape_lens, *args)
            q, k, v = (t.transpose(1, 2).detach().requires_grad_(True)
                       for t in qkv.view(batch, s, 3, h, d).unbind(2))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)
            inputs.append((qkv, do, lse, (q, k, v), o, do.view(batch, s, h, d).transpose(1, 2)))

        def sdpa(q, k, v):
            with torch.no_grad():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)

        shape = {"B": batch, "S": s, "H": h, "D": d}
        label = f"{name} (B={batch}, S={s}, H={h}, D={d}, bf16)"
        out["flash_mha_fwd"][name] = time_kernel(
            f"flash_mha_fwd {label}",
            [lambda i=i: fa.flash_mha_fwd(i[0], shape_lens, *args) for i in inputs],
            [lambda i=i: fa.flash_mha_fwd_reference(i[0], shape_lens, *args) for i in inputs],
            [lambda i=i: sdpa(*i[3]) for i in inputs],
            *attention_bound(batch, s, h, d, "bfloat16", shape_lens), **shape)
        out["flash_mha_bwd"][name] = time_kernel(
            f"flash_mha_bwd {label}",
            [lambda i=i: fa.flash_mha_bwd(i[0], shape_lens, i[2], i[1], *args) for i in inputs],
            [lambda i=i: fa.flash_mha_bwd_reference(i[0], shape_lens, i[2], i[1], *args)
             for i in inputs],
            [lambda i=i: i[4].backward(i[5], retain_graph=True) for i in inputs],
            *attention_bound(batch, s, h, d, "bfloat16", shape_lens, backward=True), **shape)
        del inputs
        if name.endswith("_d64"):
            continue

        n, f = batch * s, tw.mlp_hidden_dim
        xs = [torch.randn(n, f, device=device, generator=gen).to(torch.bfloat16)
              for _ in range(max(2, -(-200_000_000 // (n * f * 2))))]
        out["moment_sums"][name] = time_kernel(
            f"moment_sums {name} z ({n} x {f}, bf16)",
            [lambda x=x: stat_sums.moment_sums(x) for x in xs],
            [lambda x=x: stat_sums.moment_sums_reference(x) for x in xs],
            None, *moment_bound(n, f, "bfloat16"), N=n, F=f)
        del xs
    fwd = out["flash_mha_fwd"]
    attn_share = (cfg.vision.num_layers * fwd["vision"]["ms"]
                  + cfg.text.num_layers * fwd["text"]["ms"]) / encode_ms
    log(f"[time] attention kernel share of the kernel-path encode: {attn_share:.3f}")
    return out


# ---------------------------------------------------------------------------
# The decoder LM's serving path: kernels flash_fwd and small_kv_fwd
# ---------------------------------------------------------------------------

# flash_fwd and small_kv_fwd against their plain versions run in fp32 on
# the same (exactly widened) inputs, per element |Δ| <= atol + rtol *
# (|plain| + mag), mag the weighted sum of |v| the element adds up (the
# softmax weights times |v|). fp32 differs by summation order (atol, and
# rtol for long sums). In bf16 each kernel rounds the weights (p, or w) to
# bf16 before the product with v, as its TPU kernel does: a relative 2^-9
# of each term, at most 2^-9 * mag; and it rounds its output: 2^-9 of the
# value. rtol 2^-8 bounds the sum of the two.
TOL_ATTN = {"float32": (1e-4, 1e-5), "bfloat16": (1e-4, 2.0 ** -8)}

# (name, B, H, S, D, causal, window): S and D as the caller gives them;
# flash_attention pads S to 64 and D to 64 (an odd S non-causal gets the
# static kv_len bound). The serving prefill (the ragged batch pads to its
# longest prompt; 2048 is the configuration's longest), the streaming side
# of the JAX package's split (S = 8192), an odd S and a padded D, D = 128.
FLASH_FWD_CASES = [
    ("serve_b8_s2048_window512", 8, 8, 2048, 64, True, 512),
    ("serve_b8_s2048_causal", 8, 8, 2048, 64, True, None),
    ("stream_b1_s8192_window512", 1, 8, 8192, 64, True, 512),
    ("stream_b1_s8192_causal", 1, 8, 8192, 64, True, None),
    ("odd_s1000_d48_causal", 2, 4, 1000, 48, True, None),
    ("odd_s1000_d48_noncausal_kv_len", 2, 4, 1000, 48, False, None),
    ("s512_d128_window128", 2, 4, 512, 128, True, 128),
]
# (name, B, H, S, K, D, keys): the compressed and top-k branches of the
# serving prefill (S = 2048: 192 pools, 64 selected) and of a decode step
# (one query; 256 pools at max_seq_len 2048, 64 kept), pools a row does
# not have (INVALID_KEY_POS), every key in the future (the uniform quirk),
# D = 128, and K = 200, not a multiple of the kernels' 64-key tiles.
SMALL_KV_CASES = [
    ("prefill_pools_s2048_k192", 8, 8, 2048, 192, 64, "pools"),
    ("prefill_topk_s2048_k64", 8, 8, 2048, 64, 64, "topk"),
    ("decode_pools_s1_k256", 8, 8, 1, 256, 64, "decode_pools"),
    ("decode_topk_s1_k64", 8, 8, 1, 64, 64, "decode_topk"),
    ("invalid_keys_s512_k96", 4, 8, 512, 96, 64, "invalid"),
    ("all_future_s64_k40", 2, 4, 64, 40, 64, "future"),
    ("pools_s256_k100_d128", 2, 2, 256, 100, 128, "pools"),
    ("pools_s2048_k200", 2, 4, 2048, 200, 64, "pools"),
]
POOL_RATIO, WINDOW, MAX_SEQ = 8, 512, 2048


def pad_for_flash(q, k, v, s, d, causal):
    """flash_attention's padding: S to the kernel's tile, D to 64; a
    padded non-causal call bounds the keys with kv_len = S."""
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa

    s_pad, d_pad = -(-s // fa.BLOCK) * fa.BLOCK, max(-(-d // 64) * 64, 64)
    pads = (0, d_pad - d, 0, s_pad - s)
    kv_len = s if (not causal and s_pad != s) else None
    return [F.pad(t, pads).contiguous() for t in (q, k, v)], kv_len


def flash_fwd_magnitude(q, k, v, scale, window, causal, kv_len):
    """(B, H, S, D) fp32: softmax weights of the visible keys times |v|."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa

    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    mask = fa._visible(q.shape[2], q.device, causal, window, None, kv_len)
    if mask is not None:
        scores = scores.masked_fill(~mask, fa.MASK_VALUE)
    return torch.matmul(torch.softmax(scores, dim=-1), v.abs())


def small_kv_key_pos(kind, b, s, kk, device, gen):
    """Thresholds (B, K) int32 of one SMALL_KV_CASES kind."""
    import torch

    from forde_tpu_torch.ops.nsa_attention import INVALID_KEY_POS

    j = torch.arange(kk, device=device)
    if kind == "pools":
        return ((j + 1) * POOL_RATIO).expand(b, kk).to(torch.int32).contiguous()
    if kind == "topk":
        return torch.stack([torch.randperm(s, device=device, generator=gen)[:kk]
                            for _ in range(b)]).to(torch.int32)
    cur = torch.randint(600, MAX_SEQ - 64, (b, 1), device=device, generator=gen)
    if kind == "decode_pools":  # pool p joins once cur >= (p+1)*ratio + window - 1
        return ((j + 1) * POOL_RATIO + WINDOW - 1 - cur).to(torch.int32)
    if kind == "decode_topk":  # kept source indices, a few slots empty
        idx = torch.randint(0, 600, (b, kk), device=device, generator=gen)
        idx[:, -3:] = MAX_SEQ
        return (idx - cur).to(torch.int32)
    if kind == "invalid":  # the ragged prefill's pools past a row's count
        pos = ((j + 1) * POOL_RATIO).expand(b, kk).clone()
        count = torch.tensor([kk, 60, 7, 1], device=device)[:b]
        return torch.where(j[None, :] < count[:, None], pos, INVALID_KEY_POS).to(torch.int32)
    if kind == "future":
        return torch.full((b, kk), s + 100, dtype=torch.int32, device=device)
    raise ValueError(kind)


def small_kv_magnitude(q, k, v, key_pos, scale):
    import torch

    from forde_tpu_torch.ops import nsa_attention as nsa

    weights = torch.softmax(nsa._masked_scores(q, k, key_pos, scale), dim=-1)
    return torch.matmul(weights, v.abs())


def phase_check_serving_kernels(device) -> dict:
    """flash_fwd and small_kv_fwd against their plain versions run in fp32
    on the same values, FLASH_FWD_CASES and SMALL_KV_CASES in fp32 and
    bf16; flash_attention and small_kv_attention on CUDA tensors against
    the kernels they wrap. Returns the worst max |error| of each."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.ops import nsa_attention as nsa

    worst = {"flash_fwd": 0.0, "small_kv_fwd": 0.0}
    gen = torch.Generator(device=device).manual_seed(SEED + 20)

    def hold(name, case, dtype_name, got, want, mag):
        atol, rtol = TOL_ATTN[dtype_name]
        err, ratio = held_against(got, want, atol, rtol * (want.abs() + mag))
        finite = bool(torch.isfinite(got).all())
        ok = ratio <= 1.0 and finite
        log(f"[check] {name} {case} {dtype_name}: max|Δ| {err:.3e}, worst |Δ| / ({atol:g} + "
            f"{rtol:g}(|plain| + mag)) {ratio:.3f} (tol 1), finite {finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {case} {dtype_name}")
        worst[name] = max(worst[name], err)

    for case, b, h, s, d, causal, window in FLASH_FWD_CASES:
        x = [torch.randn(b, h, s, d, device=device, generator=gen) for _ in range(3)]
        (q, k, v), kv_len = pad_for_flash(*x, s, d, causal)
        scale = d ** -0.5
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            o, lse = fa.flash_fwd(qd, kd, vd, scale, window, causal, kv_len)
            qf, kf, vf = (t.float() for t in (qd, kd, vd))
            o_ref, lse_ref = fa.flash_fwd_reference(qf, kf, vf, scale, window, causal, kv_len)
            mag = flash_fwd_magnitude(qf, kf, vf, scale, window, causal, kv_len)
            torch.cuda.synchronize()
            hold("flash_fwd", case, dtype_name, o, o_ref, mag)
            lse_err = (lse - lse_ref).abs().max().item()
            if not lse_err <= TOL_LSE:
                raise AssertionError(f"flash_fwd lse {case} {dtype_name}: {lse_err:.3e}")
            with torch.inference_mode():
                whole = fa.flash_attention(*(t.to(dt) for t in x), causal=causal,
                                           window_size=window, scale=scale)
            if not torch.equal(whole, o[:, :, :s, :d]):
                raise AssertionError(f"flash_attention on CUDA is not its kernel's output: {case}")
            del o, lse, o_ref, lse_ref, mag, whole
        del x, q, k, v
        torch.cuda.empty_cache()

    for case, b, h, s, kk, d, kind in SMALL_KV_CASES:
        q = torch.randn(b, h, s, d, device=device, generator=gen)
        k, v = (torch.randn(b, h, kk, d, device=device, generator=gen) for _ in range(2))
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        scale = d ** -0.5
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            out = nsa.small_kv_fwd(qd, kd, vd, key_pos, scale)
            qf, kf, vf = (t.float() for t in (qd, kd, vd))
            want = nsa.small_kv_fwd_reference(qf, kf, vf, key_pos, scale)
            mag = small_kv_magnitude(qf, kf, vf, key_pos, scale)
            torch.cuda.synchronize()
            hold("small_kv_fwd", case, dtype_name, out, want, mag)
            if kind == "future":  # the uniform quirk: the mean of v
                mean = vf.mean(dim=2, keepdim=True).expand_as(want)
                hold("small_kv_fwd", case + "_is_mean_v", dtype_name, out, mean, mag)
            with torch.inference_mode():
                whole = nsa.small_kv_attention(qd, kd, vd, key_pos, scale=scale)
            if not torch.equal(whole, out):
                raise AssertionError(f"small_kv_attention on CUDA is not its kernel's output: {case}")
    return worst


# ---------------------------------------------------------------------------
# The decoder LM's training path: kernels flash_bwd_dq, flash_bwd_dkv and
# small_kv_bwd
# ---------------------------------------------------------------------------

# The backward kernels against their plain versions run in fp32 on the same
# (exactly widened) inputs, per element |Δ| <= atol + rtol * (|plain| +
# mag), mag the sum of the absolute terms the element adds up (|ds|·|k| for
# dq, |ds|ᵀ·|q| for dk, |p|ᵀ·|do| for dv). flash_bwd as flash_mha_bwd
# (TOL_BWD): fp32 differs by summation order; in bf16 the kernels round p
# (for dv) and ds (for dq, dk) to bf16, at most 2^-8 of each term, and
# their output, 2^-8 of the value. small_kv_bwd sums dk and dv over up to
# S = 8192 queries, in 64-query tiles and then in chunks of tiles, in
# another order than the plain version's matmul: each addition a rounding
# of 2^-24 of the running magnitude, so its rtol takes 1e-4 more in both
# types.
TOL_SKV_BWD = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2.0 ** -8 + 1e-4)}
# And in bf16 each backward kernel's relative L2 error against the exact
# (fp32) result is at most this much above its plain version's run in bf16:
# the same roundings at the same places, summed in other orders (on an
# NVIDIA H100 the two read within 0.01% of each other at every case).
BF16_AS_PRECISE = 1.05

# (name, B, H, S, D, causal, window, dlse): the training step's shape (the
# NSA local branch), the --no_nsa dense causal one, the streaming side of
# the JAX package's split (S = 8192), an odd S with a padded D (S to the
# tile, D to 64), non-causal with padded keys (kv_len), D = 128, and a
# nonzero lse cotangent (the ring-attention route).
FLASH_BWD_CASES = [
    ("train_b8_s2048_window512", 8, 8, 2048, 64, True, 512, False),
    ("train_b8_s2048_causal", 8, 8, 2048, 64, True, None, False),
    ("stream_b1_s8192_window512", 1, 8, 8192, 64, True, 512, False),
    ("odd_s1000_d48_causal", 2, 4, 1000, 48, True, None, False),
    ("odd_s1000_d48_noncausal_kv_len", 2, 4, 1000, 48, False, None, False),
    ("s512_d128_window128", 2, 4, 512, 128, True, 128, False),
    ("s512_d64_window128_dlse", 2, 4, 512, 64, True, 128, True),
]
# (name, B, H, S, K, D, keys): the compressed and top-k branches of the
# training step (S = 2048: 192 pools, 64 selected), 960 pools at S = 8192,
# pools a row does not have (INVALID_KEY_POS), every key in the future (the
# uniform quirk: dq = dk = 0), D = 128, and K = 200, not a multiple of the
# kernels' 64-key tiles.
SMALL_KV_BWD_CASES = [
    ("train_pools_s2048_k192", 8, 8, 2048, 192, 64, "pools"),
    ("train_topk_s2048_k64", 8, 8, 2048, 64, 64, "topk"),
    ("long_pools_s8192_k960", 1, 8, 8192, 960, 64, "pools"),
    ("invalid_keys_s512_k96", 4, 8, 512, 96, 64, "invalid"),
    ("all_future_s64_k40", 2, 4, 64, 40, 64, "future"),
    ("pools_s256_k100_d128", 2, 2, 256, 100, 128, "pools"),
    ("pools_s2048_k200", 2, 4, 2048, 200, 64, "pools"),
]


def flash_bwd_magnitudes(q, k, v, lse, do, delta, scale, window, causal, kv_len):
    """(mag_dq, mag_dk, mag_dv), each (B, H, S, D) fp32, from the plain
    version's fp32 p and ds."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa

    p = torch.exp(q @ k.transpose(-1, -2) * scale - lse)
    mask = fa._visible(q.shape[2], q.device, causal, window, None, kv_len)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), device=p.device))
    ds = (p * (do @ v.transpose(-1, -2) - delta) * scale).abs()
    return ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(), p.transpose(-1, -2) @ do.abs()


def small_kv_bwd_magnitudes(q, k, v, key_pos, do, scale):
    import torch

    from forde_tpu_torch.ops import nsa_attention as nsa

    w = torch.softmax(nsa._masked_scores(q, k, key_pos, scale), dim=-1)
    dw = do @ v.transpose(-1, -2)
    ds = (w * (dw - (dw * w).sum(-1, keepdim=True)) * scale).abs()
    return ds @ k.abs(), ds.transpose(-1, -2) @ q.abs(), w.transpose(-1, -2) @ do.abs()


def phase_check_training_kernels(device) -> dict:
    """flash_bwd (its dq and dk/dv kernels) and small_kv_bwd against their
    plain versions run in fp32 on the same values, FLASH_BWD_CASES and
    SMALL_KV_BWD_CASES in fp32 and bf16; the gradients of flash_attention
    and small_kv_attention on CUDA tensors against the kernels they wrap.
    Returns the worst max |error| of each kernel."""
    import torch

    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.ops import nsa_attention as nsa

    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0, "small_kv_bwd": 0.0}
    gen = torch.Generator(device=device).manual_seed(SEED + 30)

    def hold(name, case, dtype_name, got, want, mag, tol):
        atol, rtol = tol[dtype_name]
        err, ratio = held_against(got, want, atol, rtol * (want.abs() + mag))
        finite = bool(torch.isfinite(got).all())
        ok = ratio <= 1.0 and finite
        log(f"[check] {name} {case} {dtype_name}: max|Δ| {err:.3e}, worst |Δ| / ({atol:g} + "
            f"{rtol:.4g}(|plain| + mag)) {ratio:.3f} (tol 1), finite {finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {case} {dtype_name}")
        worst[name] = max(worst[name], err)

    def as_precise(name, case, got, plain, exact):
        """The kernel's bf16 result is as far from the exact (fp32) one as
        its plain version run in bf16, within BF16_AS_PRECISE."""
        err_k = ((got.float() - exact).norm() / exact.norm()).item()
        err_p = ((plain.float() - exact).norm() / exact.norm()).item()
        ok = err_k <= BF16_AS_PRECISE * err_p + 1e-6
        log(f"[check] {name} {case} bfloat16: relative L2 error kernel {err_k:.4e}, plain "
            f"version in bf16 {err_p:.4e} (tol {BF16_AS_PRECISE:g}x) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} is less precise in bf16 than its plain version: {case}")

    for case, b, h, s, d, causal, window, with_dlse in FLASH_BWD_CASES:
        x = [torch.randn(b, h, s, d, device=device, generator=gen) for _ in range(4)]
        (q, k, v), kv_len = pad_for_flash(*x[:3], s, d, causal)
        scale = d ** -0.5
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            o, lse = fa.flash_fwd(qd, kd, vd, scale, window, causal, kv_len)
            do = torch.zeros_like(o)
            do[:, :, :s, :d] = x[3].to(dt)  # the padded rows get no gradient
            dlse = (torch.randn(b, h, o.shape[2], 1, device=device, generator=gen)
                    if with_dlse else None)
            got = fa.flash_bwd(qd, kd, vd, o, lse, do, scale, window, causal, kv_len, dlse)
            f32 = [t.float() for t in (qd, kd, vd, o)]
            want = fa.flash_bwd_reference(*f32, lse, do.float(), scale, window, causal, kv_len,
                                          dlse)
            delta = fa._delta(o, do, dlse)
            mags = flash_bwd_magnitudes(f32[0], f32[1], f32[2], lse, do.float(), delta, scale,
                                        window, causal, kv_len)
            torch.cuda.synchronize()
            for part, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
                name = "flash_bwd_dq" if part == "dq" else "flash_bwd_dkv"
                hold(name, f"{case} {part}", dtype_name, g, w, m, TOL_BWD)
            if dtype_name == "bfloat16":
                plain = fa.flash_bwd_reference(qd, kd, vd, o, lse, do, scale, window, causal,
                                               kv_len, dlse)
                for part, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
                    name = "flash_bwd_dq" if part == "dq" else "flash_bwd_dkv"
                    as_precise(name, f"{case} {part}", g, p, w)
            if dtype_name == "float32" and not with_dlse:
                # flash_attention's gradient on CUDA is these kernels' output.
                leaves = [t.to(dt).requires_grad_(True) for t in x[:3]]
                out = fa.flash_attention(*leaves, causal=causal, window_size=window, scale=scale)
                out.backward(x[3])
                for part, leaf, g in zip(("dq", "dk", "dv"), leaves, got):
                    if not torch.equal(leaf.grad, g[:, :, :s, :d]):
                        raise AssertionError(f"flash_attention's {part} on CUDA is not flash_bwd's: {case}")
            del o, lse, do, got, want, mags, f32
        del x, q, k, v
        torch.cuda.empty_cache()

    for case, b, h, s, kk, d, kind in SMALL_KV_BWD_CASES:
        q, g_out = (torch.randn(b, h, s, d, device=device, generator=gen) for _ in range(2))
        k, v = (torch.randn(b, h, kk, d, device=device, generator=gen) for _ in range(2))
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        scale = d ** -0.5
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            qd, kd, vd, dod = (t.to(dt) for t in (q, k, v, g_out))
            got = nsa.small_kv_bwd(qd, kd, vd, key_pos, dod, scale)
            again = nsa.small_kv_bwd(qd, kd, vd, key_pos, dod, scale)
            same = all(torch.equal(a, g) for a, g in zip(again, got))
            log(f"[check] small_kv_bwd {case} {dtype_name}: dq, dk, dv of two calls "
                f"bit-identical {same} {'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"small_kv_bwd is not deterministic: {case} {dtype_name}")
            del again
            f32 = [t.float() for t in (qd, kd, vd)]
            want = nsa.small_kv_bwd_reference(*f32, key_pos, dod.float(), scale)
            mags = small_kv_bwd_magnitudes(*f32, key_pos, dod.float(), scale)
            torch.cuda.synchronize()
            for part, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
                hold("small_kv_bwd", f"{case} {part}", dtype_name, g, w, m, TOL_SKV_BWD)
            if dtype_name == "bfloat16" and kind != "future":
                plain = nsa.small_kv_bwd_reference(qd, kd, vd, key_pos, dod, scale)
                for part, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
                    as_precise("small_kv_bwd", f"{case} {part}", g, p, w)
            if kind == "future" and (got[0].abs().max().item() != 0.0
                                     or got[1].abs().max().item() != 0.0):
                raise AssertionError("small_kv_bwd: a row with no visible key moved dq or dk")
            if dtype_name == "float32":
                leaves = [t.clone().requires_grad_(True) for t in (qd, kd, vd)]
                nsa.small_kv_attention(*leaves, key_pos, scale=scale).backward(dod)
                for part, leaf, g in zip(("dq", "dk", "dv"), leaves, got):
                    if not torch.equal(leaf.grad, g):
                        raise AssertionError(
                            f"small_kv_attention's {part} on CUDA is not small_kv_bwd's: {case}")
            del got, want, mags
    return worst


# The reference-default decoder at full width, through the serving CLI's
# derivation of the config (benchmarks/decoder.py's configuration):
# vocab 50,257, d 512, 12 layers, 8 heads x 64, expert hidden 2048 (top-2
# of 8, dense dispatch), NSA window 512, ratio 8, top-k 64, 4 mHC streams
# with 5 Sinkhorn iterations, max_seq_len 2048, bf16.
SERVE_FLAGS = [
    "--d_model", "512", "--num_layers", "12", "--num_heads", "8", "--num_experts", "8",
    "--top_k_experts", "2", "--window_size", "512", "--num_streams", "4",
    "--seq_len", "2048", "--bf16",
]
# 8 prompts spread over 640-1,920 tokens, every one past the window, so
# every NSA branch is live; 32 new tokens each.
SERVE_PROMPT_LENS = (640, 823, 1005, 1188, 1371, 1554, 1737, 1920)
SERVE_NEW_TOKENS = 32
SAMPLED_PROMPT_LEN = 1536


def serve_config():
    from forde_tpu_torch import serve

    return serve.config_from_args(serve.build_parser().parse_args(SERVE_FLAGS))


def serve_prompts(vocab_size: int):
    rng = np.random.RandomState(SEED + 10)
    return [rng.randint(1, vocab_size, n).tolist() for n in SERVE_PROMPT_LENS]


def serve_batch(prompts, device):
    """(right-padded ids (B, P_max), lengths (B,)) on ``device``."""
    import torch

    lens = torch.tensor([len(p) for p in prompts])
    padded = torch.zeros(len(prompts), int(lens.max()), dtype=torch.int64)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = torch.tensor(p)
    return padded.to(device), lens.to(device)


def serve_launches(cfg, new_tokens: int) -> dict:
    """Kernel launches of one cached generation: the prefill runs the NSA
    forward (flash_fwd for the local branch, small_kv_fwd for the
    compressed and top-k branches, per layer), each later token one decode
    step (small_kv_fwd twice per layer; the local ring is plain)."""
    n = cfg.num_layers
    return {"flash_fwd": n, "small_kv_fwd": 2 * n + (new_tokens - 1) * 2 * n}


def phase_serve_path(device, workdir) -> dict:
    """serve.main at SERVE_FLAGS from a checkpoint of seeded random weights:
    the ragged greedy batch (--prompts_file, --output_file), then one
    sampled prompt (--prompt_ids, temperature 0.8, top-k 50, top-p 0.95)."""
    import torch

    from forde_tpu_torch import interop, kernels, serve
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.train.checkpoint import save_params

    cfg = serve_config()
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = FORDEDecoderLM(cfg, device=device, generator=gen)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ckpt = os.path.join(workdir, "lm_ckpt")
    t0 = time.perf_counter()
    save_params(ckpt, cfg, interop.flatten(interop.state_dict_to_flax(state)), {"step": 0})
    del model
    log(f"[serve] checkpoint of {sum(v.numel() for v in state.values()) / 1e6:.1f} M "
        f"values written in {time.perf_counter() - t0:.2f} s")

    prompts = serve_prompts(cfg.vocab_size)
    pfile, ofile = os.path.join(workdir, "prompts.txt"), os.path.join(workdir, "out.jsonl")
    with open(pfile, "w") as f:
        f.writelines(",".join(map(str, p)) + "\n" for p in prompts)
    common = ["--checkpoint_dir", ckpt, "--max_new_tokens", str(SERVE_NEW_TOKENS)]

    def run(argv):
        """serve.main with its printout kept to the [serve] lines (it also
        prints every row's token ids)."""
        printed = io.StringIO()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rows = serve.main(argv)
        torch.cuda.synchronize()
        secs, launches = time.perf_counter() - t0, dict(kernels.launches)
        for line in printed.getvalue().splitlines():
            if line.startswith("[serve]"):
                log(f"[serve]   {line}")
        return rows, launches, secs

    want = serve_launches(cfg, SERVE_NEW_TOKENS)
    rows, launches, secs = run(common + ["--prompts_file", pfile, "--output_file", ofile,
                                         "--temperature", "0"])
    log(f"[serve] serve.main, {len(prompts)} prompts of {SERVE_PROMPT_LENS[0]}-{SERVE_PROMPT_LENS[-1]} "
        f"tokens, {SERVE_NEW_TOKENS} new, greedy: {secs:.2f} s including the checkpoint "
        f"load; launches {launches}")
    with open(ofile) as f:
        written = [json.loads(ln) for ln in f]
    for p, row, line in zip(prompts, rows, written):
        if (row[: len(p)] != p or len(row) != len(p) + SERVE_NEW_TOKENS
                or not all(0 <= t < cfg.vocab_size for t in row) or line["output_ids"] != row):
            raise AssertionError("serving batch: a row lost its prompt, length or vocabulary")
    if len(rows) != len(prompts) or launches != want:
        raise AssertionError(f"serving batch launches {launches}, expected {want}")

    sampled = np.random.RandomState(SEED + 11).randint(
        1, cfg.vocab_size, SAMPLED_PROMPT_LEN).tolist()
    rows2, launches2, secs2 = run(common + [
        "--prompt_ids", ",".join(map(str, sampled)), "--temperature", "0.8", "--top_k", "50",
        "--top_p", "0.95", "--seed", str(SEED)])
    log(f"[serve] serve.main, one prompt of {SAMPLED_PROMPT_LEN} tokens, sampled (T 0.8, "
        f"top-k 50, top-p 0.95): {secs2:.2f} s; launches {launches2}; new ids "
        f"{rows2[0][SAMPLED_PROMPT_LEN:SAMPLED_PROMPT_LEN + 8]}...")
    row = rows2[0]
    if (row[:SAMPLED_PROMPT_LEN] != sampled or len(row) != SAMPLED_PROMPT_LEN + SERVE_NEW_TOKENS
            or not all(0 <= t < cfg.vocab_size for t in row) or launches2 != want):
        raise AssertionError(f"sampled prompt: launches {launches2}, expected {want}")
    return {"launches": launches, "launches_sampled": launches2, "seconds": secs,
            "state": state, "cfg": cfg}


# Phase 9 bar: the relative L2 of the prefill's last logits, kernel path
# vs all-plain path, both bf16, must stay under this share of the control
# (plain bf16 vs plain fp32 on the same weights). Both paths round every
# activation to bf16; the kernels round p (or w) before the product with v
# where the plain attention rounds the normalised weights, so the two
# differ by bf16 roundings and by the MoE routing flips these cause, which
# twelve layers of random weights carry far. Readings (NVIDIA H100, the
# same in every run): kernel vs plain 0.277, control 0.543, kernel bf16
# vs plain fp32 0.526. The bar sits between the reading and the control:
# a path that is only less precise than the plain bf16 one fails it.
SERVE_PARITY_OF_CONTROL = 0.75
SERVE_PARITY_NEW = 16


def phase_serve_parity(device, state) -> dict:
    """The greedy batch on the kernel path against the all-plain path from
    the same weights: identical tokens in fp32; in bf16 the relative L2
    of the prefill's last logits beside the plain-bf16-vs-plain-fp32
    control."""
    import torch

    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.models.generate import generate_ragged, nsa_prefill

    cfg = serve_config()
    padded, lens = serve_batch(serve_prompts(cfg.vocab_size), device)

    def build(dtypes, impl):
        m = FORDEDecoderLM(cfg.replace(dtypes=dtypes, attention_impl=impl), device=device)
        m.load_state_dict(state)
        return m.eval()

    out, last = {}, {}
    for name, dtypes, impl in (("kernel32", DTypePolicy.fp32(), "auto"),
                               ("plain32", DTypePolicy.fp32(), "reference"),
                               ("kernel16", DTypePolicy.bf16(), "auto"),
                               ("plain16", DTypePolicy.bf16(), "reference")):
        m = build(dtypes, impl)
        _, last[name] = nsa_prefill(m, padded, lens)
        if name.endswith("32"):
            out[name] = generate_ragged(m, padded, lens, None, max_new_tokens=SERVE_PARITY_NEW,
                                        temperature=0.0)
        del m
        torch.cuda.empty_cache()
    for name, t in last.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite last logits on the {name} path")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    same = bool(torch.equal(out["kernel32"], out["plain32"]))
    differ = (out["kernel32"] != out["plain32"]).nonzero().tolist()
    readings = {
        "fp32_last_logits": rel(last["kernel32"], last["plain32"]),
        "bf16_last_logits": rel(last["kernel16"], last["plain16"]),
        "control_plain_bf16_vs_fp32": rel(last["plain16"], last["plain32"]),
        "kernel_bf16_vs_plain_fp32": rel(last["kernel16"], last["plain32"]),
    }
    bar = SERVE_PARITY_OF_CONTROL * readings["control_plain_bf16_vs_fp32"]
    log(f"[serve parity] fp32 greedy tokens ({SERVE_PARITY_NEW} new x {len(lens)} rows), kernel path vs "
        f"all-plain path: identical {same}" + ("" if same else f", first differing {differ[:4]}"))
    log("[serve parity] relative L2 of the prefill's last logits: " + ", ".join(
        f"{k} {v:.3e}" for k, v in readings.items()) + f"; bf16 bar {bar:.3e} "
        f"({SERVE_PARITY_OF_CONTROL:g} x control)")
    if not same:
        raise AssertionError("fp32 greedy tokens differ between the kernel and all-plain paths")
    if not readings["bf16_last_logits"] < bar:
        raise AssertionError(f"bf16 last logits: {readings['bf16_last_logits']:.3e} >= {bar:.3e}")
    return readings


def flash_fwd_bound(b, h, s, d, window, causal, kv_len, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one flash_fwd: q, k, v read once,
    o and lse written once; 4 * D operations per (query, visible key)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = 4 * b * h * s * d * elem + b * h * s * 4
    rows = np.arange(s)
    hi = rows + 1 if causal else np.full(s, s if kv_len is None else kv_len)
    lo = np.maximum(rows - window + 1, 0) if window is not None else np.zeros(s, int)
    pairs = float(np.maximum(hi - lo, 0).sum())
    ops = 4.0 * d * b * h * pairs
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def small_kv_bound(q, k, key_pos, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one small_kv_fwd: q, k, v and
    key_pos read once, out written once; 4 * D operations per visible
    (query, key) pair, and 2 * D per real key for a query that sees none
    (the uniform quirk averages v)."""
    import torch

    from forde_tpu_torch.ops.nsa_attention import INVALID_KEY_POS

    b, h, s, d = q.shape
    kk = k.shape[2]
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = (2 * b * h * s * d + 2 * b * h * kk * d) * elem + b * kk * 4
    pos = torch.arange(s, device=q.device)[None, :, None]
    real = key_pos[:, None, :] < INVALID_KEY_POS
    vis = (pos >= key_pos[:, None, :]) & real  # (B, S, K)
    n_vis = vis.sum(-1)
    pairs = float(n_vis.sum()) + 0.5 * float((real.sum(-1) * (n_vis == 0)).sum())
    ops = 4.0 * d * h * pairs
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def phase_serve_timing(device, state) -> dict:
    """The 8-prompt batch in bf16: time to first token (generate_ragged
    with one new token: the prefill and its sample) and the whole
    generation of SERVE_NEW_TOKENS, kernel path vs all-plain path in turns;
    ms per output token = (whole - first) / (new - 1); output tokens/s.
    One prefill and one decode step under the profiler."""
    import torch

    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.models.generate import generate_ragged, nsa_prefill

    cfg = serve_config()
    padded, lens = serve_batch(serve_prompts(cfg.vocab_size), device)
    models = {}
    for impl in ("auto", "reference"):
        m = FORDEDecoderLM(cfg.replace(attention_impl=impl), device=device)
        m.load_state_dict(state)
        models[impl] = m.eval()

    def gen_ms(m, new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_ragged(m, padded, lens, None, max_new_tokens=new, temperature=0.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def measure(m, reps=3):
        gen_ms(m, 2)  # warm-up
        first = float(np.median([gen_ms(m, 1) for _ in range(reps)]))
        whole = float(np.median([gen_ms(m, SERVE_NEW_TOKENS) for _ in range(reps)]))
        return first, whole

    # plain, kernel, kernel, plain: the two paths share the card in turns.
    p1, k1, k2, p2 = (measure(models[i]) for i in ("reference", "auto", "auto", "reference"))
    (ttft, whole), (plain_ttft, plain_whole) = min(k1, k2), min(p1, p2)
    per_token = (whole - ttft) / (SERVE_NEW_TOKENS - 1)
    plain_per_token = (plain_whole - plain_ttft) / (SERVE_NEW_TOKENS - 1)
    out_tok_s = len(SERVE_PROMPT_LENS) * SERVE_NEW_TOKENS / whole * 1e3
    log(f"[time] serving, {len(SERVE_PROMPT_LENS)} prompts of {SERVE_PROMPT_LENS[0]}-"
        f"{SERVE_PROMPT_LENS[-1]} tokens "
        f"(bf16): time to first token kernel path {k1[0]:.2f} / {k2[0]:.2f} ms, plain path "
        f"{p1[0]:.2f} / {p2[0]:.2f} ms; {SERVE_NEW_TOKENS} new tokens kernel path "
        f"{k1[1]:.2f} / {k2[1]:.2f} ms, plain path {p1[1]:.2f} / {p2[1]:.2f} ms (median of 3)")
    log(f"[time] serving: ms per output token (decode step, batch {len(SERVE_PROMPT_LENS)}) kernel path "
        f"{per_token:.3f}, plain path {plain_per_token:.3f}; output tokens/s kernel path "
        f"{out_tok_s:.1f}, plain path "
        f"{len(SERVE_PROMPT_LENS) * SERVE_NEW_TOKENS / plain_whole * 1e3:.1f}")

    model = models["auto"]
    del models["reference"]
    torch.cuda.empty_cache()
    prefill = profile_device(
        lambda: generate_ragged(model, padded, lens, None, max_new_tokens=1, temperature=0.0),
        f"one prefill ({len(SERVE_PROMPT_LENS)} prompts, generate_ragged with 1 new token)")
    with torch.inference_mode():
        cache, last = nsa_prefill(model, padded, lens)
        token = last.argmax(-1)
        decode = profile_device(lambda: model(token[:, None], cache=cache, positions=lens),
                                f"one decode step (batch {len(SERVE_PROMPT_LENS)})")
    return {"ttft_ms": ttft, "ms_per_output_token": per_token, "out_tokens_per_s": out_tok_s,
            "plain_ttft_ms": plain_ttft, "plain_ms_per_output_token": plain_per_token,
            "prefill_idle_share": prefill["idle_share"],
            "decode_step_idle_share": decode["idle_share"]}


# Timed shapes: (name, B, H, S, D, window) of flash_fwd, the serving
# prefill and the streaming side; (name, B, H, S, K, keys) of small_kv_fwd,
# one prefill layer's two launches and one decode step's two.
FLASH_FWD_TIMING = [
    ("serve_prefill_s2048_window512", 8, 8, 2048, 64, WINDOW),
    ("stream_s8192_window512", 1, 8, 8192, 64, WINDOW),
]
SMALL_KV_TIMING = [
    ("prefill_pools_s2048_k192", 8, 8, 2048, 192, "pools"),
    ("prefill_topk_s2048_k64", 8, 8, 2048, 64, "topk"),
    ("decode_pools_s1_k256", 8, 8, 1, 256, "decode_pools"),
    ("decode_topk_s1_k64", 8, 8, 1, 64, "decode_topk"),
]


def phase_serving_kernel_timing(device) -> dict:
    """Per call of flash_fwd and small_kv_fwd at the serving shapes (bf16):
    kernel, plain version, SDPA with the same mask (a yardstick only: the
    port never calls it) and the bound. Inputs cycle through copies that
    together exceed the 50 MB L2."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.ops import nsa_attention as nsa

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    bf16 = torch.bfloat16
    out = {"flash_fwd": {}, "small_kv_fwd": {}}
    for name, b, h, s, d, window in FLASH_FWD_TIMING:
        copies = max(2, -(-200_000_000 // (3 * b * h * s * d * 2)))
        inputs = [[torch.randn(b, h, s, d, device=device, generator=gen).to(bf16)
                   for _ in range(3)] for _ in range(copies)]
        pos = torch.arange(s, device=device)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        scale = d ** -0.5

        def sdpa(q, k, v, mask=mask, scale=scale):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        with torch.inference_mode():
            out["flash_fwd"][name] = time_kernel(
                f"flash_fwd {name} (B={b}, H={h}, S={s}, D={d}, bf16)",
                [lambda i=i: fa.flash_fwd(*i, scale, window, True, None) for i in inputs],
                [lambda i=i: fa.flash_fwd_reference(*i, scale, window, True, None)
                 for i in inputs[:2]],
                [lambda i=i: sdpa(*i) for i in inputs],
                *flash_fwd_bound(b, h, s, d, window, True, None, "bfloat16"),
                B=b, H=h, S=s, D=d, window=window)
        del inputs
        torch.cuda.empty_cache()

    for name, b, h, s, kk, kind in SMALL_KV_TIMING:
        d = 64
        per_copy = (b * h * s * d + 2 * b * h * kk * d) * 2
        copies = max(2, -(-200_000_000 // per_copy))
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        inputs = [(torch.randn(b, h, s, d, device=device, generator=gen).to(bf16),
                   *(torch.randn(b, h, kk, d, device=device, generator=gen).to(bf16)
                     for _ in range(2))) for _ in range(copies)]
        qpos = torch.arange(s, device=device)[None, None, :, None]
        kpos = key_pos[:, None, None, :]
        add = torch.where(qpos >= kpos, 0.0, nsa.NEG_BIG)
        add = torch.where(kpos >= nsa.INVALID_KEY_POS, -float("inf"), add).to(bf16)
        scale = d ** -0.5
        with torch.inference_mode():
            out["small_kv_fwd"][name] = time_kernel(
                f"small_kv_fwd {name} (B={b}, H={h}, S={s}, K={kk}, D={d}, bf16)",
                [lambda i=i: nsa.small_kv_fwd(*i, key_pos, scale) for i in inputs],
                [lambda i=i: nsa.small_kv_fwd_reference(*i, key_pos, scale) for i in inputs],
                [lambda i=i: F.scaled_dot_product_attention(*i, attn_mask=add, scale=scale)
                 for i in inputs],
                *small_kv_bound(inputs[0][0], inputs[0][1], key_pos, "bfloat16"),
                B=b, H=h, S=s, K=kk, D=d)
        del inputs
    return out


# ---------------------------------------------------------------------------
# The decoder LM's training path (train.loop), at the serving phases' width
# ---------------------------------------------------------------------------

# The training CLI at the reference-default width (SERVE_FLAGS: d 512, 12
# layers, 8 heads x 64, MoE top-2 of 8 dense, NSA window 512, 4 mHC
# streams, bf16) on batches of 8 x 2,048 seeded Markov tokens: 6 steps, the
# MoE slow loop every 3rd.
TRAIN_LM_STEPS = 6
TRAIN_LM_ARGV = SERVE_FLAGS + [
    "--batch_size", "8", "--use_markov_data", "--steps_per_epoch", str(TRAIN_LM_STEPS),
    "--slow_loop_interval", "3", "--log_interval", "3",
]
# The long-S route: the same width at 2 layers, one step of 1 x 8,192
# tokens, where the JAX package runs its streaming kernels and NSA has
# (8192 - 512) / 8 = 960 pools.
LONG_LM_ARGV = [
    "--d_model", "512", "--num_layers", "2", "--num_heads", "8", "--num_experts", "8",
    "--top_k_experts", "2", "--window_size", "512", "--num_streams", "4",
    "--seq_len", "8192", "--bf16", "--batch_size", "1", "--use_markov_data",
    "--steps_per_epoch", "1", "--slow_loop_interval", "0", "--log_interval", "1",
]
LM_SERVE_NEW = 8
LM_SEQ = 2048  # the positions of the parity and timing batches


def lm_launches_per_step(cfg) -> dict:
    """Kernel launches of one training step of the decoder LM: per layer
    the NSA local branch (flash_fwd and its two backward kernels) and the
    compressed and top-k branches (small_kv_fwd and small_kv_bwd twice)."""
    n = cfg.num_layers
    return {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "small_kv_fwd": 2 * n, "small_kv_bwd": 2 * n}


def run_train_loop(argv, workdir) -> tuple:
    """train.loop.main(argv) from ``workdir`` (its metrics land in ./runs):
    (result, launches, seconds, peak GiB allocated)."""
    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.train import loop

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = loop.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        os.chdir(cwd)
    return out, launches, secs, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_train_lm_path(device, workdir) -> dict:
    """train.loop.main at TRAIN_LM_ARGV with a checkpoint: finite loss,
    exact launches, two brain updates that were not skipped; serve.main
    then decodes from the trained checkpoint."""
    import torch

    from forde_tpu_torch import kernels, serve
    from forde_tpu_torch.train import loop

    ckpt = os.path.join(workdir, "lm_train_ckpt")
    argv = TRAIN_LM_ARGV + ["--checkpoint_dir", ckpt, "--seed", str(SEED)]
    cfg = loop.config_from_args(loop.build_parser().parse_args(argv))
    out, launches, secs, peak = run_train_loop(argv, workdir)
    loss = out["final_metrics"]["loss/total"]
    log(f"[train_lm] train.loop.main ({' '.join(TRAIN_LM_ARGV)}) took {secs:.2f} s; final loss "
        f"{loss:.4f} (lm {out['final_metrics']['loss/lm']:.4f}), peak memory allocated "
        f"{peak:.2f} GiB, launches {launches}")
    if not np.isfinite(loss) or out["step"] != TRAIN_LM_STEPS:
        raise AssertionError(f"LM training path: loss {loss}, steps {out['step']}")
    want = {k: TRAIN_LM_STEPS * v for k, v in lm_launches_per_step(cfg).items()}
    if launches != want:
        raise AssertionError(f"LM training path launches {launches}, expected {want}")
    updates = out["brain_updates"]
    for u in updates:
        log(f"[train_lm] MoE slow loop @ {u['step']}: {u['latency_ms']:.2f} ms, skipped "
            f"{u['skipped']}, load imbalance {u['load_imbalance']:.4g}, routing entropy "
            f"{u['routing_entropy']:.4g}, router biases moved {u['updates_count']}")
    if [u["step"] for u in updates] != [3, 6] or any(
        u["skipped"] or u["updates_count"] != cfg.num_layers for u in updates
    ):
        raise AssertionError(f"MoE slow loop of the LM training path: {updates}")

    prompt = np.random.RandomState(SEED + 12).randint(1, cfg.vocab_size, 700).tolist()
    printed = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(printed):
        rows = serve.main(["--checkpoint_dir", ckpt, "--prompt_ids", ",".join(map(str, prompt)),
                           "--max_new_tokens", str(LM_SERVE_NEW), "--temperature", "0"])
    torch.cuda.synchronize()
    served = dict(kernels.launches)
    row = rows[0]
    if (row[: len(prompt)] != prompt or len(row) != len(prompt) + LM_SERVE_NEW
            or not all(0 <= t < cfg.vocab_size for t in row)
            or served != serve_launches(cfg, LM_SERVE_NEW)
            or f"restored step {TRAIN_LM_STEPS}" not in printed.getvalue()):
        raise AssertionError(f"serving the trained checkpoint: launches {served}, row {row[-8:]}")
    log(f"[train_lm] serve.main served the trained checkpoint (step {TRAIN_LM_STEPS}): a prompt "
        f"of {len(prompt)} tokens, greedy {row[len(prompt):]}; launches {served}")
    return {"launches": launches, "seconds": secs, "final_loss": loss,
            "peak_gib": peak, "brain_update_ms": [u["latency_ms"] for u in updates]}


def phase_long_lm_path(workdir) -> dict:
    """One step of train.loop.main at LONG_LM_ARGV (S = 8192, K = 960)."""
    from forde_tpu_torch.train import loop

    args = loop.build_parser().parse_args(LONG_LM_ARGV)
    cfg = loop.config_from_args(args)
    out, launches, secs, peak = run_train_loop(LONG_LM_ARGV + ["--seed", str(SEED)], workdir)
    loss = out["final_metrics"]["loss/total"]
    pools = (args.seq_len - cfg.window_size) // cfg.compression_ratio
    log(f"[train_lm] long S: train.loop.main ({' '.join(LONG_LM_ARGV)}) took {secs:.2f} s; "
        f"loss {loss:.4f}, {pools} pools per row, peak memory allocated {peak:.2f} GiB, "
        f"launches {launches}")
    if not np.isfinite(loss) or launches != lm_launches_per_step(cfg):
        raise AssertionError(f"long-S training step: loss {loss}, launches {launches}")
    return {"launches": launches, "seconds": secs, "loss": loss, "peak_gib": peak}


def lm_batch(batch: int, seq: int, vocab: int, device, seed: int) -> dict:
    import torch

    from forde_tpu_torch.data.lm import MarkovDataset

    host = next(iter(MarkovDataset(batch, seq, vocab, num_batches=1, seed=seed)))
    return {"input_ids": torch.from_numpy(host["input_ids"]).to(device)}


def lm_weights(cfg, device) -> dict:
    import torch

    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    model = FORDEDecoderLM(cfg, device=device, generator=gen)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def lm_train_state(cfg, weights, device, dtypes=None, impl="auto"):
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.train.state import create_train_state

    cfg = cfg.replace(attention_impl=impl, **({} if dtypes is None else {"dtypes": dtypes}))
    model = FORDEDecoderLM(cfg, device=device)
    model.load_state_dict(weights)
    return create_train_state(cfg, None, 3e-4, 0.01, model=model)


class plain_lm_kernels:
    """Context: every kernel wrapper of the decoder LM's path takes its
    plain version on CUDA tensors too (the all-plain path of phase 12):
    the same arithmetic as the kernels, in PyTorch operations."""

    NAMES = (("flash_attention", "flash_fwd"), ("flash_attention", "flash_bwd_dq"),
             ("flash_attention", "flash_bwd_dkv"), ("nsa_attention", "small_kv_fwd"),
             ("nsa_attention", "small_kv_bwd"))

    def __enter__(self):
        import importlib

        self.saved = []
        for module, name in self.NAMES:
            mod = importlib.import_module(f"forde_tpu_torch.ops.{module}")
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(mod, f"{name}_reference"))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# Phase 12 bars. One training step of the reference-default decoder from
# the same weights and batch (2 x 2,048): the relative L2 of the loss, the
# gradients (Adam's first moment after the step, i.e. 0.1 x the clipped
# gradient) and the parameters after the AdamW update, kernel path vs the
# all-plain path (every kernel replaced by its plain version). fp32 bars:
# summation order, and what that order flips (an MoE routing choice or an
# NSA top-k selection whose two candidates lie within fp32 noise; Adam's
# first step, ~lr * sign(g), for gradients at noise level; the parameters
# dilute the update by |update| / |params| ~ 1e-2). bf16: at random
# initialisation a fifth to a half of the NSA top-k selections and a tenth
# to a third of the MoE routings flip between ANY two bf16 runs (ties of
# bf16 importance scores and router logits), so one batch's bf16 step is
# chaotic: on an NVIDIA H100 two paths that are equally precise per
# kernel read 0.15-0.63 apart on three batches, and the plain path's own
# control 0.23-0.67 (scripts/lm_bf16_step_chaos.py shows the flips). So
# the bf16 bar holds the mean over LM_PARITY_SEEDS' batches of each reading
# to 1.5x the mean of its control (plain bf16 vs plain fp32); phase 3
# holds each kernel's bf16 error to its plain version's. The plain attention path (attention_impl="reference") is read
# beside them: fp32 to the same bars; its bf16 backward is autograd in fp32
# (ds and delta unrounded), so its bf16 readings are reported, not held.
LM_PARITY_BATCH = 2
LM_PARITY_SEEDS = (SEED + 41, SEED + 50, SEED + 51)
LM_PARITY_TOL_FP32 = {"loss": 1e-4, "grads": 5e-2, "params": 2e-3}
LM_PARITY_OF_CONTROL = 1.5


def phase_lm_step_parity(device) -> dict:
    """One training step of the reference-default decoder on the kernel
    path, the all-plain path (the kernels' plain versions) and the plain
    attention path (attention_impl="reference"): fp32 and bf16 on the
    first batch, bf16 and its control on every batch of LM_PARITY_SEEDS;
    and the launches of the kernel path's step."""
    import contextlib as ctx

    import torch

    from forde_tpu_torch import kernels
    from forde_tpu_torch.core.config import DTypePolicy
    from forde_tpu_torch.train.step import train_step

    cfg = serve_config()
    weights = lm_weights(cfg, device)
    launches = {}

    def one_step(name, seed):
        """The step of path ``name`` (kernel / plain / reference + 32 / 16)
        on the batch of ``seed``."""
        dtypes = DTypePolicy.fp32() if name.endswith("32") else DTypePolicy.bf16()
        impl = "reference" if name.startswith("reference") else "auto"
        state = lm_train_state(cfg, weights, device, dtypes, impl)
        batch = lm_batch(LM_PARITY_BATCH, LM_SEQ, cfg.vocab_size, device, seed)
        kernels.reset_launches()
        with plain_lm_kernels() if name.startswith("plain") else ctx.nullcontext():
            state, m = train_step(state, batch, aux_loss_weight=0.01)
        torch.cuda.synchronize()
        launches[name] = dict(kernels.launches)
        out = {"loss": m["loss/total"].reshape(1).float(),
               "grads": torch.cat([t.flatten().float() for t in state.optimizer.mu]),
               "params": torch.cat([t.detach().flatten().float() for t in state.optimizer.params])}
        del state
        torch.cuda.empty_cache()
        if not all(bool(torch.isfinite(v).all()) for v in out.values()):
            raise AssertionError(f"non-finite step on the {name} path")
        return out

    def rel(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm()) for k in a}

    readings = {}
    first = {name: one_step(name, LM_PARITY_SEEDS[0]) for name in (
        "kernel32", "plain32", "reference32", "kernel16", "plain16", "reference16")}
    readings["fp32"] = rel(first["kernel32"], first["plain32"])
    readings["reference_fp32"] = rel(first["kernel32"], first["reference32"])
    readings["reference_bf16"] = rel(first["kernel16"], first["reference16"])
    readings["reference_control"] = rel(first["reference16"], first["reference32"])
    per_batch = [(rel(first["kernel16"], first["plain16"]), rel(first["plain16"], first["plain32"]))]
    del first
    for seed in LM_PARITY_SEEDS[1:]:
        run = {name: one_step(name, seed) for name in ("kernel16", "plain16", "plain32")}
        per_batch.append((rel(run["kernel16"], run["plain16"]), rel(run["plain16"], run["plain32"])))
        del run
    for i, (bf16, control) in enumerate(per_batch):
        readings[f"bf16_batch{i}"], readings[f"control_batch{i}"] = bf16, control
    readings["bf16"] = {k: float(np.mean([b[k] for b, _ in per_batch])) for k in per_batch[0][0]}
    readings["control"] = {k: float(np.mean([c[k] for _, c in per_batch])) for k in per_batch[0][1]}
    for name, r in readings.items():
        log(f"[lm parity] {name}: relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
    want = lm_launches_per_step(cfg)
    log(f"[lm parity] launches of one step: kernel path {launches['kernel32']}, all-plain "
        f"path {launches['plain32']}, plain attention path {launches['reference32']}")
    if (launches["kernel32"] != want or launches["kernel16"] != want
            or any(v for k, v in launches.items() if not k.startswith("kernel"))):
        raise AssertionError(f"launches of one training step: {launches}, expected {want}")
    for name in ("fp32", "reference_fp32"):
        for k, tol in LM_PARITY_TOL_FP32.items():
            if not readings[name][k] <= tol:
                raise AssertionError(f"LM step parity {name} {k}: {readings[name][k]:.3e} > {tol:g}")
    for k, v in readings["bf16"].items():
        bar = LM_PARITY_OF_CONTROL * readings["control"][k]
        if not v <= bar:
            raise AssertionError(f"LM step parity bf16 {k} (mean of {len(per_batch)} batches): "
                                 f"{v:.3e} > {bar:.3e}")
    return {"readings": readings, "launches_per_step": launches["kernel16"]}


def phase_lm_train_timing(device) -> dict:
    """The training step of the reference-default decoder, bf16, batch 8 x
    2,048: median of 5 after 2 warm-ups (host clock ending in a
    synchronize), tokens/s, the MoE slow loop's latency, one step under
    the profiler."""
    import torch

    from forde_tpu_torch.brain.slow_loop import moe_slow_loop_step
    from forde_tpu_torch.train.step import train_step

    cfg = serve_config()
    state = lm_train_state(cfg, lm_weights(cfg, device), device)
    batch = lm_batch(8, LM_SEQ, cfg.vocab_size, device, SEED + 42)

    def step():
        train_step(state, batch, aux_loss_weight=0.01)

    for _ in range(2):
        step()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    tokens = 8 * LM_SEQ / step_ms * 1e3
    log(f"[time] LM train step (8 x 2048, bf16): {' / '.join(f'{t:.1f}' for t in times)} ms, "
        f"median {step_ms:.2f} ms, {tokens:.0f} tokens/s")

    gen = torch.Generator(device=device).manual_seed(SEED + 43)
    slow = []
    for _ in range(3):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diag = moe_slow_loop_step(state.model, cfg, gen)
        skipped = bool(diag["skipped"])
        torch.cuda.synchronize()
        slow.append((time.perf_counter() - t0) * 1e3)
        if skipped:
            raise AssertionError("the timed MoE slow loop skipped its update")
    log(f"[time] MoE slow loop ({cfg.num_layers} layers x {cfg.num_experts} experts): {' / '.join(f'{t:.2f}' for t in slow)} ms")
    prof = profile_device(step, "one LM train step (8 x 2048, bf16)", top=16)
    return {"step_ms": step_ms, "step_ms_all": times, "tokens_per_s": tokens,
            "slow_loop_ms": float(np.median(slow)), "idle_share": prof["idle_share"],
            "busy_ms": prof["busy_ms"]}


def flash_bwd_bound(b, h, s, d, window, causal, part, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one flash_bwd_dq or
    flash_bwd_dkv call: q, k, v, do, lse and delta read once, dq (or dk and
    dv) written once; 2 * D operations per product and visible (query,
    key): three products for dq (q k^T, do v^T, ds k), four for dk/dv
    (q k^T, do v^T, p^T do, ds^T q)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    outs = 1 if part == "dq" else 2
    moved = (4 + outs) * b * h * s * d * elem + 2 * b * h * s * 4
    _, fwd_ops_ms = flash_fwd_bound(b, h, s, d, window, causal, None, dtype_name)
    products = 3 if part == "dq" else 4
    return moved / HBM_BYTES_PER_S * 1e3, fwd_ops_ms * products / 2


def small_kv_bwd_bound(q, k, key_pos, dtype_name) -> tuple:
    """(ms by bytes, ms by operations) of one small_kv_bwd: q, do, k, v and
    key_pos read once, dq, dk, dv written once; 10 * D operations per
    visible (query, key) pair (q k^T, do v^T, w^T do, ds k, ds^T q), and
    2 * D per real key for a query that sees none (its uniform weights
    reach dv only)."""
    import torch

    from forde_tpu_torch.ops.nsa_attention import INVALID_KEY_POS

    b, h, s, d = q.shape
    kk = k.shape[2]
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = (3 * b * h * s * d + 4 * b * h * kk * d) * elem + b * kk * 4
    pos = torch.arange(s, device=q.device)[None, :, None]
    real = key_pos[:, None, :] < INVALID_KEY_POS
    n_vis = ((pos >= key_pos[:, None, :]) & real).sum(-1)  # (B, S)
    blind = float((real.sum(-1) * (n_vis == 0)).sum())
    ops = (10.0 * float(n_vis.sum()) + 2.0 * blind) * d * h
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


# Timed shapes of the backward kernels: (name, B, H, S, window) of the
# 4-D backward at the training step and on the streaming side; (name, B,
# H, S, K, keys) of small_kv_bwd, one step layer's two launches and the
# 960 pools of S = 8192.
FLASH_BWD_TIMING = [
    ("train_s2048_window512", 8, 8, 2048, WINDOW),
    ("stream_s8192_window512", 1, 8, 8192, WINDOW),
]
SMALL_KV_BWD_TIMING = [
    ("train_pools_s2048_k192", 8, 8, 2048, 192, "pools"),
    ("train_topk_s2048_k64", 8, 8, 2048, 64, "topk"),
    ("long_pools_s8192_k960", 1, 8, 8192, 960, "pools"),
]


def phase_training_kernel_timing(device) -> dict:
    """Per call of flash_bwd_dq, flash_bwd_dkv and small_kv_bwd at the
    training shapes (bf16, D 64): kernel, plain version, the backward of
    SDPA with the same mask (a yardstick only: the port never calls it;
    it computes dq, dk and dv in one call, so both 4-D kernels carry it)
    and the bound. Inputs cycle through copies that together exceed the
    50 MB L2."""
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa
    from forde_tpu_torch.ops import nsa_attention as nsa

    gen = torch.Generator(device=device).manual_seed(SEED + 44)
    bf16, d = torch.bfloat16, 64
    scale = d ** -0.5
    out = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}, "small_kv_bwd": {}}
    for name, b, h, s, window in FLASH_BWD_TIMING:
        copies = max(2, -(-200_000_000 // (4 * b * h * s * d * 2)))
        pos = torch.arange(s, device=device)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        inputs = []
        for _ in range(copies):
            q, k, v, do = (torch.randn(b, h, s, d, device=device, generator=gen).to(bf16)
                           for _ in range(4))
            o, lse = fa.flash_fwd(q, k, v, scale, window, True, None)
            delta = fa._delta(o, do, None)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
            inputs.append(((q, k, v, do, lse, delta, scale, window, True, None), o_lib, do))
        shape = {"B": b, "H": h, "S": s, "D": d, "window": window}
        library = [lambda i=i: i[1].backward(i[2], retain_graph=True) for i in inputs]
        for part, kernel, plain in (("dq", fa.flash_bwd_dq, fa.flash_bwd_dq_reference),
                                    ("dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_reference)):
            out[f"flash_bwd_{part}"][name] = time_kernel(
                f"flash_bwd_{part} {name} (B={b}, H={h}, S={s}, D={d}, bf16)",
                [lambda i=i: kernel(*i[0]) for i in inputs],
                [lambda i=i: plain(*i[0]) for i in inputs[:2]],
                library, *flash_bwd_bound(b, h, s, d, window, True, part, "bfloat16"), **shape)
        del inputs, library
        torch.cuda.empty_cache()

    for name, b, h, s, kk, kind in SMALL_KV_BWD_TIMING:
        per_copy = (2 * b * h * s * d + 2 * b * h * kk * d) * 2
        copies = max(2, -(-200_000_000 // per_copy))
        key_pos = small_kv_key_pos(kind, b, s, kk, device, gen)
        qpos = torch.arange(s, device=device)[None, None, :, None]
        kpos = key_pos[:, None, None, :]
        add = torch.where(qpos >= kpos, 0.0, nsa.NEG_BIG)
        add = torch.where(kpos >= nsa.INVALID_KEY_POS, -float("inf"), add).to(bf16)
        inputs = []
        for _ in range(copies):
            q, do = (torch.randn(b, h, s, d, device=device, generator=gen).to(bf16) for _ in range(2))
            k, v = (torch.randn(b, h, kk, d, device=device, generator=gen).to(bf16) for _ in range(2))
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=add, scale=scale)
            inputs.append(((q, k, v, key_pos, do, scale), o_lib, do))
        out["small_kv_bwd"][name] = time_kernel(
            f"small_kv_bwd {name} (B={b}, H={h}, S={s}, K={kk}, D={d}, bf16)",
            [lambda i=i: nsa.small_kv_bwd(*i[0]) for i in inputs],
            [lambda i=i: nsa.small_kv_bwd_reference(*i[0]) for i in inputs[:2]],
            [lambda i=i: i[1].backward(i[2], retain_graph=True) for i in inputs],
            *small_kv_bwd_bound(inputs[0][0][0], inputs[0][0][1], key_pos, "bfloat16"),
            B=b, H=h, S=s, K=kk, D=d)
        del inputs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "forde_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    phase_build()
    max_err = dict(zip(("flash_mha_fwd", "flash_mha_bwd"), phase_check_attention(device)))
    max_err["moment_sums"] = phase_check_moments(device)
    max_err.update(phase_check_serving_kernels(device))
    max_err.update(phase_check_training_kernels(device))

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as workdir:
        main_run = phase_main_path(device, workdir)
        train_run = phase_train_path(workdir)
        serve_run = phase_serve_path(device, workdir)
        lm_run = phase_train_lm_path(device, workdir)
        long_run = phase_long_lm_path(workdir)
    check_prefetch(device)
    parity = phase_step_parity(device)
    timing = phase_encode_timing(device, main_run["model"], main_run["cfg"])
    shapes = phase_kernel_timing(device, main_run["cfg"], timing["encode_ms"])
    train_timing = phase_train_timing(device)
    serve_parity = phase_serve_parity(device, serve_run["state"])
    serve_timing = phase_serve_timing(device, serve_run["state"])
    shapes.update(phase_serving_kernel_timing(device))
    lm_parity = phase_lm_step_parity(device)
    lm_timing = phase_lm_train_timing(device)
    shapes.update(phase_training_kernel_timing(device))

    def by_path(name):
        return {"embed": main_run["launches"].get(name, 0),
                "train": train_run["launches"].get(name, 0),
                "serve": serve_run["launches"].get(name, 0),
                "train_lm": lm_run["launches"].get(name, 0),
                "train_lm_s8192": long_run["launches"].get(name, 0)}

    entries = []
    for name, replaces in (
        ("flash_mha_fwd", "forde_tpu/ops/flash_attention.py:992"),
        ("flash_mha_bwd", "forde_tpu/ops/flash_attention.py:1036"),
        ("moment_sums", "forde_tpu/ops/stat_sums.py:28"),
    ):
        v, t = shapes[name]["vision"], shapes[name]["text"]
        bound_ms, bound_by = bound(
            v["bytes_ms"] + t["bytes_ms"], v["operations_ms"] + t["operations_ms"]
        )
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"forde_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            # The training path's run (phase 5); the other paths' below.
            "launches": train_run["launches"].get(name, 0),
            "launches_by_path": by_path(name),
            "max_abs_err": max_err[name],
            # One call at the vision shape plus one at the text shape (a
            # layer of each tower at batch 128); "shapes" has each alone.
            "ms": v["ms"] + t["ms"],
            "plain_ms": v["plain_ms"] + t["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if v["library_ms"] is None else v["library_ms"] + t["library_ms"],
            "shapes": shapes[name],
        })
    # The serving path's kernels: flash_fwd at the serving prefill (one
    # launch per layer), small_kv_fwd at one prefill layer's two launches
    # (compressed pools and top-k); "shapes" has the streaming S and the
    # decode shapes.
    for name, replaces, also, parts in (
        ("flash_fwd", "forde_tpu/ops/flash_attention.py:98",
         "forde_tpu/ops/flash_attention.py:428", ("serve_prefill_s2048_window512",)),
        ("small_kv_fwd", "forde_tpu/ops/nsa_attention.py:115", None,
         ("prefill_pools_s2048_k192", "prefill_topk_s2048_k64")),
    ):
        ts = [shapes[name][part] for part in parts]
        bound_ms, bound_by = bound(sum(t["bytes_ms"] for t in ts),
                                   sum(t["operations_ms"] for t in ts))
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"forde_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            **({"also_replaces": also} if also else {}),
            "launches": serve_run["launches"].get(name, 0),
            "launches_by_path": by_path(name),
            "max_abs_err": max_err[name],
            "ms": sum(t["ms"] for t in ts),
            "plain_ms": sum(t["plain_ms"] for t in ts),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sum(t["library_ms"] for t in ts),
            "shapes": shapes[name],
        })
    # The LM training path's kernels: the 4-D backward at the training
    # step's shape (one launch of each per layer), small_kv_bwd at one step
    # layer's two launches; "shapes" has the streaming S = 8192 and K = 960.
    # SDPA's backward computes dq, dk and dv in one call: both 4-D kernels
    # carry its time as library_ms.
    for name, replaces, also, parts in (
        ("flash_bwd_dq", "forde_tpu/ops/flash_attention.py:201",
         "forde_tpu/ops/flash_attention.py:481", ("train_s2048_window512",)),
        ("flash_bwd_dkv", "forde_tpu/ops/flash_attention.py:250",
         "forde_tpu/ops/flash_attention.py:528", ("train_s2048_window512",)),
        ("small_kv_bwd", "forde_tpu/ops/nsa_attention.py:126", None,
         ("train_pools_s2048_k192", "train_topk_s2048_k64")),
    ):
        ts = [shapes[name][part] for part in parts]
        bound_ms, bound_by = bound(sum(t["bytes_ms"] for t in ts),
                                   sum(t["operations_ms"] for t in ts))
        source = "flash_bwd" if name.startswith("flash_bwd") else name
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"forde_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            **({"also_replaces": also} if also else {}),
            "launches": lm_run["launches"].get(name, 0),
            "launches_by_path": by_path(name),
            "max_abs_err": max_err[name],
            "ms": sum(t["ms"] for t in ts),
            "plain_ms": sum(t["plain_ms"] for t in ts),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sum(t["library_ms"] for t in ts),
            "shapes": shapes[name],
        })
    result = {
        "kernels": entries,
        "encode_ms_batch128": timing["encode_ms"],
        "plain_encode_ms_batch128": timing["plain_encode_ms"],
        "pairs_per_s": timing["pairs_per_s"],
        "min_cosine_vs_plain": {
            k: main_run[f"min_cosine_{k}"] for k in ("fp32", "bf16", "plain_bf16_vs_fp32")
        },
        "train_path": {k: train_run[k] for k in ("seconds", "final_loss", "brain_update_ms")},
        "train_step_batch128": train_timing,
        "step_parity": parity,
        "serve_path": {"seconds": serve_run["seconds"], "launches": serve_run["launches"],
                       "launches_sampled": serve_run["launches_sampled"]},
        "serve_batch8": serve_timing,
        "serve_parity": serve_parity,
        "train_lm_path": {k: lm_run[k] for k in
                          ("seconds", "final_loss", "peak_gib", "brain_update_ms")},
        "train_lm_s8192": {k: long_run[k] for k in ("seconds", "loss", "peak_gib")},
        "train_lm_step_8x2048": lm_timing,
        "train_lm_step_parity": lm_parity,
        "card": smi,
    }
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
