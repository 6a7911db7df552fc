#!/usr/bin/env python3
"""Smoke test of forde_tpu_torch on one NVIDIA GPU (H100).

Drives the port's dual-encoder embedding path at the full width of the
production ViT-B preset (``vit_b16_hd128``, bf16, seeded random weights)
through the user's entry point, ``forde_tpu_torch.embed.main``, and holds
every CUDA kernel of that path against its plain PyTorch version:

  1. device: name, and name + power limit from nvidia-smi;
  2. build every kernel under forde_tpu_torch/csrc from the checkout;
  3. kernel vs plain version on the card, fp32 and bf16, at the shapes of
     the path and at the mask options (kv_lens with 0, kv_bound, causal +
     window);
  4. the main path: a port checkpoint, .npy images (one resized) and
     texts of different lengths through ``embed.main``; finite (N, 512)
     embeddings, 24 kernel launches (12 + 12 layers), and the cosine of
     each embedding against the same weights on the all-plain attention
     path in the same dtype (>= 0.99999 in fp32, >= 0.997 in bf16);
  5. timing at the serving batch (128 images + 128 texts): encode time,
     pairs/s, and per attention call the kernel, its plain version,
     PyTorch's scaled_dot_product_attention (timed as a yardstick only,
     the port never calls it) and the least time the card could take.

Prints the kernels' JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises: exit code != 0.
Run with no arguments on a machine with one GPU (well under 20 minutes):

  python3 chip_smoke.py
"""

from __future__ import annotations

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

# Phase 3 tolerances on o, per element: |o - plain| <= atol + rtol * |plain|,
# where the plain version runs in fp32 on the same input values (a bf16
# input is widened exactly). The kernel multiplies and sums in fp32 too,
# so fp32 differs by summation order (atol), and in bf16 the kernel's one
# extra step is rounding o to bf16: at most half a bf16 ulp, 2^-8 of the
# value (rtol). lse is fp32 in both types.
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


def attention_bound(b, s, h, d, dtype_name, lens=None) -> tuple:
    """(ms by bytes, ms by operations) of one fused-qkv attention forward
    at the card's peaks. Bytes: qkv read once, o and lse written once,
    lens read. Operations: 2 * 2 * D per (query, visible key, head) for
    the two products, counting the keys these inputs leave visible."""
    elem = 2 if dtype_name == "bfloat16" else 4
    moved = b * s * 3 * h * d * elem + b * s * h * d * elem + b * h * s * 4
    keys = b * s if lens is None else int(lens.clamp(max=s).sum())
    if lens is not None:
        moved += 4 * b
    ops = 4.0 * h * d * s * keys
    return moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype_name] * 1e3


def bound(bytes_ms: float, ops_ms: float) -> tuple:
    """(bound_ms, bound_by): the larger of the two times."""
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


# Every kernel of the main path: csrc/<name>.cu.
KERNEL_SOURCES = ("flash_mha_fwd",)


def phase_build():
    from forde_tpu_torch.kernels import build

    t0 = time.perf_counter()
    for name in KERNEL_SOURCES:
        build.load(name)
    log(f"[build] {len(KERNEL_SOURCES)} kernel(s) ready in {time.perf_counter() - t0:.2f} s "
        f"under {build.BUILD_DIR}")
    for name, (secs, text) in build.build_log.items():
        log(f"[build] nvcc {name}: {secs:.2f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")


# (name, B, S, H, D, kv_lens, causal, window): the vision and text shapes
# of vit_b16_hd128, the S=197 / D=64 shape that needs kv_bound, and the
# causal + window option.
CHECK_CASES = [
    ("vision_s200_h6_d128", 4, 200, 6, 128, None, False, None),
    ("text_s64_h4_d128_lens", 4, 64, 4, 128, [0, 1, 17, 64], False, None),
    ("s197_h12_d64_kv_bound", 2, 197, 12, 64, None, False, None),
    ("s128_h2_d64_causal_window32", 2, 128, 2, 64, None, True, 32),
    ("s200_h2_d128_causal_window32_lens", 3, 200, 2, 128, [200, 0, 5], True, 32),
]


def phase_check(device) -> float:
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa

    worst = 0.0
    gen = torch.Generator(device=device).manual_seed(SEED)
    for name, b, s, h, d, lens, causal, window in CHECK_CASES:
        x = torch.randn(b, s, 3 * h * d, device=device, generator=gen) * 0.5
        lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=device)
        s_pad = -(-s // 8) * 8
        kv_bound = s if (s_pad != s and not causal and lens is None) else None
        if s_pad != s:
            x = F.pad(x, (0, 0, 0, s_pad - s))
        for dtype_name in ("float32", "bfloat16"):
            qkv = x.to(getattr(torch, dtype_name)).contiguous()
            args = (lens_t, h, d, d ** -0.5, window, causal, kv_bound)
            o, lse = fa.flash_mha_fwd(qkv, *args)
            o_ref, lse_ref = fa.flash_mha_fwd_reference(qkv.float(), *args)
            torch.cuda.synchronize()
            atol, rtol = TOL_O[dtype_name]
            diff = (o.float() - o_ref).abs()
            err = diff.max().item()
            ratio = (diff / (atol + rtol * o_ref.abs())).max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            ok = ratio <= 1.0 and lse_err <= TOL_LSE
            log(f"[check] {name} {dtype_name}: max|o - plain| {err:.3e}, worst "
                f"|o - plain| / ({atol:g} + {rtol:g}|plain|) {ratio:.3f} (tol 1), "
                f"max|lse - plain| {lse_err:.3e} (tol {TOL_LSE:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_mha_fwd disagrees with its plain version: {name} {dtype_name}")
            if lens is not None:
                for i, n in enumerate(lens):
                    if n == 0 and o[i].abs().max().item() != 0.0:
                        raise AssertionError(f"{name}: kv_lens == 0 rows are not zero")
            worst = max(worst, err)
    # The public entry point at S=197 pads to 200 and bounds the keys.
    x = torch.randn(2, 197, 3 * 12 * 64, device=device, generator=gen, dtype=torch.float32)
    got = fa.flash_mha(x, 12, 64)
    want = fa.flash_mha_reference(x, 12, 64)
    err = (got - want).abs().max().item()
    log(f"[check] flash_mha S=197 vs flash_mha_reference: {err:.3e}")
    if not err <= TOL_O["float32"][0]:
        raise AssertionError("flash_mha at S=197 disagrees with flash_mha_reference")
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
    from forde_tpu_torch.train.checkpoint import save_clip_params

    cfg = main_path_config()
    model = build_model(cfg, device)
    ckpt = os.path.join(workdir, "ckpt")
    npz = interop.flatten(interop.state_dict_to_flax(model.state_dict()))
    save_clip_params(ckpt, cfg, npz, {"step": 0})

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


def phase_timing(device, model, cfg) -> dict:
    import torch
    import torch.nn.functional as F

    from forde_tpu_torch.ops import flash_attention as fa

    batch = 128
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    images = torch.rand(batch, cfg.image_size, cfg.image_size, 3, device=device, generator=gen)
    lens = torch.randint(8, cfg.max_text_len + 1, (batch,), device=device, generator=gen)
    pos = torch.arange(cfg.max_text_len, device=device)
    mask = (pos[None, :] < lens[:, None]).to(torch.int32)
    ids = torch.randint(1, cfg.vocab_size, (batch, cfg.max_text_len), device=device,
                        generator=gen) * mask

    def encode_ms(m, reps=5):
        with torch.inference_mode():
            for _ in range(2):
                m.encode_image(images)
                m.encode_text(ids, mask)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                m.encode_image(images)
                m.encode_text(ids, mask)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder

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

    shapes = {}
    tw_v, tw_t = cfg.vision, cfg.text
    for name, tw, s, shape_lens in (
        ("vision", tw_v, model.vision.pos_embed.shape[1], None),
        ("text", tw_t, cfg.max_text_len, lens.to(torch.int32)),
    ):
        h, d = tw.num_heads, tw.head_dim
        nbytes = batch * s * 3 * h * d * 2
        copies = max(2, -(-200_000_000 // nbytes))  # > 4x the 50 MB L2 in total
        qkvs = [
            (torch.randn(batch, s, 3 * h * d, device=device, generator=gen) * 0.5)
            .to(torch.bfloat16) for _ in range(copies)
        ]
        scale = d ** -0.5
        args = (shape_lens, h, d, scale, None, False, None)
        k_ms = cuda_ms([lambda q=q: fa.flash_mha_fwd(q, *args) for q in qkvs])
        p_ms = cuda_ms([lambda q=q: fa.flash_mha_fwd_reference(q, *args) for q in qkvs])
        attn_mask = None if shape_lens is None else (
            pos[None, None, None, :s] < shape_lens[:, None, None, None]
        )

        def sdpa(q):
            qq, kk, vv = q.view(batch, s, 3, h, d).unbind(2)
            return F.scaled_dot_product_attention(
                qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                attn_mask=attn_mask, scale=scale,
            )

        l_ms = cuda_ms([lambda q=q: sdpa(q) for q in qkvs])
        bytes_ms, ops_ms = attention_bound(batch, s, h, d, "bfloat16", shape_lens)
        b_ms, b_by = bound(bytes_ms, ops_ms)
        shapes[name] = {
            "B": batch, "S": s, "H": h, "D": d, "dtype": "bfloat16",
            "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
        }
        log(f"[time] flash_mha_fwd {name} (B={batch}, S={s}, H={h}, D={d}, bf16): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        del qkvs
    attn_share = (
        tw_v.num_layers * shapes["vision"]["ms"] + tw_t.num_layers * shapes["text"]["ms"]
    ) / kernel_ms
    log(f"[time] attention kernel share of the kernel-path encode: {attn_share:.3f}")
    profile_encode(model, images, ids, mask)
    return {
        "shapes": shapes, "encode_ms": kernel_ms, "plain_encode_ms": plain_ms,
        "pairs_per_s": batch / kernel_ms * 1e3,
    }


def profile_encode(model, images, ids, mask, top: int = 12) -> None:
    """Device time by kernel over one encode (128 images + 128 texts) under
    torch.profiler, and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model.encode_image(images)
        model.encode_text(ids, mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.encode_image(images)
            model.encode_text(ids, mask)
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
    log(f"[profile] one encode: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for ms, count, name in kernels_ms[:top]:
        log(f"[profile]   {ms:9.3f} ms {ms / busy_ms:6.3f}  x{count:<4d} {name[:90]}")


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
    max_err = phase_check(device)

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as workdir:
        main_run = phase_main_path(device, workdir)
    timing = phase_timing(device, main_run["model"], main_run["cfg"])

    v, t = timing["shapes"]["vision"], timing["shapes"]["text"]
    bound_ms, bound_by = bound(
        v["bytes_ms"] + t["bytes_ms"], v["operations_ms"] + t["operations_ms"]
    )
    entry = {
        "name": "flash_mha_fwd",
        "route": "cuda",
        "source": "forde_tpu_torch/csrc/flash_mha_fwd.cu",
        "replaces": "forde_tpu/ops/flash_attention.py:992",
        "launches": main_run["launches"].get("flash_mha_fwd", 0),
        "max_abs_err": max_err,
        # One call at the vision shape plus one at the text shape (a layer
        # of each tower at batch 128); "shapes" has each on its own.
        "ms": v["ms"] + t["ms"],
        "plain_ms": v["plain_ms"] + t["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": v["library_ms"] + t["library_ms"],
        "shapes": timing["shapes"],
    }
    result = {
        "kernels": [entry],
        "encode_ms_batch128": timing["encode_ms"],
        "plain_encode_ms_batch128": timing["plain_encode_ms"],
        "pairs_per_s": timing["pairs_per_s"],
        "min_cosine_vs_plain": {
            k: main_run[f"min_cosine_{k}"] for k in ("fp32", "bf16", "plain_bf16_vs_fp32")
        },
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
