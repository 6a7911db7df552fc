"""Attention of every query against a small key set: the NSA compressed
and top-k branches (port of forde_tpu/ops/nsa_attention.py).

    key j is visible to query position p iff p >= key_pos[b, j]

Masked scores are -1e9, not -inf: a query with no visible key gets a
UNIFORM distribution over the real keys (the reference's quirk). A key
whose threshold is >= ``INVALID_KEY_POS`` is padding: its score is -inf,
outside even that uniform distribution (the ragged prefill hides the
pools a row does not have this way).

``small_kv_attention`` is the entry point. With ``impl`` "auto" (and the
JAX config's "pallas" or "interpret") it runs ``small_kv_fwd``, the
wrapper of the hand-written kernel ``csrc/small_kv_fwd.cu``, on every CUDA
tensor, and its plain version ``small_kv_fwd_reference`` on a CPU tensor.
The JAX package picks its TPU kernel only when S*K >= 2M, a threshold
measured on a TPU v5e; the port has no threshold. "reference" runs
``small_kv_attention_ref``. The kernel's backward is not ported yet: on
CUDA a call whose inputs require grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from forde_tpu_torch import kernels
from forde_tpu_torch.kernels import build

NEG_BIG = -1e9
INVALID_KEY_POS = 2**30
KERNEL_IMPLS = ("auto", "pallas", "interpret")
# The kernel keeps the scores of a 32-row q tile against every key in
# shared memory, which bounds K (the decoder LM's sets are 64 to 256 keys
# at its 2048 positions; 960 pools at 8192 positions).
MAX_KEYS = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _masked_scores(q, k, key_pos, scale):
    """(B, H, S, K) fp32 scores with the -1e9 / -inf masks."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    q_pos = torch.arange(q.shape[2], device=q.device)[None, None, :, None]
    k_pos = key_pos.to(torch.int64)[:, None, None, :]
    scores = torch.where(q_pos >= k_pos, scores, torch.full_like(scores, NEG_BIG))
    return torch.where(
        k_pos >= INVALID_KEY_POS, torch.full_like(scores, -float("inf")), scores
    )


def small_kv_attention_ref(q, k, v, key_pos, scale: Optional[float] = None):
    """The reference's masked-softmax math on (B, H, S, D) queries and
    (B, H, K, D) keys; the weights are cast to v's dtype before the
    product with v, and the result is in v's dtype."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    weights = torch.softmax(_masked_scores(q, k, key_pos, scale), dim=-1)
    return torch.matmul(weights.to(v.dtype).float(), v.float()).to(v.dtype)


def small_kv_fwd_reference(q, k, v, key_pos, scale: float) -> torch.Tensor:
    """Plain version of the kernel: the arithmetic of the TPU kernel
    ``_fwd_kernel`` (fp32 scores, straight softmax w = p / sum(p), w
    rounded to v's dtype, fp32 sums of the products); out in q's dtype."""
    s = _masked_scores(q, k, key_pos, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(w.to(v.dtype).float(), v.float()).to(q.dtype)


def small_kv_fwd(q, k, v, key_pos, scale: float) -> torch.Tensor:
    """The kernel's wrapper: (B, H, S, D) out in q's dtype.

    q (B, H, S, D), k and v (B, H, K, D) of one dtype (float32 or
    bfloat16), D 64 or 128 on CUDA (``small_kv_attention`` pads), K <=
    ``MAX_KEYS``; key_pos (B, K) integer. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream, or
    raises.
    """
    if q.device.type == "cpu":
        return small_kv_fwd_reference(q, k, v, key_pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_kv_fwd takes CPU or CUDA tensors, got {q.device}")
    b, h, s, d = q.shape
    kk = k.shape[2]
    if k.shape != (b, h, kk, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({b}, {h}, K, {d}), got {tuple(k.shape)}")
    if key_pos.shape != (b, kk):
        raise ValueError(f"key_pos must be ({b}, {kk}), got {tuple(key_pos.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"small_kv_fwd takes float32 or bfloat16 q, k, v of one dtype")
    if d not in (64, 128):
        raise ValueError(f"small_kv_fwd takes head_dim 64 or 128, got {d}")
    if not 0 < kk <= MAX_KEYS:
        raise ValueError(f"small_kv_fwd takes 1 to {MAX_KEYS} keys, got {kk}")
    for t in (k, v, key_pos):
        if t.device != q.device:
            raise ValueError(f"k, v and key_pos must be on {q.device}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    pos = key_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)

    lib = build.load("small_kv_fwd")
    fn = lib.forde_small_kv_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, h, s, kk, d, _DTYPE_CODES[q.dtype], scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, err, "small_kv_fwd")
    kernels.launches["small_kv_fwd"] += 1
    return out


def small_kv_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_pos: torch.Tensor,
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention of (B, H, S, D) queries against a small key set
    (B, H, K, D) with per-key causal thresholds ``key_pos`` (B, K): key j
    is visible to query position p iff p >= key_pos[b, j]. Serves both
    NSA global branches: compressed (key_pos = pool end positions) and
    top-k (key_pos = selected token indices). D is padded to a multiple
    of 64 for the kernel."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if impl == "reference":
        return small_kv_attention_ref(q, k, v, key_pos, scale=scale)
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if (
        q.device.type != "cpu"
        and torch.is_grad_enabled()
        and any(t.requires_grad for t in (q, k, v))
    ):
        raise NotImplementedError(
            "small_kv_attention on CUDA is forward only: its backward kernel "
            "(_bwd_kernel of forde_tpu/ops/nsa_attention.py) is not ported "
            "yet; call it under torch.no_grad() or torch.inference_mode()"
        )
    d = q.shape[-1]
    d_pad = max(-(-d // 64) * 64, 64)
    if d_pad != d:
        q, k, v = (F.pad(t, (0, d_pad - d)) for t in (q, k, v))
    return small_kv_fwd(q, k, v, key_pos, float(scale))[..., :d]
