"""Fused-qkv flash attention of the encoder towers
(port of ``flash_mha`` in forde_tpu/ops/flash_attention.py).

``flash_mha`` reads q/k/v straight out of the (B, S, 3*H*D) output of the
qkv projection and returns (B, S, H*D) ready for the output projection:
no head split or merge copies. Its gradient is a ``torch.autograd.Function``
(``FlashMHAFused``, the JAX package's ``custom_vjp``): the forward saves the
fp32 row log-sum-exp, the backward recomputes p from it and writes dq, dk
and dv into one (B, S, 3*H*D) tensor. On a CUDA tensor the two wrappers
launch the hand-written kernels ``csrc/flash_mha_fwd.cu``
(``flash_mha_fwd``) and ``csrc/flash_mha_bwd.cu`` (``flash_mha_bwd``); on a
CPU tensor they run the kernels' plain versions
(``flash_mha_fwd_reference``, ``flash_mha_bwd_reference``). The input
dtype picks the kernels' route: bf16 runs on the tensor cores (``mma.sync``
with fp32 accumulators), fp32 on the CUDA cores (the tensor cores would
round it to TF32). The bf16 route copies tiles with 16-byte ``cp.async``,
so the wrappers refuse a tensor that does not start on a 16-byte
boundary.
``flash_mha_reference`` is the plain masked attention path the JAX package
runs as ``impl="reference"``, differentiated by autograd.

``flash_attention`` is the 4-D (B, H, S, D) causal and sliding-window
attention of the decoder LM (the JAX package's resident and streaming
kernels), also ``flash_mha``'s route for head_dim not a multiple of 64 or
S > 512. Its gradient is ``FlashAttention`` (the JAX package's
``_flash_attention_padded`` custom_vjp): the forward wrapper ``flash_fwd``
launches ``csrc/flash_fwd.cu`` and saves q, k, v, o and the fp32 lse;
``flash_bwd`` computes delta and calls the wrappers of the two kernels of
``csrc/flash_bwd.cu``, ``flash_bwd_dq`` and ``flash_bwd_dkv``. On a CPU
tensor every wrapper runs its kernel's plain version
(``flash_fwd_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``). The input dtype picks the route here too:
bf16 ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` run on the
tensor cores (``mma.sync``, 16-byte ``cp.async``, so their wrappers refuse
a tensor off a 16-byte boundary), fp32 on the CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch import kernels
from forde_tpu_torch.kernels import build
from forde_tpu_torch.ops import attention_ref

MASK_VALUE = -1e30
MAX_FUSED_SEQ = 512
KERNEL_IMPLS = ("auto", "pallas", "interpret")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _visible(s, device, causal, window, lens, kv_bound):
    """(B or 1, 1, S, S) boolean mask, True = attend; None if unmasked."""
    pos = torch.arange(s, device=device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    mask = None

    def both(a, b):
        return b if a is None else a & b

    if causal:
        mask = both(mask, q_pos >= k_pos)
    if window is not None:
        mask = both(mask, q_pos - k_pos < window)
    if kv_bound is not None:
        mask = both(mask, k_pos < kv_bound)
    mask = None if mask is None else mask[None, None]
    if lens is not None:
        mask = both(mask, (k_pos < lens.reshape(-1, 1, 1, 1)))
    return mask


def flash_mha_fwd_reference(
    qkv: torch.Tensor,
    lens: Optional[torch.Tensor],
    num_heads: int,
    head_dim: int,
    scale: float,
    window: Optional[int],
    causal: bool,
    kv_bound: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the arithmetic of the TPU kernel
    ``_mha_fwd_kernel`` on the same arguments. Returns o (B, S, H*D) in the
    input dtype and lse (B, H, S, 1) in fp32."""
    b, s, _ = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = _visible(s, qkv.device, causal, window, lens, kv_bound)
    if mask is not None:
        scores = scores.masked_fill(~mask, MASK_VALUE)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul((p / l_safe).to(v.dtype).float(), v.float())
    # Rows with every key masked (kv_lens[b] == 0) are zero.
    o = o * (m > MASK_VALUE * 0.5).to(o.dtype)
    lse = m + torch.log(l_safe)
    o = o.to(qkv.dtype).transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return o, lse


def _library(name: str, n_pointers: int) -> ctypes.CDLL:
    """The built kernel library ``csrc/<name>.cu``, its C signature
    declared: ``n_pointers`` tensors, then (batch, seq, heads, head_dim,
    dtype, scale, causal, window, kv_bound, stream)."""
    lib = build.load(name)
    fn = getattr(lib, f"forde_{name}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_args(
    name: str,
    qkv: torch.Tensor,
    lens: Optional[torch.Tensor],
    num_heads: int,
    head_dim: int,
    window: Optional[int],
) -> Optional[torch.Tensor]:
    """Raise on what the CUDA kernels do not take; returns ``lens`` as a
    contiguous int32 tensor (or None)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {qkv.device}")
    b, s, three_hd = qkv.shape
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {qkv.dtype}")
    if head_dim not in (64, 128):
        raise ValueError(f"{name} takes head_dim 64 or 128, got {head_dim}")
    if three_hd != 3 * num_heads * head_dim:
        raise ValueError(f"qkv width {three_hd} != 3 * {num_heads} * {head_dim}")
    if s > MAX_FUSED_SEQ:
        raise ValueError(f"{name} takes S <= {MAX_FUSED_SEQ}, got {s}")
    if not qkv.is_contiguous():
        raise ValueError(f"{name} needs a contiguous qkv")
    _check_aligned(name, qkv=qkv)
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if lens is None:
        return None
    if lens.shape != (b,) or lens.device != qkv.device:
        raise ValueError(f"lens must be ({b},) on {qkv.device}")
    return lens.to(torch.int32).contiguous()


def _check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the
    kernels copy tiles with 16-byte ``cp.async`` and store 16 bytes at a
    time."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs a 16-byte aligned {arg}")


def _mask_args(window, causal, kv_bound) -> tuple:
    return (
        int(causal), -1 if window is None else int(window),
        -1 if kv_bound is None else int(kv_bound),
    )


def flash_mha_fwd(
    qkv: torch.Tensor,
    lens: Optional[torch.Tensor],
    num_heads: int,
    head_dim: int,
    scale: float,
    window: Optional[int],
    causal: bool,
    kv_bound: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: o (B, S, H*D), lse (B, H, S, 1) fp32.

    ``qkv`` is (B, S, 3*H*D), float32 or bfloat16; ``lens`` an optional
    (B,) count of visible keys per sample; ``kv_bound`` an optional static
    count of visible keys; ``window`` an optional ``q - k < window`` bound.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (bf16 on the tensor cores, fp32 on the
    CUDA cores), or raises.
    """
    if qkv.device.type == "cpu":
        return flash_mha_fwd_reference(
            qkv, lens, num_heads, head_dim, scale, window, causal, kv_bound
        )
    lens = _check_kernel_args("flash_mha_fwd", qkv, lens, num_heads, head_dim, window)
    b, s, _ = qkv.shape
    o = torch.empty(b, s, num_heads * head_dim, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(b, num_heads, s, 1, dtype=torch.float32, device=qkv.device)

    lib = _library("flash_mha_fwd", 4)
    with torch.cuda.device(qkv.device):
        err = lib.forde_flash_mha_fwd(
            qkv.data_ptr(), None if lens is None else lens.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            b, s, num_heads, head_dim, _DTYPE_CODES[qkv.dtype], scale,
            *_mask_args(window, causal, kv_bound),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    build.check(lib, err, "flash_mha_fwd")
    kernels.launches["flash_mha_fwd"] += 1
    return o, lse


def flash_mha_bwd_reference(
    qkv: torch.Tensor,
    lens: Optional[torch.Tensor],
    lse: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    head_dim: int,
    scale: float,
    window: Optional[int],
    causal: bool,
    kv_bound: Optional[int],
) -> torch.Tensor:
    """Plain version of the backward kernel: the arithmetic of the TPU
    kernel ``_mha_bwd_kernel`` on the same arguments. p = exp(s - lse) is
    *selected* to 0 where masked (a row with no visible key has lse =
    -1e30 and would give inf); delta = sum(p * dp) per row; p is rounded
    to ``do.dtype`` for dv and ds to ``qkv.dtype`` for dq and dk. Returns
    dqkv (B, S, 3*H*D) in the input dtype."""
    b, s, _ = qkv.shape
    h, d = num_heads, head_dim
    q, k, v = (t.float() for t in qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4))
    dof = do.reshape(b, s, h, d).transpose(1, 2).float()
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale - lse)
    mask = _visible(s, qkv.device, causal, window, lens, kv_bound)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    pb = p.to(do.dtype).float()
    dv = torch.matmul(pb.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.transpose(-1, -2))
    delta = torch.sum(p * dp, dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(qkv.dtype).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv], dim=2)  # (B, H, 3, S, D)
    return dqkv.permute(0, 3, 2, 1, 4).reshape(b, s, 3 * h * d).to(qkv.dtype)


def flash_mha_bwd(
    qkv: torch.Tensor,
    lens: Optional[torch.Tensor],
    lse: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    head_dim: int,
    scale: float,
    window: Optional[int],
    causal: bool,
    kv_bound: Optional[int],
) -> torch.Tensor:
    """The backward kernel's wrapper: dqkv (B, S, 3*H*D) in the input
    dtype, from qkv, the forward's lse (B, H, S, 1) fp32 and the output
    gradient ``do`` (B, S, H*D) in the input dtype. Arguments as
    ``flash_mha_fwd``. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernels on the current stream (bf16 on the tensor cores,
    fp32 on the CUDA cores), or raises."""
    if qkv.device.type == "cpu":
        return flash_mha_bwd_reference(
            qkv, lens, lse, do, num_heads, head_dim, scale, window, causal, kv_bound
        )
    lens = _check_kernel_args("flash_mha_bwd", qkv, lens, num_heads, head_dim, window)
    b, s, _ = qkv.shape
    if do.shape != (b, s, num_heads * head_dim) or do.dtype != qkv.dtype:
        raise ValueError(f"do must be ({b}, {s}, {num_heads * head_dim}) {qkv.dtype}")
    if lse.shape != (b, num_heads, s, 1) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {num_heads}, {s}, 1) float32")
    if not (do.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_mha_bwd needs a contiguous do and lse")
    if do.device != qkv.device or lse.device != qkv.device:
        raise ValueError(f"do and lse must be on {qkv.device}")
    _check_aligned("flash_mha_bwd", do=do, lse=lse)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(b, num_heads, s, dtype=torch.float32, device=qkv.device)

    lib = _library("flash_mha_bwd", 6)
    with torch.cuda.device(qkv.device):
        err = lib.forde_flash_mha_bwd(
            qkv.data_ptr(), do.data_ptr(), lse.data_ptr(),
            None if lens is None else lens.data_ptr(),
            dqkv.data_ptr(), delta.data_ptr(),
            b, s, num_heads, head_dim, _DTYPE_CODES[qkv.dtype], scale,
            *_mask_args(window, causal, kv_bound),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    build.check(lib, err, "flash_mha_bwd")
    kernels.launches["flash_mha_bwd"] += 1
    return dqkv


class FlashMHAFused(torch.autograd.Function):
    """``flash_mha_fwd`` with ``flash_mha_bwd`` as its gradient (the JAX
    package's ``_flash_mha_fused`` custom_vjp). The forward saves qkv,
    lens and the fp32 lse; ``lens`` and the static arguments get no
    gradient."""

    @staticmethod
    def forward(ctx, qkv, lens, num_heads, head_dim, scale, window, causal, kv_bound):
        o, lse = flash_mha_fwd(qkv, lens, num_heads, head_dim, scale, window, causal, kv_bound)
        ctx.save_for_backward(qkv, lens, lse)
        ctx.static = (num_heads, head_dim, scale, window, causal, kv_bound)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, lens, lse = ctx.saved_tensors
        num_heads, head_dim, scale, window, causal, kv_bound = ctx.static
        dqkv = flash_mha_bwd(
            qkv, lens, lse, do.contiguous(), num_heads, head_dim, scale,
            window, causal, kv_bound,
        )
        return dqkv, None, None, None, None, None, None, None


def flash_mha_reference(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    window_size: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain masked attention over the fused qkv (the JAX package's
    ``_mha_reference_path``), (B, S, 3*H*D) -> (B, S, H*D)."""
    b, s, _ = qkv.shape
    if scale is None:
        scale = 1.0 / float(head_dim) ** 0.5
    q, k, v = qkv.reshape(b, s, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    if kv_lens is not None:
        pos = torch.arange(s, device=qkv.device)
        mask = (pos[None, :] < kv_lens.to(torch.int32)[:, None])[:, None, None, :]
        q_pos, k_pos = pos[:, None], pos[None, :]
        if causal:
            mask = mask & (q_pos >= k_pos)[None, None]
        if window_size is not None:
            mask = mask & (q_pos - k_pos < window_size)[None, None]
        o = attention_ref.mha_reference(q, k, v, mask=mask, scale=scale)
        # Rows of a sample with no visible key (kv_lens[b] == 0) are zero.
        o = o * (kv_lens > 0).to(o.dtype)[:, None, None, None]
    elif causal and window_size is not None:
        o = attention_ref.sliding_window_attention_ref(q, k, v, window_size, scale=scale)
    elif causal:
        o = attention_ref.causal_attention_ref(q, k, v, scale=scale)
    else:
        o = attention_ref.mha_reference(q, k, v, scale=scale)
    return o.transpose(1, 2).reshape(b, s, num_heads * head_dim)


def flash_mha(
    qkv: torch.Tensor,
    num_heads: int,
    head_dim: int,
    *,
    causal: bool = False,
    window_size: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Flash attention over a fused (B, S, 3*H*D) qkv, returning (B, S, H*D).

    ``kv_lens``: optional (B,) valid-key counts of right-padded batches;
    keys at positions >= kv_lens[b] are masked for every query (padded
    query rows still produce outputs, as in the JAX package).

    ``impl``: "reference" runs ``flash_mha_reference``; "auto" (and the
    JAX config's "pallas" or "interpret") run ``FlashMHAFused``: the CUDA
    kernels for a CUDA tensor, their plain versions for a CPU tensor.
    head_dim not a multiple of 64 or S > 512 go through the 4-D
    ``flash_attention``.
    """
    b, s, three_hd = qkv.shape
    if three_hd != 3 * num_heads * head_dim:
        raise ValueError(f"qkv width {three_hd} != 3 * {num_heads} * {head_dim}")
    scale = 1.0 / float(head_dim) ** 0.5 if scale is None else float(scale)
    if impl == "reference":
        return flash_mha_reference(
            qkv, num_heads, head_dim, kv_lens, causal, window_size, scale
        )
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if head_dim % 64 != 0 or s > MAX_FUSED_SEQ:
        # Outside the fused kernel's shapes: the 4-D kernels, which pad D
        # and stream k tiles.
        if kv_lens is not None:
            raise ValueError(
                "kv_lens needs the fused kernel (64-aligned head_dim, "
                f"S <= {MAX_FUSED_SEQ}); got head_dim={head_dim}, S={s}"
            )
        q, k, v = qkv.reshape(b, s, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
        o = flash_attention(
            q, k, v, causal=causal, window_size=window_size, scale=scale, impl=impl
        )
        return o.transpose(1, 2).reshape(b, s, num_heads * head_dim)

    s_pad = _ceil_to(s, 8)
    kv_bound = None
    if s_pad != s:
        qkv = F.pad(qkv, (0, 0, 0, s_pad - s))
        if not causal and kv_lens is None:
            kv_bound = s  # static mask for the padded tail
    lens = None if kv_lens is None else torch.clamp(kv_lens, max=s).to(torch.int32)
    o = FlashMHAFused.apply(
        qkv, lens, num_heads, head_dim, scale, window_size, causal, kv_bound
    )
    return o[:, :s]


# ---------------------------------------------------------------------------
# 4-D flash attention (B, H, S, D): the decoder LM's causal and
# sliding-window attention
# ---------------------------------------------------------------------------

# The kernel's q and k tile: flash_attention pads S to a multiple of it.
BLOCK = 64


def flash_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    window: Optional[int],
    causal: bool,
    kv_len: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the arithmetic of the TPU kernels
    ``_fwd_kernel`` / ``_fwd_stream_kernel`` on (B, H, S, D) q, k, v.
    Scores are fp32 products of the input values; masked scores (causal
    ``q >= k``, window ``q - k < window``, ``k < kv_len``) are -1e30;
    p = exp(s - m) is rounded to v's dtype before the product with v,
    while l sums the unrounded p. Returns o in the input dtype and lse
    (B, H, S, 1) in fp32."""
    s_len = q.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = _visible(s_len, q.device, causal, window, None, kv_len)
    if mask is not None:
        scores = scores.masked_fill(~mask, MASK_VALUE)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), m + torch.log(l_safe)


def _check_4d(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """Raise on what the 4-D CUDA kernels do not take: tensors of q's
    shape, dtype and device, float32 or bfloat16, contiguous, head_dim 64
    or 128, S a multiple of ``BLOCK``."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {q.device}")
    for t in others:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} needs inputs of one shape, dtype and device")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    s, d = q.shape[2], q.shape[3]
    if d not in (64, 128):
        raise ValueError(f"{name} takes head_dim 64 or 128, got {d}")
    if s % BLOCK:
        raise ValueError(f"{name} takes S a multiple of {BLOCK}, got {s}")
    if not all(t.is_contiguous() for t in (q, *others)):
        raise ValueError(f"{name} needs contiguous inputs")


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    window: Optional[int],
    causal: bool,
    kv_len: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: o (B, H, S, D) in the input dtype, lse
    (B, H, S, 1) fp32.

    q, k and v are (B, H, S, D), float32 or bfloat16, with S a multiple of
    ``BLOCK`` and D 64 or 128 on CUDA (``flash_attention`` pads). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel on
    the current stream (bf16 on the tensor cores, fp32 on the CUDA
    cores), or raises.
    """
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale, window, causal, kv_len)
    _check_4d("flash_fwd", q, k, v)
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, s, 1, dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:  # lse is written 4 bytes at a time
        _check_aligned("flash_fwd", q=q, k=k, v=v, o=o)

    lib = build.load("flash_fwd")
    fn = lib.forde_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, s, d, _DTYPE_CODES[q.dtype], scale,
            *_mask_args(window, causal, kv_len),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, err, "flash_fwd")
    kernels.launches["flash_fwd"] += 1
    return o, lse


def _bwd_probs(q, k, lse, scale, window, causal, kv_len):
    """fp32 p = exp(q k^T * scale - lse), *selected* to 0 where masked (a
    row with no visible key has lse = -1e30 and would give inf)."""
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale - lse)
    mask = _visible(q.shape[2], q.device, causal, window, None, kv_len)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    return p


def _bwd_ds(q, v, do, p, delta, scale):
    """ds = p * (do v^T - delta) * scale, rounded to the input dtype."""
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return (p * (dp - delta) * scale).to(q.dtype).float()


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """Plain version of the dq kernel: the arithmetic of the TPU kernels
    ``_bwd_dq_kernel`` / ``_bwd_dq_stream_kernel``: dq = ds k, with ds as
    ``_bwd_ds`` rounds it. Returns dq in the input dtype."""
    p = _bwd_probs(q, k, lse, scale, window, causal, kv_len)
    ds = _bwd_ds(q, v, do, p, delta, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """Plain version of the dk/dv kernel: the arithmetic of the TPU kernels
    ``_bwd_dkv_kernel`` / ``_bwd_dkv_stream_kernel``: dv = round(p)^T do
    with p rounded to ``do.dtype``, dk = ds^T q. Returns (dk, dv) in the
    input dtype."""
    p = _bwd_probs(q, k, lse, scale, window, causal, kv_len)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    ds = _bwd_ds(q, v, do, p, delta, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do, dlse):
    """(B, H, S, 1) fp32 rowsum(do * o) - dlse, computed outside the
    kernels from the saved o, as the TPU code does (``_bwd_pallas``)."""
    delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)
    return delta if dlse is None else delta - dlse.float()


def flash_bwd_reference(q, k, v, o, lse, do, scale, window, causal, kv_len, dlse=None):
    """Plain version of ``flash_bwd``: (dq, dk, dv) in the input dtype."""
    delta = _delta(o, do, dlse)
    args = (q, k, v, do, lse, delta, scale, window, causal, kv_len)
    return (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))


def _bwd_launch(name: str, outputs, q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """Launch ``forde_<name>`` of ``csrc/flash_bwd.cu`` on the current
    stream and count it."""
    _check_4d(name, q, k, v, do)
    b, h, s, d = q.shape
    if lse.shape != (b, h, s, 1) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be ({b}, {h}, {s}, 1) float32 on {q.device}")
    if delta.shape != lse.shape or delta.dtype != torch.float32 or delta.device != q.device:
        raise ValueError(f"delta must be ({b}, {h}, {s}, 1) float32 on {q.device}")
    lib = build.load("flash_bwd")
    fn = getattr(lib, f"forde_{name}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (6 + len(outputs)) + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lse, delta = lse.contiguous(), delta.contiguous()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outputs),
            b, h, s, d, _DTYPE_CODES[q.dtype], scale, *_mask_args(window, causal, kv_len),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, err, name)
    kernels.launches[name] += 1


def flash_bwd_dq(q, k, v, do, lse, delta, scale, window, causal, kv_len) -> torch.Tensor:
    """The dq kernel's wrapper: dq in the input dtype from (B, H, S, D) q,
    k, v, do, the forward's lse and delta (B, H, S, 1) fp32. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel, or raises."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, window, causal, kv_len)
    dq = torch.empty_like(q)
    if q.dtype == torch.bfloat16:  # lse and delta are read 4 bytes at a time
        _check_aligned("flash_bwd_dq", q=q, k=k, v=v, do=do, dq=dq)
    _bwd_launch("flash_bwd_dq", (dq,), q, k, v, do, lse, delta, scale, window, causal, kv_len)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, window, causal, kv_len):
    """The dk/dv kernel's wrapper: (dk, dv) in the input dtype; arguments
    as ``flash_bwd_dq``."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale, window, causal, kv_len)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16:  # lse and delta are read 4 bytes at a time
        _check_aligned("flash_bwd_dkv", q=q, k=k, v=v, do=do, dk=dk, dv=dv)
    _bwd_launch("flash_bwd_dkv", (dk, dv), q, k, v, do, lse, delta, scale, window, causal,
                kv_len)
    return dk, dv


def flash_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
    window: Optional[int],
    causal: bool,
    kv_len: Optional[int],
    dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``flash_fwd``: (dq, dk, dv) in the input dtype from
    q, k, v, the forward's o and lse (B, H, S, 1) fp32, and the output
    gradient ``do``; ``dlse`` an optional lse cotangent (B, H, S, 1) that
    folds in as delta - dlse. delta = rowsum(do * o) in fp32, then the dq
    kernel and the dk/dv kernel (on a CPU tensor their plain versions)."""
    delta = _delta(o, do, dlse)
    args = (q, k, v, do, lse, delta, scale, window, causal, kv_len)
    return (flash_bwd_dq(*args), *flash_bwd_dkv(*args))


class FlashAttention(torch.autograd.Function):
    """``flash_fwd`` with ``flash_bwd`` as its gradient (the JAX package's
    ``_flash_attention_padded`` custom_vjp). The forward saves q, k, v, o
    and the fp32 lse; the static arguments get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, causal, kv_len):
        o, lse = flash_fwd(q, k, v, scale, window, causal, kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.static = (scale, window, causal, kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), *ctx.static)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window_size: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Flash attention over (B, H, S, D) with causal / sliding-window
    masking (``0 <= q - k < window_size``).

    ``impl``: "reference" runs the plain masked attention
    (``attention_ref``), differentiated by autograd; "auto" (and "pallas",
    "interpret") runs ``FlashAttention``: the CUDA kernels for a CUDA
    tensor, their plain versions for a CPU tensor. As in the JAX package,
    D is padded to a multiple of 64 and S to the kernels' tile, and a
    non-causal padded call masks the padded keys with the static ``kv_len
    = S``. The JAX package sends S > 4096 (causal) to streaming kernels and
    shorter S to resident ones, a split that came from VMEM size; the CUDA
    kernels read tiles from device memory at any S, so the call is the
    same on both sides of 4096.
    """
    if impl == "reference":
        if window_size is not None and causal:
            return attention_ref.sliding_window_attention_ref(q, k, v, window_size, scale=scale)
        if causal:
            return attention_ref.causal_attention_ref(q, k, v, scale=scale)
        return attention_ref.mha_reference(q, k, v, scale=scale)
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    b, h, s, d = q.shape
    scale = 1.0 / float(d) ** 0.5 if scale is None else float(scale)
    s_pad = _ceil_to(s, BLOCK)
    d_pad = max(_ceil_to(d, 64), 64)
    if s_pad != s or d_pad != d:
        pad = (0, d_pad - d, 0, s_pad - s)
        q, k, v = (F.pad(t, pad) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    # Padded keys sit after every real query, so the causal mask already
    # hides them; without it the static bound does.
    kv_len = s if (not causal and s_pad != s) else None
    o = FlashAttention.apply(q, k, v, scale, window_size, causal, kv_len)
    return o[:, :, :s, :d]
