"""Attention of every query against a small key set: the NSA compressed
and top-k branches (port of forde_tpu/ops/nsa_attention.py).

    key j is visible to query position p iff p >= key_pos[b, j]

Masked scores are -1e9, not -inf: a query with no visible key gets a
UNIFORM distribution over the real keys (the reference's quirk). A key
whose threshold is >= ``INVALID_KEY_POS`` is padding: its score is -inf,
outside even that uniform distribution (the ragged prefill hides the
pools a row does not have this way).

``small_kv_attention`` is the entry point. With ``impl`` "auto" (and the
JAX config's "pallas" or "interpret") it runs ``SmallKVAttention`` (the
JAX package's ``_small_kv_pallas`` custom_vjp): the forward wrapper
``small_kv_fwd`` launches ``csrc/small_kv_fwd.cu`` and the backward wrapper
``small_kv_bwd`` launches ``csrc/small_kv_bwd.cu`` on every CUDA tensor;
on a CPU tensor they run their plain versions ``small_kv_fwd_reference``
and ``small_kv_bwd_reference``. bf16 runs on the tensor cores, and so
does the fp32 backward, each product three TF32 passes; the fp32 forward
runs on the CUDA cores, its keys cut into chunks over blocks and the
chunks' partial softmaxes merged in chunk order. The backward is a dq
kernel and a dk/dv kernel over chunks of the queries, whose partials are
summed in chunk order. Every sum has a fixed order, and the result is
the same from run to run. The JAX package picks its TPU kernels only when
S*K >= 2M, a threshold measured on a TPU v5e; the port has no threshold.
"reference" runs ``small_kv_attention_ref``, differentiated by autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from forde_tpu_torch import kernels
from forde_tpu_torch.kernels import build
from forde_tpu_torch.ops.flash_attention import _check_aligned

NEG_BIG = -1e9
INVALID_KEY_POS = 2**30
KERNEL_IMPLS = ("auto", "pallas", "interpret")
# The backward kernels keep the key thresholds in shared memory, which
# bounds K (the decoder LM's sets are 64 to 256 keys at its 2048 positions;
# 960 pools at 8192 positions). The forward takes more (a decode step's
# pools at a long max_seq_len: 4,096 at 16,384 positions, ratio 4).
MAX_KEYS = 1024
FWD_MAX_KEYS = 8192
# The dk/dv kernel starts one block per 64 keys of a (sample, head) and per
# chunk of the queries, the fp32 forward one per query tile of a (sample,
# head) and per chunk of the keys; chunks are added until about this many
# blocks (two per SM of an H100) are in flight.
TARGET_BLOCKS = 264
# The fp32 forward's query tile: one row up to this many rows (a decode
# step), else 32 rows.
FWD_ROW_MAX_S = 8

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


def _check_kernel_args(name, max_keys, q, k, v, key_pos, *others):
    """Raise on what the CUDA kernels do not take (at most ``max_keys``
    keys); returns q, k, v and ``others`` contiguous and key_pos as
    contiguous int32."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {q.device}")
    b, h, s, d = q.shape
    kk = k.shape[2]
    if k.shape != (b, h, kk, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({b}, {h}, K, {d}), got {tuple(k.shape)}")
    if key_pos.shape != (b, kk):
        raise ValueError(f"key_pos must be ({b}, {kk}), got {tuple(key_pos.shape)}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, *others)):
        raise TypeError(f"{name} takes float32 or bfloat16 inputs of one dtype")
    if d not in (64, 128):
        raise ValueError(f"{name} takes head_dim 64 or 128, got {d}")
    if not 0 < kk <= max_keys:
        raise ValueError(f"{name} takes 1 to {max_keys} keys, got {kk}")
    for t in (k, v, key_pos, *others):
        if t.device != q.device:
            raise ValueError(f"k, v, key_pos and do must be on {q.device}")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"do must be {tuple(q.shape)}, got {tuple(t.shape)}")
    tensors = [t.contiguous() for t in (q, k, v, *others)]
    _check_aligned(name, **dict(zip(("q", "k", "v", "do"), tensors)))
    return (*tensors, key_pos.to(torch.int32).contiguous())


def _chunks(tiles: int, blocks: int) -> int:
    """How many chunks of ``tiles`` tiles a kernel that starts ``blocks``
    blocks per chunk needs to start about ``TARGET_BLOCKS``; no chunk is
    empty."""
    want = min(tiles, max(1, -(-TARGET_BLOCKS // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per)


def dkdv_chunks(b: int, h: int, s: int, kk: int) -> int:
    """How many chunks of 64-query tiles the backward's dk/dv kernel cuts
    S into: a function of the shapes alone, so that the order of the sums
    (and with it the result) does not change from run to run."""
    return _chunks(-(-s // 64), -(-kk // 64) * b * h)


def fwd_chunks(b: int, h: int, s: int, kk: int) -> int:
    """How many chunks of 64-key tiles the fp32 forward cuts K into (1 where
    the query tiles already fill the card, as a 2,048-row prefill does;
    ~64 at a decode step of 4 heads against 4,096 pools): a function of the
    shapes alone, so that a captured decode graph stays valid and the
    order of the sums does not change from run to run."""
    q_tiles = s if s <= FWD_ROW_MAX_S else -(-s // 32)
    return _chunks(-(-kk // 64), q_tiles * b * h)


def _c_function(lib, name: str, pointers: int, ints: int):
    """``lib.name`` with its arguments declared: ``pointers`` pointers,
    ``ints`` ints, the scale and the stream."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def small_kv_fwd(q, k, v, key_pos, scale: float) -> torch.Tensor:
    """The kernel's wrapper: (B, H, S, D) out in q's dtype.

    q (B, H, S, D), k and v (B, H, K, D) of one dtype (float32 or
    bfloat16), D 64 or 128 on CUDA (``small_kv_attention`` pads), K <=
    ``FWD_MAX_KEYS``; key_pos (B, K) integer. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream, or
    raises: bf16 on the tensor cores; fp32 on the CUDA cores, its keys cut
    into ``fwd_chunks`` chunks, with more than one the chunks' (m, l, acc)
    in fp32 scratch (B * H * S * chunks * (D + 2)) that a second CUDA kernel
    merges in chunk order (``forde_small_kv_fwd_split``). One call counts
    one launch.
    """
    if q.device.type == "cpu":
        return small_kv_fwd_reference(q, k, v, key_pos, scale)
    q, k, v, pos = _check_kernel_args("small_kv_fwd", FWD_MAX_KEYS, q, k, v, key_pos)
    b, h, s, d = q.shape
    kk = k.shape[2]
    out = torch.empty_like(q)
    chunks = fwd_chunks(b, h, s, kk) if q.dtype == torch.float32 else 1

    lib = build.load("small_kv_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if chunks == 1:
            err = _c_function(lib, "forde_small_kv_fwd", 5, 6)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
                b, h, s, kk, d, _DTYPE_CODES[q.dtype], scale, stream,
            )
        else:
            scratch = torch.empty(b * h * s * chunks * (d + 2), dtype=torch.float32,
                                  device=q.device)
            err = _c_function(lib, "forde_small_kv_fwd_split", 6, 6)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), b, h, s, kk, d, chunks, scale, stream,
            )
    build.check(lib, err, "small_kv_fwd")
    kernels.count("small_kv_fwd")
    return out


def small_kv_bwd_reference(q, k, v, key_pos, do, scale: float):
    """Plain version of the backward kernel: the arithmetic of the TPU
    kernel ``_bwd_kernel``. It recomputes the straight softmax w (fp32);
    dv = round(w)^T do with w rounded to do's dtype; dw = do v^T, ds = w *
    (dw - sum(dw * w)) zeroed where the mask was false (a -1e9 entry too:
    a row with no visible key adds to dv but not to dq or dk; padding
    keys get nothing), times scale, rounded to the input dtype; dq = ds k
    in q's dtype; dk = ds^T q and dv summed in fp32 and cast to k's and
    v's dtype."""
    s = _masked_scores(q, k, key_pos, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = p / p.sum(dim=-1, keepdim=True)
    dof = do.float()
    dv = torch.matmul(w.to(do.dtype).float().transpose(-1, -2), dof)
    dw = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = w * (dw - torch.sum(dw * w, dim=-1, keepdim=True))
    q_pos = torch.arange(q.shape[2], device=q.device)[None, None, :, None]
    k_pos = key_pos.to(torch.int64)[:, None, None, :]
    mask = (q_pos >= k_pos) & (k_pos < INVALID_KEY_POS)
    ds = (torch.where(mask, ds, torch.zeros((), device=ds.device)) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def small_kv_bwd(q, k, v, key_pos, do, scale: float):
    """The backward kernel's wrapper: (dq, dk, dv) in the input dtype from
    the forward's inputs and the output gradient ``do`` (B, H, S, D).
    Arguments as ``small_kv_fwd``, K <= ``MAX_KEYS``. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels on the current stream
    (on the tensor cores: bf16 products, or fp32 ones as three TF32
    passes), or raises. It allocates their scratch: the dq kernel's row
    statistics (m, l, delta: 3 * B * H * S fp32) and, with more than one
    chunk (``dkdv_chunks``), the dk/dv partials (2 * chunks * B * H * K * D
    fp32), which a last kernel sums in chunk order. The order of every sum
    is fixed: the result is the same from run to run. One call counts one
    launch, whatever number of CUDA kernels it runs."""
    if q.device.type == "cpu":
        return small_kv_bwd_reference(q, k, v, key_pos, do, scale)
    q, k, v, do, pos = _check_kernel_args("small_kv_bwd", MAX_KEYS, q, k, v, key_pos, do)
    b, h, s, d = q.shape
    kk = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    chunks = dkdv_chunks(b, h, s, kk)
    stats = torch.empty(3, b * h, s, dtype=torch.float32, device=q.device)
    part = (torch.empty(2, chunks, b * h * kk * d, dtype=torch.float32, device=q.device)
            if chunks > 1 else None)

    lib = build.load("small_kv_bwd")
    with torch.cuda.device(q.device):
        err = _c_function(lib, "forde_small_kv_bwd", 10, 7)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            None if part is None else part.data_ptr(),
            b, h, s, kk, d, _DTYPE_CODES[q.dtype], chunks, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, err, "small_kv_bwd")
    kernels.count("small_kv_bwd")
    return dq, dk, dv


class SmallKVAttention(torch.autograd.Function):
    """``small_kv_fwd`` with ``small_kv_bwd`` as its gradient (the JAX
    package's ``_small_kv_pallas`` custom_vjp): the forward saves its
    inputs, the backward recomputes the softmax. ``key_pos`` and
    ``scale`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_pos, scale):
        ctx.save_for_backward(q, k, v, key_pos)
        ctx.scale = scale
        return small_kv_fwd(q, k, v, key_pos, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_pos = ctx.saved_tensors
        dq, dk, dv = small_kv_bwd(q, k, v, key_pos, do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


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
    of 64 for the kernels."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if impl == "reference":
        return small_kv_attention_ref(q, k, v, key_pos, scale=scale)
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    d = q.shape[-1]
    d_pad = max(-(-d // 64) * 64, 64)
    if d_pad != d:
        q, k, v = (F.pad(t, (0, d_pad - d)) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    return SmallKVAttention.apply(q, k, v, key_pos, float(scale))[..., :d]
