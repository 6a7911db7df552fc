"""Per-neuron moment sums of FORDE's sensing (port of
forde_tpu/ops/stat_sums.py).

The fast loop's statistics (activation Hoyer gini / GDP / variance, and
their gradient twins) need three column reductions over the same (N, F)
tensor: sum |x|, sum x^2 and sum x. ``moment_sums`` returns them as one
(3, F) fp32 tensor from one read of x.

On a CUDA tensor it always launches the hand-written kernel
``csrc/moment_sums.cu``. The JAX package makes its TPU kernel opt-in
(``FORDE_MOMENT_IMPL``) because a ``pallas_call`` is a scheduling barrier
in XLA's step program, and it serialised against the matmuls that XLA's
own reduction fusions overlap with. Eager PyTorch has no such program to
break: there the plain version is three passes over x plus an fp32 copy
of it, so the kernel is the default and the only CUDA route. On a CPU
tensor the wrapper runs the plain version, ``moment_sums_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from forde_tpu_torch import kernels
from forde_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_COLUMNS = 256  # columns per block of the partial-sum pass
_TARGET_BLOCKS = 1056  # 8 blocks on each of the H100's 132 SMs
_MIN_CHUNK_ROWS = 64


def moment_sums_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (sum|x|, sum x^2, sum x) over all leading axes of x
    (..., F), each value widened to fp32 first, as the TPU kernel does."""
    xf = x.reshape(-1, x.shape[-1]).float()
    return torch.stack([xf.abs().sum(0), (xf * xf).sum(0), xf.sum(0)])


def chunking(n: int, f: int) -> tuple:
    """(chunks, rows_per_chunk) of the kernel's partial-sum pass: enough
    row chunks for ~8 blocks per SM, at least 64 rows each."""
    col_blocks = -(-f // _BLOCK_COLUMNS)
    chunks = max(1, min(-(-n // _MIN_CHUNK_ROWS), -(-_TARGET_BLOCKS // col_blocks)))
    rows = -(-n // chunks)
    return -(-n // rows), rows


def moment_sums(x: torch.Tensor) -> torch.Tensor:
    """(sum|x|, sum x^2, sum x) over all leading axes: x (..., F) float32
    or bfloat16 -> (3, F) float32, in one read of x. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel, or raises."""
    if x.device.type == "cpu":
        return moment_sums_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"moment_sums takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"moment_sums takes float32 or bfloat16, got {x.dtype}")
    f = x.shape[-1]
    x2d = x.reshape(-1, f).contiguous()
    n = x2d.shape[0]
    out = torch.empty(3, f, dtype=torch.float32, device=x.device)
    if n == 0 or f == 0:
        return out.zero_()
    chunks, rows = chunking(n, f)
    part = torch.empty(chunks, 3, f, dtype=torch.float32, device=x.device)

    lib = build.load("moment_sums")
    fn = lib.forde_moment_sums
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(
            x2d.data_ptr(), part.data_ptr(), out.data_ptr(), n, f,
            _DTYPE_CODES[x.dtype], chunks, rows,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, err, "moment_sums")
    kernels.launches["moment_sums"] += 1
    return out
