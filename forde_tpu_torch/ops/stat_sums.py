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

The kernel reads x in 16-byte loads, so the wrapper refuses an x whose
base is off a 16-byte boundary. Its blocks each sum one column group of
one chunk of rows (``chunking``: about two blocks per SM), and a second
launch adds the chunks' fp32 partials in chunk order, so the result is
the same bit for bit from call to call. Its time on an H100 against its
bound is in PERF.md (row #11) and the kernel's header.
"""

from __future__ import annotations

import ctypes

import torch

from forde_tpu_torch import kernels
from forde_tpu_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GROUP_BYTES = 512  # bytes of a row one block reads: 32 threads x 16 bytes
_TARGET_BLOCKS = 264  # two blocks on each of the H100's 132 SMs
_STEP_ROWS = 32  # rows a block loads at once: 8 warps x 4 rows


def moment_sums_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (sum|x|, sum x^2, sum x) over all leading axes of x
    (..., F), each value widened to fp32 first, as the TPU kernel does."""
    xf = x.reshape(-1, x.shape[-1]).float()
    return torch.stack([xf.abs().sum(0), (xf * xf).sum(0), xf.sum(0)])


def chunking(n: int, f: int, itemsize: int) -> tuple:
    """(chunks, rows_per_chunk) of the kernel's partial-sum pass over an
    (n, f) x of ``itemsize`` bytes a value: about two blocks per SM over
    the column groups, each chunk a multiple of the 32 rows a block loads at
    once (the last chunk short)."""
    col_groups = -(-f * itemsize // _GROUP_BYTES)
    chunks = max(1, min(-(-n // _STEP_ROWS), -(-_TARGET_BLOCKS // col_groups)))
    rows = -(-n // chunks)
    rows = -(-rows // _STEP_ROWS) * _STEP_ROWS
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
    if x2d.data_ptr() % 16:  # the kernel reads 16 bytes at a time
        raise ValueError("moment_sums needs a 16-byte aligned x")
    chunks, rows = chunking(n, f, x2d.element_size())
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
    kernels.count("moment_sums")
    return out


def global_moment_sums(x: torch.Tensor, group=None) -> torch.Tensor:
    """``moment_sums`` of x, summed over ``group`` (a data axis of
    parallel/collectives.py: every rank gets the global batch's sums) when
    one is given."""
    sums = moment_sums(x)
    return sums if group is None or group.size == 1 else group.all_reduce(sums)
