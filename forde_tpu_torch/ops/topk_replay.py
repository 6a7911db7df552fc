"""The NSA prefill's top-k replay on the device (port of the ``lax.scan``
over ``topk_insert`` in forde_tpu/models/generate.py's ``nsa_prefill``).

The streaming decode keeps a running top-k set per row: each new position
t's importance score replaces the set's first minimum iff it is strictly
greater. A prefill over P positions leaves the set that P such insertions
from an empty set (scores -inf, indices ``empty_idx``) leave, slot order
included, so that decoding after a prefill equals decoding token by
token. The insertion order decides the slot order, so each row's replay
is sequential.

``topk_replay`` is the entry point: on a CUDA tensor it launches
``csrc/topk_replay.cu`` (one warp per row, the slots in the lanes'
registers) on the current stream, or raises; on a CPU tensor it runs the
plain version ``topk_replay_reference``, the same loop in torch ops.
This is not a TPU kernel: the JAX package runs the replay as a scan on
the device, and the port's earlier replay copied the scores to the host
and looped there.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from forde_tpu_torch import kernels
from forde_tpu_torch.kernels import build

# The kernel keeps K / 32 slots in each lane's registers, at most 8.
MAX_K = 256


def topk_replay_reference(
    scores: torch.Tensor, k_sel: int, empty_idx: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``topk_insert``'s rule, one position at a time over
    every row at once. ``scores`` (N, P) -> (kept scores (N, K) fp32,
    source positions (N, K) int32)."""
    s = scores.float()
    n, p = s.shape
    kept = torch.full((n, k_sel), -float("inf"), dtype=torch.float32, device=s.device)
    idx = torch.full((n, k_sel), empty_idx, dtype=torch.int32, device=s.device)
    for t in range(p):
        slot = torch.argmin(kept, dim=1, keepdim=True)  # the first minimum
        low = kept.gather(1, slot)
        new = s[:, t:t + 1]
        accept = new > low
        kept.scatter_(1, slot, torch.where(accept, new, low))
        idx.scatter_(1, slot, torch.where(accept, t, idx.gather(1, slot)))
    return kept, idx


def topk_replay(
    scores: torch.Tensor, k_sel: int, empty_idx: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The running top-k set after inserting ``scores[:, t]`` at position t
    for t = 0 .. P-1 into an empty set, for every row of ``scores`` (N, P)
    (pad positions arrive as -inf and are never accepted). Returns (kept
    scores (N, K) fp32, source positions (N, K) int32; empty slots -inf /
    ``empty_idx``) on the scores' device. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel, or raises. Scores are
    compared in fp32."""
    if scores.dim() != 2:
        raise ValueError(f"scores must be (N, P), got {tuple(scores.shape)}")
    if not 0 < k_sel <= MAX_K:
        raise ValueError(f"topk_replay takes 1 to {MAX_K} slots, got {k_sel}")
    if scores.device.type == "cpu":
        return topk_replay_reference(scores, k_sel, empty_idx)
    if scores.device.type != "cuda":
        raise ValueError(f"topk_replay takes CPU or CUDA tensors, got {scores.device}")
    s = scores.float().contiguous()
    n, p = s.shape
    kept = torch.empty(n, k_sel, dtype=torch.float32, device=s.device)
    idx = torch.empty(n, k_sel, dtype=torch.int32, device=s.device)
    if n == 0:
        return kept, idx

    lib = build.load("topk_replay")
    fn = lib.forde_topk_replay
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(s.device):
        err = fn(
            s.data_ptr(), kept.data_ptr(), idx.data_ptr(), n, p, k_sel, empty_idx,
            torch.cuda.current_stream(s.device).cuda_stream,
        )
    build.check(lib, err, "topk_replay")
    kernels.count("topk_replay")
    return kept, idx
