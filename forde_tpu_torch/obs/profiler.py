"""``--profile_dir`` of the training loops: a ``torch.profiler`` trace of
the whole run (the JAX loops' ``jax.profiler.start_trace`` /
``stop_trace``).

The trace is the profiler's Chrome-trace JSON
(``<dir>/<host>_<pid>.<time>.pt.trace.json``, readable by Perfetto and
TensorBoard's profile plugin). On a CUDA device it records the host ops
and the device's kernels, the hand-written ones under their CUDA names
(``flash_fwd_tc_kernel``, ``skv_bwd_dq_tc_kernel``, ``moment_partial_kernel``
...); on the CPU it records the host only.
"""

from __future__ import annotations

import contextlib
import glob
import os
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str], device: torch.device) -> Iterator[List[str]]:
    """Profile the block into ``profile_dir`` (nothing without one). The
    trace is written when the block ends, by an exception too; the list it
    yields then holds the paths of the trace files, whose sizes are
    printed."""
    written: List[str] = []
    if not profile_dir:
        yield written
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    before = set(glob.glob(os.path.join(profile_dir, "*.pt.trace.json*")))
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    try:
        yield written
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        written += sorted(set(glob.glob(os.path.join(profile_dir, "*.pt.trace.json*"))) - before)
        for path in written:
            print(f"profile trace {path}: {os.path.getsize(path) / 2 ** 20:.1f} MiB", flush=True)
