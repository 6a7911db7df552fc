"""CUDA graphs of one step function: the port's counterpart of
``jax.jit`` for the steps that the JAX package compiles into one program
(the decode step of ``models/generate.py``, the k fused training steps of
``train/clip_step.make_fused_step``).

``StepGraph(step)`` takes a function of no arguments that reads and
writes tensors it closes over (its static buffers) and:

* runs it once for real on a side stream (the warm-up). That first call
  loads every kernel library the step launches and initialises the CUDA
  runtime each one links, lets cuBLAS make its handles and workspaces,
  and runs under ``torch.cuda.set_sync_debug_mode("error")``, so that a
  host read (``.item()``, a copy to the host, a Python ``if`` on a tensor)
  raises here rather than breaking the capture;
* captures a second call into a ``torch.cuda.CUDAGraph``. The capture
  launches nothing, so the step's static buffers are as the warm-up left
  them. ``generators`` (the explicit ``torch.Generator`` objects the step
  draws from) are registered with the graph, so that each replay draws
  new numbers and advances their Philox offsets;
* ``replay()`` runs the captured step again on the current stream.

Launch counts: ``kernels.launches`` counts wrapper calls. The capture's
calls launched nothing, so they are taken back off the counts, and every
replay adds them again: the counts keep meaning "kernels that ran".

Everything the graph reads between replays must be written in place
(``copy_``, in-place ops): a tensor that is rebound to new storage is no
longer the one the graph reads. A capture that fails raises; nothing falls
back to eager execution.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

from forde_tpu_torch import kernels


def _count_delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in kernels.launches.items() if n != before.get(k, 0)}


class StepGraph:
    """``step`` warmed up once for real, captured once, and replayed."""

    def __init__(self, step: Callable[[], object], generators: Iterable[torch.Generator] = ()):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            debug = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.warmup_outputs = step()
            finally:
                torch.cuda.set_sync_debug_mode(debug)
        torch.cuda.current_stream().wait_stream(side)

        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = dict(kernels.launches)
        # thread_local: other threads (a prefetch producer pinning host
        # memory) may go on with their own CUDA calls during the capture.
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = step()
        self.launches: Dict[str, int] = _count_delta(before)
        for name, n in self.launches.items():
            kernels.launches[name] -= n
            if kernels.launches[name] == 0:
                del kernels.launches[name]

    def replay(self) -> object:
        """Run the captured step once; returns its static outputs, which
        the next replay overwrites."""
        self.graph.replay()
        kernels.launches.update(self.launches)
        return self.outputs


def on_card(t: torch.Tensor) -> bool:
    """Whether a step over ``t`` is captured: only a CUDA tensor's is."""
    return t.device.type == "cuda"


def copy_tree_(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place of
    ``dst`` (nested dicts, lists or tuples of one structure), in place."""
    if isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise KeyError(f"trees differ: {sorted(dst)} vs {sorted(src)}")
        for k in dst:
            copy_tree_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"trees differ: {len(dst)} vs {len(src)} leaves")
        for d, s in zip(dst, src):
            copy_tree_(d, s)
    elif dst is not None or src is not None:
        if dst.data_ptr() != src.data_ptr():
            dst.copy_(src)


def clone_tree(tree):
    """A copy of ``tree`` (nested dicts, lists or tuples of tensors) in new
    storage."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return None if tree is None else tree.clone()


def tensor_ptrs(module: torch.nn.Module) -> tuple:
    """The storage addresses of ``module``'s parameters and buffers: a graph
    captured over them stays valid while these stay the same."""
    return tuple(t.data_ptr() for t in (*module.parameters(), *module.buffers()))

