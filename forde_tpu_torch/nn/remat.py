"""Rematerialisation: a module call whose activations are recomputed in
the backward instead of kept (the JAX package's ``nn.remat``).

``checkpoint(fn, *args)`` runs ``fn`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
keeps only ``fn``'s inputs, and the backward runs ``fn`` again to rebuild
the tensors autograd needs. Gradients flow through the graph of the first
forward (so an ``autograd.Function`` such as the gradient tap runs its
backward once); the second run only refills the saved tensors.

The port's forward has side effects that JAX returns as outputs of the
rematted function: the MoE layers' ``expert_usage``/``step_count`` and the
StatefulLayers' ``act_stats``/``step_count`` are added to in place. A
module guards each such write with ``recomputing()``, which is true only
while the backward reruns a checkpointed call, so every write happens
once per forward and ``moment_sums`` launches once per sensed layer, with
or without remat. A CUDA graph captured over such a step repeats what was
captured: the writes of the first forward, none in the recomputation.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.utils.checkpoint

_state = threading.local()


def recomputing() -> bool:
    """Whether this thread is rerunning a checkpointed call in the backward."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def _recomputation():
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def _contexts():
    return contextlib.nullcontext(), _recomputation()


def checkpoint(fn, *args, preserve_rng_state: bool = False):
    """``fn(*args)`` with its activations recomputed in the backward.
    ``preserve_rng_state``: replay the forward's random draws in the
    recomputation (needed only where the call runs dropout)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=_contexts,
        preserve_rng_state=preserve_rng_state,
    )

