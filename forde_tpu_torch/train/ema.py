"""Exponential moving average of the trainable parameters (port of
forde_tpu/train/ema.py).

The EMA covers the optimizer's parameters (the JAX package's
``state.params``): for a LoRA state the adapters, and never the MoE stat
buffers or the neuron assignments. It lives on the train state
(``state.ema``, one tensor per parameter in the optimizer's order) and is
written in place, so that a step captured in a CUDA graph
(``clip_step.make_fused_step``) reads and writes it where it is: the JAX
package folds the update into its jitted step, and ``with_ema`` puts it
inside whatever step it wraps, graph and all.

The update is the JAX package's ``e * decay + p * (1 - decay)``, as one
``_foreach`` multiply and one ``_foreach`` add. ``swap_in_ema`` evaluates
the EMA weights by copying them into the live parameters for the length of
a ``with`` block and back, so no storage moves and training goes on after
it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Sequence

import torch


def init_ema(state):
    """Seed ``state.ema`` with a copy of the optimizer's parameters (a
    state that already carries an EMA keeps it)."""
    if state.ema is None:
        state.ema = [p.detach().clone() for p in state.optimizer.params]
    return state


@torch.no_grad()
def ema_update_(ema: List[torch.Tensor], params: Sequence[torch.Tensor], decay: float) -> None:
    """``ema <- ema * decay + params * (1 - decay)`` in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.detach().to(e.dtype) for e, p in zip(ema, params)],
                        alpha=1.0 - decay)


def with_ema(step_fn: Callable, decay: float) -> Callable:
    """Wrap a ``(state, batch) -> (state, metrics)`` step so that each
    optimizer step also advances ``state.ema`` from the parameters it
    produced."""

    def step(state, batch):
        state, metrics = step_fn(state, batch)
        ema_update_(state.ema, state.optimizer.params, decay)
        return state, metrics

    return step


@contextlib.contextmanager
def swap_in_ema(state) -> Iterator:
    """Inside the block the live parameters hold the EMA weights (for eval
    or serving); after it they hold their own again, bit for bit, in the
    same storage. The optimizer state is untouched."""
    if state.ema is None:
        raise ValueError("EMA not enabled: the state has no ema (train with --ema_decay)")
    params = state.optimizer.params
    with torch.no_grad():
        saved = [p.detach().clone() for p in params]
        torch._foreach_copy_(params, state.ema)
    try:
        yield state
    finally:
        with torch.no_grad():
            torch._foreach_copy_(params, saved)
