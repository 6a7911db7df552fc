"""Learning-rate schedule and optimizer of the training steps (port of
``make_lr_schedule`` and ``make_optimizer`` in forde_tpu/train/state.py,
with optax's schedule arithmetic)."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch

from forde_tpu_torch.core.config import dtype_from_name
from forde_tpu_torch.train.optim import AdamW


def make_lr_schedule(
    learning_rate: float,
    warmup_steps: int = 0,
    lr_schedule: str = "constant",
    decay_steps: int = 0,
    min_lr_ratio: float = 0.0,
) -> Union[float, Callable[[int], float]]:
    """LR as a function of the step count: linear warmup (0 -> peak over
    ``warmup_steps``) into a constant or a cosine decay (peak ->
    ``min_lr_ratio`` * peak over ``decay_steps``, counted after warmup; the
    tail holds at the floor). A plain float when the whole schedule is
    constant."""
    if lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    if lr_schedule == "cosine" and decay_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs decay_steps > 0")
    if warmup_steps <= 0 and lr_schedule == "constant":
        return learning_rate

    def tail(step: int) -> float:
        if lr_schedule == "constant":
            return learning_rate
        # optax.cosine_decay_schedule(learning_rate, decay_steps, alpha)
        frac = min(step, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return learning_rate * ((1.0 - min_lr_ratio) * cosine + min_lr_ratio)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            # optax.linear_schedule(0, learning_rate, warmup_steps)
            return learning_rate * step / warmup_steps
        return tail(step - warmup_steps)

    return schedule


def make_optimizer(
    params: Sequence[torch.Tensor],
    learning_rate: float,
    weight_decay: float,
    grad_clip_norm: float = 1.0,
    warmup_steps: int = 0,
    moment_dtype: Optional[str] = None,
    lr_schedule: str = "constant",
    decay_steps: int = 0,
    min_lr_ratio: float = 0.0,
) -> AdamW:
    """clip_by_global_norm(``grad_clip_norm``) -> AdamW over ``params``.

    ``moment_dtype`` (e.g. "bfloat16") stores both Adam moments in that
    dtype; the update math stays fp32. None keeps ``optax.adamw``'s
    behaviour (moments in the parameter dtype).
    """
    lr = make_lr_schedule(learning_rate, warmup_steps, lr_schedule, decay_steps, min_lr_ratio)
    return AdamW(
        params, lr, weight_decay=weight_decay, grad_clip_norm=grad_clip_norm,
        moment_dtype=dtype_from_name(moment_dtype) if moment_dtype else None,
    )
