"""Train state of the decoder LM, and the learning-rate schedule and
optimizer of every training step (port of forde_tpu/train/state.py, with
optax's schedule arithmetic).

The JAX package's ``TrainState`` carries params, the optimizer state and
the ``stats_buffer`` collection; here the model holds its parameters and
its MoE stat buffers, and ``TrainState`` adds the optimizer and the step
count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

import torch

from forde_tpu_torch.core.config import LLMConfig, dtype_from_name
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
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


@dataclasses.dataclass
class TrainState:
    """The decoder LM (parameters and MoE stat buffers), the optimizer
    (global-norm clipping -> AdamW over every parameter) and the number of
    steps taken."""

    model: FORDEDecoderLM
    optimizer: AdamW
    step: int = 0


def create_train_state(
    config: LLMConfig,
    generator: Optional[torch.Generator],
    learning_rate: float,
    weight_decay: float,
    grad_clip_norm: float = 1.0,
    warmup_steps: int = 0,
    moment_dtype: Optional[str] = None,
    lr_schedule: str = "constant",
    decay_steps: int = 0,
    min_lr_ratio: float = 0.0,
    device=None,
    model: Optional[FORDEDecoderLM] = None,
) -> TrainState:
    """A fresh train state: ``model`` if given (e.g. weights loaded from a
    checkpoint), else a decoder LM of ``config`` initialised from
    ``generator`` on ``device``."""
    if model is None:
        model = FORDEDecoderLM(config, device=device, generator=generator)
    optimizer = make_optimizer(
        list(model.parameters()), learning_rate, weight_decay, grad_clip_norm,
        warmup_steps, moment_dtype=moment_dtype, lr_schedule=lr_schedule,
        decay_steps=decay_steps, min_lr_ratio=min_lr_ratio,
    )
    return TrainState(model=model, optimizer=optimizer)
