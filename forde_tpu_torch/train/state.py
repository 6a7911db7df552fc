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
from typing import TYPE_CHECKING, List, Optional, Sequence, Union

import torch

from forde_tpu_torch.core.config import LLMConfig, dtype_from_name
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.train.optim import AdamW

if TYPE_CHECKING:
    from forde_tpu_torch.train.lora import LoRAAdapters


class LRSchedule:
    """LR as a function of the step count: linear warmup (0 -> peak over
    ``warmup_steps``) into a constant or a cosine decay (peak ->
    ``min_lr_ratio`` * peak over ``decay_steps``, counted after warmup; the
    tail holds at the floor).

    ``at(count)`` takes the count as an int32 tensor and gives the LR as
    an fp32 tensor on its device, with optax's fp32 arithmetic
    (``linear_schedule``, ``cosine_decay_schedule``, ``join_schedules``):
    the optimizer reads it there, so that a step captured in a CUDA graph
    follows the schedule on every replay. Called with a Python int it gives
    the same value as a float."""

    def __init__(self, learning_rate: float, warmup_steps: int, lr_schedule: str,
                 decay_steps: int, min_lr_ratio: float):
        self.learning_rate, self.warmup_steps = learning_rate, warmup_steps
        self.cosine, self.decay_steps, self.min_lr_ratio = (
            lr_schedule == "cosine", decay_steps, min_lr_ratio)

    def __call__(self, step: int) -> float:
        return float(self.at(torch.tensor(step, dtype=torch.int32)))

    def at(self, count: torch.Tensor) -> torch.Tensor:
        lr = self.learning_rate
        tail_count = count - self.warmup_steps if self.warmup_steps > 0 else count
        if self.cosine:
            c = torch.clamp(tail_count.to(torch.float32), max=float(self.decay_steps))
            cosine = 0.5 * (1.0 + torch.cos(math.pi * c / float(self.decay_steps)))
            tail = lr * ((1.0 - self.min_lr_ratio) * cosine + self.min_lr_ratio)
        else:
            tail = torch.full((), lr, dtype=torch.float32, device=count.device)
        if self.warmup_steps <= 0:
            return tail
        frac = 1.0 - torch.clamp(count, 0, self.warmup_steps).to(torch.float32) / self.warmup_steps
        warm = (0.0 - lr) * frac + lr
        return torch.where(count < self.warmup_steps, warm, tail)


def make_lr_schedule(
    learning_rate: float,
    warmup_steps: int = 0,
    lr_schedule: str = "constant",
    decay_steps: int = 0,
    min_lr_ratio: float = 0.0,
) -> Union[float, LRSchedule]:
    """The LR schedule (``LRSchedule``), or a plain float when the whole
    schedule is constant."""
    if lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    if lr_schedule == "cosine" and decay_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs decay_steps > 0")
    if warmup_steps <= 0 and lr_schedule == "constant":
        return learning_rate
    return LRSchedule(learning_rate, warmup_steps, lr_schedule, decay_steps, min_lr_ratio)


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
    steps taken.

    ``ema``: the EMA of the optimizer's parameters, one tensor each in the
    same order (train/ema.py), or None. ``lora``: with LoRA the optimizer
    trains these adapters over a frozen ``model`` (train/lora.py)."""

    model: FORDEDecoderLM
    optimizer: AdamW
    step: int = 0
    ema: Optional[List[torch.Tensor]] = None
    lora: Optional["LoRAAdapters"] = None


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
