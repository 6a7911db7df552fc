"""Dual-encoder (CLIP) train state and train steps with FORDE sensing
(port of forde_tpu/train/clip_step.py).

A sensed step (``clip_train_step``) runs the model with ``sense=True``:
every StatefulLayer adds the activation statistics of its pre-activations
to its ``act_stats`` / ``step_count`` buffers, and routes them through a
gradient tap whose (F, 2) slot receives [grad_gini, grad_gdp] of dL/dz in
the same backward pass as the weight gradients. The step adds the slots'
gradients to ``state.grad_stats`` and counts the step in
``state.grad_step_count``. ``make_nosense_step`` gives the other half of
the sensing stride: the same optimisation step on the same module and
state with sensing off, which leaves every statistic as it is.

Both steps update ``state`` in place and return ``(state, metrics)``:
``loss/contrastive``, ``training/grad_norm`` (the global norm of the
parameter gradients before clipping) and the contrastive accuracies and
scale, as 0-d tensors on the model's device (no host synchronisation).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from forde_tpu_torch.core.config import DualEncoderConfig
from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder, clip_contrastive_loss
from forde_tpu_torch.nn.stateful import stateful_layers
from forde_tpu_torch.train.optim import AdamW
from forde_tpu_torch.train.state import make_optimizer

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class CLIPTrainState:
    """The model (params, brain map and stat buffers), the optimizer, and
    the gradient-stat accumulator: {StatefulLayer name: (F, 2) fp32 sums}
    over ``grad_step_count`` sensed steps."""

    model: FORDEDualEncoder
    optimizer: AdamW
    grad_stats: Dict[str, torch.Tensor]
    grad_step_count: torch.Tensor
    step: int = 0


def create_clip_train_state(
    config: DualEncoderConfig,
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
    model: Optional[FORDEDualEncoder] = None,
) -> CLIPTrainState:
    """A fresh train state: ``model`` if given (e.g. weights loaded from a
    checkpoint), else a model of ``config`` initialised from
    ``generator``. The config must have ``sense=True``."""
    if not config.sense:
        raise ValueError("the train state needs a config with sense=True")
    if model is None:
        model = FORDEDualEncoder(config, device=device, generator=generator)
    device = model.logit_scale.device
    optimizer = make_optimizer(
        list(model.parameters()), learning_rate, weight_decay, grad_clip_norm,
        warmup_steps, moment_dtype=moment_dtype, lr_schedule=lr_schedule,
        decay_steps=decay_steps, min_lr_ratio=min_lr_ratio,
    )
    grad_stats = {
        name: torch.zeros(layer.neuron_assignments.shape[0], 2, dtype=torch.float32, device=device)
        for name, layer in stateful_layers(model).items()
    }
    return CLIPTrainState(
        model=model, optimizer=optimizer, grad_stats=grad_stats,
        grad_step_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _step(state: CLIPTrainState, batch: Batch, sense: bool) -> Tuple[CLIPTrainState, Dict]:
    model = state.model
    params = state.optimizer.params
    layers = stateful_layers(model) if sense else {}
    taps = {
        name: torch.zeros_like(state.grad_stats[name], requires_grad=True)
        for name in layers
    }
    for name, layer in layers.items():
        layer.z_tap = taps[name]
    try:
        img, txt, scale = model(
            batch["image"], batch["input_ids"], batch.get("attention_mask"), sense=sense
        )
        loss, metrics = clip_contrastive_loss(img, txt, scale)
        grads = torch.autograd.grad(
            loss, params + list(taps.values()), materialize_grads=True
        )
    finally:
        for layer in layers.values():
            layer.z_tap = None
    param_grads = grads[: len(params)]
    with torch.no_grad():
        for name, g in zip(taps, grads[len(params):]):
            state.grad_stats[name].add_(g)
        if sense:
            state.grad_step_count.add_(1)
    grad_norm = state.optimizer.step(param_grads)
    state.step += 1
    return state, {
        "loss/contrastive": loss.detach(),
        "training/grad_norm": grad_norm,
        **{k: v.detach() for k, v in metrics.items()},
    }


def clip_train_step(state: CLIPTrainState, batch: Batch) -> Tuple[CLIPTrainState, Dict]:
    """One contrastive step with sensing and the gradient-stat harvest."""
    return _step(state, batch, sense=True)


def make_nosense_step(config: DualEncoderConfig):
    """The contrastive step with sensing off, the other half of the
    sensing stride: the same update of the parameters, and the stat
    buffers, ``grad_stats`` and ``grad_step_count`` left as they are. The
    JAX package compiles a second program for it; here it is the same
    module called with ``sense=False``."""
    del config  # one module serves both steps
    return functools.partial(_step, sense=False)
