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

``make_fused_step`` runs k such steps per call over a stacked super-batch
(``stack_batches``): on the card as one CUDA graph of the k steps,
forward, backward and optimizer included (the JAX package's scanned
program); on the CPU as the same k eager steps.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch

from forde_tpu_torch.core import graphs
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


def _state_ptrs(state: CLIPTrainState) -> tuple:
    """The storage the steps read and write: a graph captured over a state
    stays valid while all of it stays where it is."""
    opt = state.optimizer
    return (graphs.tensor_ptrs(state.model), tuple(t.data_ptr() for t in (*opt.mu, *opt.nu)),
            opt.count.data_ptr(), tuple(g.data_ptr() for g in state.grad_stats.values()),
            state.grad_step_count.data_ptr())


def make_fused_step(
    config: DualEncoderConfig,
    n_steps: int,
    sense_interval: int = 1,
    sensed_step=None,
    nosense_step=None,
    *,
    cuda_graph: bool = True,
):
    """``n_steps`` optimizer steps per call over a stacked super-batch, in
    the unfused loop's order: sensed at offsets 0, g, 2g, ... (g =
    ``sense_interval``), unsensed between, the same math step for step.
    ``n_steps`` must be a positive multiple of g, so that every call runs
    whole groups. ``sensed_step`` / ``nosense_step`` default to
    ``clip_train_step`` / ``make_nosense_step(config)``.

    Usage: ``fused(state, fused.prepare(stacked))`` where ``stacked`` has
    a leading (n_steps,) axis (``stack_batches``). ``prepare`` gives each
    leaf as one contiguous (n_steps, ...) tensor and may be applied ahead
    of time (e.g. once per pooled super-batch). ``fused`` updates
    ``state`` in place and returns ``(state, metrics of the last step)``.

    On CUDA (unless ``cuda_graph`` is False) the k steps, forward,
    backward and optimizer, are one CUDA graph per train state. The first
    call runs them for real (the graph's warm-up) and captures them; each
    later call copies its super-batch into the graph's static batch and
    replays. The graph reads the state where it is: whatever runs between
    calls (the neuron slow loop, a checkpoint load) writes it in place. On
    the CPU, or with ``cuda_graph`` False, the same k steps run eagerly.
    """
    sensed = sensed_step if sensed_step is not None else clip_train_step
    group = int(sense_interval) if sense_interval > 1 else 1
    if n_steps <= 0 or n_steps % group:
        raise ValueError(
            f"n_steps ({n_steps}) must be a positive multiple of "
            f"sense_interval ({group})"
        )
    nosense = None
    if group > 1:
        nosense = nosense_step if nosense_step is not None else make_nosense_step(config)
    captured: Dict[tuple, tuple] = {}

    def run(state: CLIPTrainState, stacked: Batch) -> Dict:
        metrics = None
        for i in range(n_steps):
            batch = {k: v[i] for k, v in stacked.items()}
            step = sensed if i % group == 0 else nosense
            state, metrics = step(state, batch)
        return metrics

    def prepare(stacked: Batch) -> Batch:
        """The (n_steps, ...) super-batch as the call reads it: each leaf
        one contiguous tensor."""
        for k, v in stacked.items():
            if v.shape[0] != n_steps:
                raise ValueError(f"{k}: leading axis {v.shape[0]}, expected {n_steps}")
        return {k: v.contiguous() for k, v in stacked.items()}

    def fused(state: CLIPTrainState, prepared: Batch) -> Tuple[CLIPTrainState, Dict]:
        if not (cuda_graph and graphs.on_card(state.model.logit_scale)):
            return state, run(state, prepared)
        key = (id(state), _state_ptrs(state),
               tuple((k, v.shape, v.dtype) for k, v in prepared.items()))
        first = state.step
        entry = captured.get(key)
        if entry is None:
            static = {k: v.clone() for k, v in prepared.items()}
            graph = graphs.StepGraph(lambda: run(state, static))
            captured[key] = (graph, static)
            metrics = graph.warmup_outputs
        else:
            graph, static = entry
            graphs.copy_tree_(static, prepared)
            metrics = graph.replay()
        # the host-side step count: the warm-up's k steps (the capture ran
        # the host side again), or the replay's, which ran none of it
        state.step = first + n_steps
        return state, {k: v.clone() for k, v in metrics.items()}

    fused.prepare = prepare
    return fused


def stack_batches(batch_iter: Iterable[Batch], n: int, sharding=None) -> Iterator[Batch]:
    """Group a device-batch iterator into stacked (n, ...) super-batches
    for ``make_fused_step``. Drops a final partial group (an epoch tail
    shorter than ``n``). ``sharding`` (a multi-device layout) is not
    ported."""
    if sharding is not None:
        raise NotImplementedError(
            "stack_batches(sharding=...) is not ported to forde_tpu_torch yet (it waits "
            "for the multi-device slice; see ROADMAP.md)"
        )
    buf = []
    for b in batch_iter:
        buf.append(b)
        if len(buf) == n:
            yield {k: torch.stack([x[k] for x in buf]) for k in buf[0]}
            buf = []
