"""Train state of the decoder LM, and the learning-rate schedule and
optimizer of every training step (port of forde_tpu/train/state.py, with
optax's schedule arithmetic).

The JAX package's ``TrainState`` carries params, the optimizer state and
the ``stats_buffer`` collection; here the model holds its parameters and
its MoE stat buffers, and ``TrainState`` adds the optimizer and the step
count.

``shard_train_state`` puts a state on a mesh (core/mesh.py) under
``param_sharding="replicated"``: every tensor stays whole on every rank but
the stacked expert banks under an expert axis above 1, of which each rank
keeps its E/ep experts, with their Adam moments and EMA (the expert rule
of the JAX package's ``state_shardings``; in a checkpoint's scanned (L, E,
...) layout that is dimension 1). The train steps then reduce every
gradient once (``train/step.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Union

import torch

from forde_tpu_torch.core import mesh as mesh_lib
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
    trains these adapters over a frozen ``model`` (train/lora.py).
    ``mesh``: set by ``shard_train_state``; ``expert_params`` then marks
    the optimizer's parameters that hold this rank's slice of an expert
    bank."""

    model: FORDEDecoderLM
    optimizer: AdamW
    step: int = 0
    ema: Optional[List[torch.Tensor]] = None
    lora: Optional["LoRAAdapters"] = None
    mesh: Optional["mesh_lib.Mesh"] = None
    expert_params: Optional[List[bool]] = None


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
    mesh: Optional["mesh_lib.Mesh"] = None,
) -> TrainState:
    """A fresh train state: ``model`` if given (e.g. weights loaded from a
    checkpoint), else a decoder LM of ``config`` initialised from
    ``generator`` on ``device`` (with ``mesh`` for its multi-device paths;
    every rank draws the same whole model, and ``shard_train_state`` keeps
    each rank's part)."""
    if model is None:
        model = FORDEDecoderLM(config, device=device, generator=generator, mesh=mesh)
    optimizer = make_optimizer(
        list(model.parameters()), learning_rate, weight_decay, grad_clip_norm,
        warmup_steps, moment_dtype=moment_dtype, lr_schedule=lr_schedule,
        decay_steps=decay_steps, min_lr_ratio=min_lr_ratio,
    )
    return TrainState(model=model, optimizer=optimizer)


def state_shardings(state, mesh: "mesh_lib.Mesh", param_sharding: str = "replicated"
                    ) -> Dict[str, "mesh_lib.Sharding"]:
    """The layout of every model tensor by name: the expert rule
    (``core.mesh.param_shardings``), the optimizer's moments and EMA
    following their parameters. ``fsdp`` waits for slice 11."""
    if param_sharding == "fsdp":
        raise NotImplementedError(f"--param_sharding fsdp {mesh_lib.SLICE_11}")
    if param_sharding != "replicated":
        raise ValueError(f"unknown param_sharding {param_sharding!r}")
    return mesh_lib.param_shardings(dict(state.model.named_parameters()), mesh)


@torch.no_grad()
def shard_experts(model: torch.nn.Module, mesh: "mesh_lib.Mesh") -> Dict[int, torch.Tensor]:
    """Keep this rank's slice of every expert bank of ``model`` (new
    parameters); returns {id(old parameter): new parameter}."""
    replaced: Dict[int, torch.Tensor] = {}
    shardings = mesh_lib.param_shardings(dict(model.named_parameters()), mesh)
    for name, sharding in shardings.items():
        if not sharding.spec:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        old = getattr(owner, leaf)
        new = torch.nn.Parameter(sharding(old.detach()).clone(), requires_grad=old.requires_grad)
        setattr(owner, leaf, new)
        replaced[id(old)] = new
    return replaced


def shard_train_state(state, mesh: Optional["mesh_lib.Mesh"],
                      param_sharding: str = "replicated"):
    """Put ``state`` (a ``TrainState`` or ``CLIPTrainState``, whole on
    every rank) on ``mesh`` in place: each rank keeps its slice of the
    expert banks, their Adam moments and EMA (``state_shardings``), and
    the state records the mesh. None leaves the state as it is."""
    if mesh is None:
        return state
    shardings = state_shardings(state, mesh, param_sharding)
    state.mesh = mesh
    opt = state.optimizer
    by_id = {id(p): shardings[n] for n, p in state.model.named_parameters()}
    replaced = shard_experts(state.model, mesh)
    lora = getattr(state, "lora", None)
    if lora is not None and replaced and any("experts" in k for k in lora.tensors):
        raise ValueError("LoRA adapters of an expert bank split over the expert axis are not "
                         "supported; adapt other modules or use --expert_parallelism 1")
    slices = [by_id.get(id(p)) for p in opt.params]
    state.expert_params = [bool(sh is not None and sh.spec) for sh in slices]
    for i, (p, sh) in enumerate(zip(opt.params, slices)):
        if not state.expert_params[i]:
            continue
        opt.params[i] = replaced[id(p)]
        opt.mu[i], opt.nu[i] = sh(opt.mu[i]).clone(), sh(opt.nu[i]).clone()
        if state.ema is not None:
            state.ema[i] = sh(state.ema[i]).clone()
    if any(state.expert_params):
        opt.global_norm = _sharded_norm(state.expert_params, mesh)
    return state


def _sharded_norm(expert_params: List[bool], mesh: "mesh_lib.Mesh"):
    """The global gradient norm when some gradients are slices of an
    expert bank: their squares summed over the expert axis too."""
    mask = torch.tensor(expert_params)
    group = mesh.group(mesh_lib.AXIS_EXPERT)

    def global_norm(norms: torch.Tensor) -> torch.Tensor:
        sq = norms.float() ** 2
        on = mask.to(sq.device)
        experts = group.all_reduce(torch.where(on, sq, 0.0).sum())
        return torch.sqrt(torch.where(on, 0.0, sq).sum() + experts)

    return global_norm
