"""Train state of the decoder LM, and the learning-rate schedule and
optimizer of every training step (port of forde_tpu/train/state.py, with
optax's schedule arithmetic).

The JAX package's ``TrainState`` carries params, the optimizer state and
the ``stats_buffer`` collection; here the model holds its parameters and
its MoE stat buffers, and ``TrainState`` adds the optimizer and the step
count.

``shard_train_state`` puts a state on a mesh (core/mesh.py): each rank
keeps its part of every parameter, with its Adam moments and EMA, by the
rule of the JAX package's ``state_shardings`` (``param_layouts``): a
GPipe stage's layers, the expert banks' E/ep experts, the Megatron slices
over the model axis and, under ``param_sharding="fsdp"``, a data-axis
shard of the largest free dim. In a checkpoint's scanned (L, E, ...)
layout the expert dim is dimension 1. The train steps then reduce every
gradient once, over the axes its parameter is whole on (``train/step.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

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
    ``mesh``: set by ``shard_train_state``; ``layouts`` then holds each
    optimizer parameter's layout (``core.mesh.Sharding``), and
    ``expert_params`` marks those that hold this rank's slice of an expert
    bank."""

    model: FORDEDecoderLM
    optimizer: AdamW
    step: int = 0
    ema: Optional[List[torch.Tensor]] = None
    lora: Optional["LoRAAdapters"] = None
    mesh: Optional["mesh_lib.Mesh"] = None
    expert_params: Optional[List[bool]] = None
    layouts: Optional[List["mesh_lib.Sharding"]] = None


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
    """The layout of every parameter of ``state.model`` by name
    (``param_layouts``); the optimizer's moments and EMA follow their
    parameters."""
    return param_layouts(state.model, mesh, param_sharding)


def param_layouts(model: torch.nn.Module, mesh: "mesh_lib.Mesh",
                  param_sharding: str = "replicated") -> Dict[str, "mesh_lib.Sharding"]:
    """Every parameter's layout on ``mesh`` (the JAX package's
    ``_leaf_sharding``, in the port's layout): a decoder layer belongs to
    its GPipe stage under a pipe axis; an expert bank splits dim 0 over
    the expert axis; the Megatron layers split over the model axis
    (``core.mesh.tp_param_spec``, a fused qkv projection by head) where the
    dim and the attention heads divide; and ``fsdp`` splits each remaining parameter of at least
    2 x data elements on its largest free dim over the data axis. That dim
    is chosen in the Flax layout (a stable sort by size, so a square
    kernel takes Flax's dim 0, the torch weight's dim 1)."""
    from forde_tpu_torch.interop import flax_keys

    if param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"unknown param_sharding {param_sharding!r}")
    fsdp = param_sharding == "fsdp"
    named = dict(model.named_parameters())
    transposed = {n: t for n, (_, t) in flax_keys(named).items()}
    expert, tp = mesh.shape[mesh_lib.AXIS_EXPERT], mesh.shape[mesh_lib.AXIS_MODEL]
    data, pipe = mesh.shape[mesh_lib.AXIS_DATA], mesh.shape[mesh_lib.AXIS_PIPE]
    out = {}
    for name, t in named.items():
        names = name.split(".")
        spec, blocks = [None] * t.ndim, [1] * t.ndim
        stage = pipe > 1 and names[0] == "layers"
        if expert > 1 and "experts" in names and t.ndim >= 1 and t.shape[0] % expert == 0:
            spec[0] = mesh_lib.AXIS_EXPERT
        if tp > 1:
            split = mesh_lib.tp_param_spec(names, t)
            if split is not None and _heads_split(model, names, tp):
                dim = split.index(mesh_lib.AXIS_MODEL)
                if t.shape[dim] % tp == 0 and spec[dim] is None:
                    spec[dim] = mesh_lib.AXIS_MODEL
                    blocks[dim] = 3 if names[-2] == "qkv_proj" else 1
        if fsdp and data > 1 and t.numel() >= 2 * data:
            order = list(range(t.ndim))
            if transposed[name] and t.ndim >= 2:  # the Flax dims, in torch's numbering
                order[-2], order[-1] = order[-1], order[-2]
            for dim in sorted(order, key=lambda i: -t.shape[i]):
                if spec[dim] is None and t.shape[dim] % data == 0:
                    spec[dim] = mesh_lib.AXIS_DATA
                    break
        out[name] = mesh_lib.Sharding(mesh, tuple(spec), tuple(blocks), stage)
    return out


def _heads_split(model: torch.nn.Module, names: Sequence[str], tp: int) -> bool:
    """Whether the attention module that owns a projection (if one does)
    has heads that split over ``tp``: a rank runs whole heads, so where
    they do not divide (ViT-Ti's 3 heads over 2) the module's projections
    stay whole, which computes what GSPMD's split of its columns does."""
    owner = model.get_submodule(".".join(names[:-2])) if len(names) > 2 else model
    heads = getattr(owner, "num_heads", None)
    return heads is None or heads % tp == 0


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: "mesh_lib.Mesh",
                param_sharding: str = "replicated") -> Tuple[Dict[str, "mesh_lib.Sharding"],
                                                              Dict[int, Optional[torch.Tensor]]]:
    """Keep this rank's part of every parameter of ``model`` (whole on
    every rank) and set its modules up for the layout: GPipe stages drop
    the layers of the others, split parameters become new parameters of
    their slice, the tensor-parallel modules take the model axis
    (parallel/tensor_parallel.py) and the FSDP-split parameters are marked
    for their gather (parallel/fsdp.py). Returns (the layouts by name,
    {id(old parameter): new parameter, or None where another stage holds
    it})."""
    from forde_tpu_torch.parallel import fsdp, pipeline, tensor_parallel

    layouts = param_layouts(model, mesh, param_sharding)
    replaced: Dict[int, Optional[torch.Tensor]] = {}
    for p in pipeline.drop_other_stages(model, mesh):
        replaced[id(p)] = None
    for name, p in list(model.named_parameters()):
        sh = layouts[name]
        if not any(a != mesh_lib.AXIS_PIPE for a in sh.axes):
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        new = torch.nn.Parameter(sh(p.detach()).clone(), requires_grad=p.requires_grad)
        setattr(owner, leaf, new)
        replaced[id(p)] = new
    layouts = {n: sh for n, sh in layouts.items() if n in dict(model.named_parameters())}
    tensor_parallel.setup(model, mesh, layouts)
    fsdp.setup(model, mesh, layouts)
    return layouts, replaced


def shard_train_state(state, mesh: Optional["mesh_lib.Mesh"],
                      param_sharding: str = "replicated"):
    """Put ``state`` (a ``TrainState`` or ``CLIPTrainState``, whole on
    every rank) on ``mesh`` in place: each rank keeps its part of every
    parameter (``shard_model``), with the Adam moments and EMA of the
    same layout, and the state records the mesh, each optimizer
    parameter's layout (``layouts``) and which are expert-bank slices
    (``expert_params``). None leaves the state as it is."""
    if mesh is None:
        return state
    state.mesh = mesh
    opt = state.optimizer
    before = {id(p): n for n, p in state.model.named_parameters()}
    lora = getattr(state, "lora", None)
    layouts, replaced = shard_model(state.model, mesh, param_sharding)
    if lora is not None and any(replaced.values()) and any("experts" in k for k in lora.tensors):
        raise ValueError("LoRA adapters of an expert bank split over the expert axis are not "
                         "supported; adapt other modules or use --expert_parallelism 1")
    full = mesh_lib.Sharding(mesh, ())
    keep, state_layouts = [], []
    for i, p in enumerate(opt.params):
        if id(p) in replaced and replaced[id(p)] is None:
            continue  # another stage's layer
        keep.append(i)
        name = before.get(id(p))
        sh = layouts.get(name, full) if name is not None else full
        state_layouts.append(sh)
        if id(p) in replaced:
            opt.params[i] = replaced[id(p)]
            opt.mu[i], opt.nu[i] = sh(opt.mu[i]).clone(), sh(opt.nu[i]).clone()
            if state.ema is not None:
                state.ema[i] = sh(state.ema[i]).clone()
    opt.params = [opt.params[i] for i in keep]
    opt.mu, opt.nu = [opt.mu[i] for i in keep], [opt.nu[i] for i in keep]
    if state.ema is not None:
        state.ema = [state.ema[i] for i in keep]
    state.layouts = state_layouts
    state.expert_params = [mesh_lib.AXIS_EXPERT in sh.axes for sh in state_layouts]
    if any(sh.axes for sh in state_layouts):
        opt.global_norm = _sharded_norm(state_layouts, mesh)
    return state


def _sharded_norm(layouts: Sequence["mesh_lib.Sharding"], mesh: "mesh_lib.Mesh"):
    """The global gradient norm when some gradients are parts of their
    parameter: each one's square summed over the axes that split it (one
    all-reduce for each set of such axes)."""
    kinds: Dict[Tuple[str, ...], List[int]] = {}
    for i, sh in enumerate(layouts):
        kinds.setdefault(sh.axes, []).append(i)

    def global_norm(norms: torch.Tensor) -> torch.Tensor:
        sq = norms.float() ** 2
        total = torch.zeros((), dtype=sq.dtype, device=sq.device)
        for axes, idx in kinds.items():
            part = sq[torch.tensor(idx, device=sq.device)].sum()
            total = total + (mesh.group(*axes).all_reduce(part) if axes else part)
        return torch.sqrt(total)

    return global_norm
