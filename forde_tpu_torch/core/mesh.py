"""The device mesh and the batch-slicing helpers (port of
forde_tpu/core/mesh.py).

A mesh has the JAX package's named axes (data, expert, context, model,
pipe). Its ranks map to coordinates in JAX's row-major order
(``devices.reshape(data, expert, context, model, pipe)``), so that on a
(data 2, context 2) run each rank holds the shard that the JAX device of
the same index holds. Where JAX computes on global arrays that GSPMD
partitions, a rank here holds its own block and the code says what moves
between ranks: ``Mesh.group(*axes)`` gives the ranks that differ from this
one only along ``axes``, and parallel/collectives.py runs the collectives
over it.

The mesh's transport is ``torch.distributed`` when a process group is up
(``maybe_initialize_distributed`` starts one from torchrun's environment:
NCCL on ``cuda``, gloo on the CPU), else one process with the trivial
mesh. The thread transport (``collectives.run_threads``) is for tests and
``chip_smoke.py`` only.

The ``model`` axis carries tensor parallelism: ``tp_param_spec`` gives the
Megatron layout of each parameter by its name (column-parallel layers split
their output features, row-parallel ones their input features), in the
port's layout, where a ``Linear.weight`` is (out, in), the transpose of a
Flax ``kernel``. The ``pipe`` axis carries the GPipe stages
(parallel/pipeline.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from forde_tpu_torch.parallel.collectives import DistGroup, Group, LocalGroup, ThreadWorld

AXIS_DATA = "data"
AXIS_EXPERT = "expert"
AXIS_CONTEXT = "context"
AXIS_MODEL = "model"
AXIS_PIPE = "pipe"

ALL_AXES = (AXIS_DATA, AXIS_EXPERT, AXIS_CONTEXT, AXIS_MODEL, AXIS_PIPE)


class Mesh:
    """``shape`` {axis: size} over the ranks 0..size-1; this process (or
    thread) is ``rank``. ``world``: the ``ThreadWorld`` of thread ranks, or
    None for ``torch.distributed`` (when a process group is up) or a lone
    process."""

    def __init__(self, shape: Mapping[str, int], rank: int = 0,
                 world: Optional[ThreadWorld] = None):
        unknown = set(shape) - set(ALL_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        self.shape: Dict[str, int] = {a: int(shape.get(a, 1)) for a in ALL_AXES}
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(
            ALL_AXES, (int(c) for c in np.unravel_index(rank, tuple(self.shape.values())))))
        self.world = world
        self._groups: Dict[Tuple[str, ...], Group] = {}
        self.distributed = world is None and _dist_up()
        if self.distributed:
            import torch.distributed as dist

            if dist.get_world_size() != self.size:
                raise ValueError(f"mesh of {self.size} ranks over a process group of "
                                 f"{dist.get_world_size()}")
            self._make_dist_groups()
        elif world is None and self.size > 1:
            raise ValueError(f"a mesh of {self.size} ranks needs a process group or thread ranks")

    def ranks_along(self, axes: Sequence[str]) -> Tuple[int, ...]:
        """The ranks that share this rank's coordinates off ``axes``, in
        row-major order."""
        sizes = tuple(self.shape.values())
        choices = [range(self.shape[a]) if a in axes else (self.coords[a],) for a in ALL_AXES]
        return tuple(int(np.ravel_multi_index(c, sizes)) for c in itertools.product(*choices))

    def group(self, *axes: str) -> Group:
        """The collective group of the ranks along ``axes``."""
        key = tuple(a for a in ALL_AXES if a in axes and self.shape[a] > 1)
        if key not in self._groups:
            ranks = self.ranks_along(key)
            if self.world is not None:
                self._groups[key] = self.world.group(ranks, self.rank)
            elif self.distributed and len(ranks) == self.size:
                self._groups[key] = DistGroup(ranks, self.rank)  # the default group
            elif len(ranks) == 1:
                self._groups[key] = LocalGroup(self.rank)
            else:
                raise KeyError(f"no process group along {key}")  # made in __init__
        return self._groups[key]

    def _make_dist_groups(self) -> None:
        """Every rank makes every subgroup, in one order (``new_group`` is
        collective); each keeps the one it belongs to."""
        import torch.distributed as dist

        live = [a for a in ALL_AXES if self.shape[a] > 1]
        sizes = tuple(self.shape.values())
        for n in range(1, len(live)):
            for axes in itertools.combinations(live, n):
                fixed = [a for a in ALL_AXES if a not in axes]
                for coords in itertools.product(*(range(self.shape[a]) for a in fixed)):
                    at = dict(zip(fixed, coords))
                    ranks = [int(np.ravel_multi_index(c, sizes)) for c in itertools.product(
                        *(range(self.shape[a]) if a in axes else (at[a],) for a in ALL_AXES))]
                    pg = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = DistGroup(ranks, self.rank, pg)

    @property
    def trivial(self) -> bool:
        return self.size == 1

    def restrict(self, *axes: str) -> "MeshView":
        """This mesh seen with only ``axes`` live: every other axis reads
        as size 1, and its groups hold this rank alone."""
        return MeshView(self, axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


class MeshView:
    """``Mesh.restrict``: the parent's groups along the kept axes, the
    trivial group along the others (a GPipe stage runs its blocks on the
    tokens of its own data shard, as the JAX package's stage program runs
    them un-meshed)."""

    def __init__(self, parent: Mesh, axes: Sequence[str]):
        self.parent, self.axes = parent, tuple(axes)
        self.shape = {a: (parent.shape[a] if a in axes else 1) for a in ALL_AXES}
        self.coords = {a: (parent.coords[a] if a in axes else 0) for a in ALL_AXES}
        self.size = math.prod(self.shape.values())
        self.rank, self.distributed = parent.rank, parent.distributed

    def group(self, *axes: str) -> Group:
        return self.parent.group(*(a for a in axes if a in self.axes))

    @property
    def trivial(self) -> bool:
        return self.size == 1


def _dist_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _world() -> Tuple[int, int]:
    if _dist_up():
        import torch.distributed as dist

        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(
    data: Optional[int] = None,
    expert: int = 1,
    context: int = 1,
    model: int = 1,
    pipe: int = 1,
    *,
    rank: Optional[int] = None,
    world: Optional[ThreadWorld] = None,
) -> Mesh:
    """A (data, expert, context, model, pipe) mesh over every rank: the
    process group's, or ``world``'s thread ranks (this one is ``rank``).
    ``data`` None absorbs the ranks the other axes leave."""
    if world is not None:
        n, rank = world.n, int(rank or 0)
    else:
        n, own = _world()
        rank = own if rank is None else rank
    other = expert * context * model * pipe
    if data is None:
        if n % other:
            raise ValueError(f"{n} devices not divisible by expert*context*model*pipe={other}")
        data = n // other
    if data * other != n:
        raise ValueError(f"mesh {data}x{expert}x{context}x{model}x{pipe} != {n} devices")
    shape = dict(zip(ALL_AXES, (data, expert, context, model, pipe)))
    return Mesh(shape, rank, world)


def single_device_mesh() -> Mesh:
    """The trivial mesh of one process (the common single-card case)."""
    return Mesh({}, 0)


def data_axis_for_batch(batch_size: int, devices: int, other: int) -> int:
    """``create_mesh_for_batch``'s data axis: the largest size that
    divides both the batch and ``devices // other``."""
    data = max(devices // other, 1)
    while data > 1 and batch_size % data:
        data -= 1
    return data


def create_mesh_for_batch(
    batch_size: int, expert: int = 1, context: int = 1, model: int = 1, pipe: int = 1,
    *, rank: Optional[int] = None, world: Optional[ThreadWorld] = None,
) -> Mesh:
    """A mesh whose data axis divides ``batch_size`` (the JAX package's
    rule, ``data_axis_for_batch``). Where that leaves ranks out, the JAX
    package leaves their devices idle; a rank here is a process that
    torchrun started for work, so it raises and names the rank count that
    fits."""
    n = world.n if world is not None else _world()[0]
    other = expert * context * model * pipe
    data = data_axis_for_batch(batch_size, n, other)
    if data * other != n:
        raise ValueError(
            f"create_mesh_for_batch: batch_size={batch_size} with expert={expert}, "
            f"context={context}, model={model}, pipe={pipe} uses {data * other} of {n} ranks; "
            f"start {data * other} ranks (or choose a batch the data axis divides)")
    return create_mesh(data, expert, context, model, pipe, rank=rank, world=world)


def maybe_initialize_distributed(device: Any = None) -> bool:
    """Start the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
    NCCL when ``device`` is ``cuda`` (each rank on card ``LOCAL_RANK``),
    gloo on the CPU. Without that environment a run is one process with no
    process group, and this returns False; with a group already up it
    returns True. NCCL that cannot start raises: nothing falls back to
    gloo on the card."""
    import torch.distributed as dist

    if _dist_up():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    if rank == 0:
        print(f"process group: {dist.get_backend()} over {world} rank(s)", flush=True)
    return True


def local_device(device: Any) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` under torchrun on the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


# ---------------------------------------------------------------------------
# slicing: a rank's block of a global array (NamedSharding's counterpart)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout: dimension i of an array splits over ``spec[i]`` (an axis
    name, or None for whole), the JAX package's ``PartitionSpec``. Called
    on a global array (tensor or numpy) it returns this rank's block;
    ``gather`` (every rank of the split axes calls it) rebuilds the global
    array from the blocks.

    ``blocks[i]`` > 1: dimension i is that many equal blocks, each split on
    its own, and a rank's part is its slice of every block, in block order
    (a fused qkv projection split by head: a rank holds the q, k and v
    columns of its heads). ``stage``: the tensor belongs to one GPipe stage
    and only that stage's ranks hold it (a stage's layers, whole)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]
    blocks: Tuple[int, ...] = ()
    stage: bool = False

    def _live(self):
        for dim, axis in enumerate(self.spec):
            if axis is not None and self.mesh.shape[axis] > 1:
                nb = self.blocks[dim] if dim < len(self.blocks) else 1
                yield dim, axis, nb

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes over which the ranks hold different parts."""
        own = {a for _, a, _ in self._live()}
        if self.stage and self.mesh.shape[AXIS_PIPE] > 1:
            own.add(AXIS_PIPE)
        return tuple(a for a in ALL_AXES if a in own)

    def dim_of(self, axis: str) -> Optional[int]:
        """The dimension split over ``axis``, or None."""
        return next((d for d, a, _ in self._live() if a == axis), None)

    def __call__(self, x):
        for dim, axis, nb in self._live():
            n, i = self.mesh.shape[axis], self.mesh.coords[axis]
            if x.shape[dim] % (n * nb):
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                                 f"{axis}={n}" + (f" in {nb} blocks" if nb > 1 else ""))
            step = x.shape[dim] // (n * nb)
            parts = [x[(slice(None),) * dim + (slice(b * n * step + i * step,
                                                     b * n * step + (i + 1) * step),)]
                     for b in range(nb)]
            x = parts[0] if nb == 1 else _cat(parts, dim)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from this rank's block ``x`` (no gradient)."""
        for dim, axis, nb in reversed(list(self._live())):
            pieces = self.mesh.group(axis).all_gather(x.detach().contiguous())
            if nb == 1:
                x = torch.cat(pieces, dim)
            else:
                split = [p.unflatten(dim, (nb, -1)) for p in pieces]
                x = torch.cat(split, dim + 1).flatten(dim, dim + 1)
        return x


def _cat(parts, dim):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, dim)
    return torch.cat(parts, dim)


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) dimension over the data axis."""
    return Sharding(mesh, (AXIS_DATA,))


def stacked_batch_sharding(mesh: Mesh) -> Sharding:
    """(k, B, ...) super-batches of fused steps: batch over data."""
    return Sharding(mesh, (None, AXIS_DATA))


def tokens_sharding(mesh: Mesh) -> Sharding:
    """(B, S) tokens: batch over data, sequence over context when it is
    larger than 1."""
    ctx = AXIS_CONTEXT if mesh.shape[AXIS_CONTEXT] > 1 else None
    return Sharding(mesh, (AXIS_DATA, ctx))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def expert_sharding(mesh: Mesh) -> Sharding:
    """The leading (expert) dimension of a stacked expert bank."""
    return Sharding(mesh, (AXIS_EXPERT,))


# The Megatron layout by module name (the JAX package's sets). Column-
# parallel modules split their output features over ``model`` (per-head or
# per-hidden slices that compute independently); row-parallel modules split
# their input features, and their partial outputs are summed over ``model``.
TP_COLUMN_PARALLEL = frozenset({
    "qkv_proj",            # fused attention in-projection (split by head)
    "topk_q_proj", "topk_k_proj", "topk_v_proj",
    "compressed_q_proj", "compressed_k_proj", "compressed_v_proj",
    "lm_head",             # vocab split; the logits are all-gathered
    "w_in",                # StatefulLayer up-projection (hidden split: the
                           # multiplex is elementwise over hidden)
})
TP_ROW_PARALLEL = frozenset({
    "out_proj", "topk_out_proj", "compressed_out_proj",
    "w_out",               # StatefulLayer down-projection
})
_WEIGHTS = ("weight", "weight_q")  # Dense / QDense (out, in): Flax's kernel transposed


def tp_param_spec(names: Sequence[str], leaf) -> Optional[tuple]:
    """The tensor-parallel dims of one parameter, or None to leave it
    alone: the JAX package's ``tp_param_spec`` for the port's names
    (``names``: the dotted name's parts) and layout. A spec has ``leaf``'s
    rank, with ``model`` on the split dim. Flax's column split of a
    ``kernel`` (its last dim) is dim -2 of the (out, in) ``weight``, its
    row split (dim -2) is dim -1; a column layer's ``bias`` and int8
    ``scale`` follow the output, a row layer's stay whole (added after the
    sum). The expert banks keep Flax's (E, d, h) / (E, h, d) layout:
    ``w_up``, ``b_up``, ``w_up_q`` and ``w_up_scale`` split on hidden,
    ``w_down`` and ``w_down_q`` as a row. The caller checks the axis size
    and that the dim divides."""
    if not names or not hasattr(leaf, "ndim") or leaf.ndim == 0:
        return None
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    none = (None,) * leaf.ndim

    def _at(dim: int) -> tuple:
        spec = list(none)
        spec[dim] = AXIS_MODEL
        return tuple(spec)

    if parent in TP_COLUMN_PARALLEL:
        if last in _WEIGHTS:
            return _at(-2) if leaf.ndim >= 2 else None
        if last in ("bias", "scale"):
            return _at(-1)
    if parent in TP_ROW_PARALLEL and last in _WEIGHTS:
        return _at(-1) if leaf.ndim >= 2 else None
    if last in ("w_up", "b_up", "w_up_q", "w_up_scale"):
        return _at(-1)
    if last in ("w_down", "w_down_q"):
        return _at(-2) if leaf.ndim >= 2 else None
    return None


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a host batch (the data axis)."""
    sharding = batch_sharding(mesh)
    return {k: sharding(v) for k, v in batch.items()}


def is_expert_param(name: str) -> bool:
    """A stacked expert-bank tensor: its path has an ``experts`` scope."""
    return "experts" in name.split(".")


def param_shardings(named: Mapping[str, Any], mesh: Mesh) -> Dict[str, Sharding]:
    """The expert rule of the JAX package's ``param_shardings``: tensors
    under an ``experts`` scope split their leading (expert) dimension over
    the expert axis when it divides; everything else is replicated."""
    ep = mesh.shape[AXIS_EXPERT]

    def rule(name, t):
        if is_expert_param(name) and ep > 1 and t.ndim >= 1 and t.shape[0] % ep == 0:
            return expert_sharding(mesh)
        return replicated(mesh)

    return {name: rule(name, t) for name, t in named.items()}
