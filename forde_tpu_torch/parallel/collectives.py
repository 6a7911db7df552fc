"""The collectives of the port's multi-device code: counterparts of the
``jax.lax`` collectives that the JAX package's ``parallel/*`` bodies call
inside ``shard_map`` (``axis_index``, ``axis_size``, ``ppermute``,
``all_gather(tiled=True)``, ``psum``, ``psum_scatter(tiled=True)``, ``pmean``,
``all_to_all``), and the two Megatron operators of tensor parallelism.

A rank runs its own PyTorch program on its local tensors; a collective
exchanges them with the other ranks of a ``Group`` (the ranks of a mesh
that differ only along some axes, ``core.mesh.Mesh.group``). Two
transports stand behind one small interface (``Group``):

* ``DistGroup``: ``torch.distributed`` (NCCL on the card, gloo on the
  CPU) over a subgroup of the process group. It is the only transport an
  entry point ever takes.
* ``ThreadGroup``: n ranks as threads of one process (``run_threads``)
  that exchange tensors through shared slots and a barrier. Only tests
  and ``chip_smoke.py`` use it, on the CPU or on one card, as the JAX
  package's tests use 8 virtual CPU devices. On the card every thread rank
  stays on the default stream, so a tensor handed over is ordered after
  the kernel that wrote it, and each rank's backward runs in its own thread
  (``torch.autograd.set_multithreading_enabled(False)``: the autograd
  engine's one worker thread per device would otherwise run every rank's
  CUDA backward, and the first collective there would wait forever).

Gradients. Each rank differentiates its own scalar, and the ranks'
scalars add up to the loss: a term that every rank of a group holds alike
(the result of ``psum`` or ``pmean``) is divided by the number of ranks
that hold it before it is added (train/step.py does this). Under that
convention each collective's backward is its transpose: ``ppermute`` the
inverse permutation, tiled ``all_gather`` the ``psum_scatter`` of the
cotangents (their sum over the group, of which each rank receives its own
slice) and ``psum_scatter`` the tiled ``all_gather``, ``psum`` a ``psum``,
``pmean`` a ``pmean``, ``all_to_all`` the ``all_to_all`` with split and
concat axes swapped.

Tensor parallelism (the ``model`` axis) under that convention: the output
of a row-parallel layer, a partial sum on each rank, becomes whole through
``reduce_from_model`` (a ``psum``, whose backward is a ``psum``). The input
of a column-parallel layer passes ``copy_to_model``: the identity forward,
and in the backward the mean of the ranks' cotangents, so that every
rank of the group holds the same cotangent of the replicated activation,
its share of the true one (Megatron's identity-forward, psum-backward
operator, divided by the group's size because each rank's scalar carries
1/size of the loss). ``tests/test_torch_collectives.py`` holds each against
``jax.grad`` through ``shard_map``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Perm = Sequence[Tuple[int, int]]
BARRIER_S = 600.0


class Group:
    """The ranks of one collective, ``ranks`` in the mesh's row-major
    order; this rank is ``ranks[index]``. Every method is one collective:
    all ranks of the group call it, in the same order."""

    ranks: Tuple[int, ...] = (0,)
    index: int = 0

    @property
    def size(self) -> int:
        return len(self.ranks)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group (a new tensor)."""
        return x.clone()

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x``, in rank order."""
        return [x.clone()]

    def ppermute(self, x: torch.Tensor, perm: Perm) -> torch.Tensor:
        """``x`` of the rank ``src`` for each (src, dst) pair whose dst is
        this rank; zeros where none is."""
        out = torch.zeros_like(x)
        for src, dst in perm:
            if dst == self.index == src:
                out.copy_(x)
        return out

    def all_to_all(self, chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Chunk j goes to rank j; returns the chunks received, by source."""
        return [c.clone() for c in chunks]

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of ``x`` (whose dim 0 splits into one
        block per rank): this rank's block of it."""
        return x.clone()


class LocalGroup(Group):
    """A group of one rank and no process group."""

    def __init__(self, rank: int = 0):
        self.ranks, self.index = (rank,), 0


class DistGroup(Group):
    """A group over ``torch.distributed``: ``pg`` None is the default
    group (the whole world)."""

    def __init__(self, ranks: Sequence[int], rank: int, pg=None):
        self.ranks, self.index, self.pg = tuple(ranks), list(ranks).index(rank), pg

    def all_reduce(self, x):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.pg)
        return out

    def all_gather(self, x):
        import torch.distributed as dist

        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in self.ranks]
        dist.all_gather(outs, x, group=self.pg)
        return outs

    def ppermute(self, x, perm):
        import torch.distributed as dist

        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for src, dst in perm:
            if src == self.index and dst == self.index:
                out.copy_(x)
            elif src == self.index:
                ops.append(dist.P2POp(dist.isend, x, self.ranks[dst], group=self.pg))
            elif dst == self.index:
                ops.append(dist.P2POp(dist.irecv, out, self.ranks[src], group=self.pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def all_to_all(self, chunks):
        import torch.distributed as dist

        send = torch.stack([c.contiguous() for c in chunks])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.pg)
        return list(recv.unbind(0))

    def reduce_scatter(self, x):
        import torch.distributed as dist

        x = x.contiguous()
        out = torch.empty((x.shape[0] // self.size, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x, group=self.pg)
        return out


class _Slots:
    """What the ranks of one thread group share: a slot per rank and a
    barrier."""

    def __init__(self, n: int):
        self.slots: List[Optional[torch.Tensor]] = [None] * n
        # a rank that never arrives (a fault: ranks out of step) breaks the
        # barrier after BARRIER_S instead of hanging its peers for ever
        self.barrier = threading.Barrier(n, timeout=BARRIER_S)


class ThreadGroup(Group):
    """A group of thread ranks (``run_threads``). An exchange writes this
    rank's tensor into its slot, waits for every rank, reads the slots and
    waits again before any slot is written anew. Every rank sums in rank
    order, so an all-reduce gives every rank the same bits."""

    def __init__(self, ranks: Sequence[int], rank: int, shared: _Slots):
        self.ranks, self.index, self.shared = tuple(ranks), list(ranks).index(rank), shared

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        s = self.shared
        s.slots[self.index] = x.detach()
        s.barrier.wait()
        got = list(s.slots)
        s.barrier.wait()
        return got

    def all_reduce(self, x):
        got = self._exchange(x)
        out = got[0].clone()
        for t in got[1:]:
            out += t
        return out

    def all_gather(self, x):
        return [t.clone() for t in self._exchange(x)]

    def ppermute(self, x, perm):
        got = self._exchange(x)
        out = torch.zeros_like(x)
        for src, dst in perm:
            if dst == self.index:
                out = got[src].clone()
        return out

    def all_to_all(self, chunks):
        got = self._exchange(torch.stack([c.detach() for c in chunks]))
        return [t[self.index].clone() for t in got]

    def reduce_scatter(self, x):
        got = self._exchange(x)
        n = x.shape[0] // self.size
        out = got[0][self.index * n:(self.index + 1) * n].clone()
        for t in got[1:]:
            out += t[self.index * n:(self.index + 1) * n]
        return out


class ThreadWorld:
    """The shared state of ``n`` thread ranks: one ``_Slots`` per group."""

    def __init__(self, n: int):
        self.n = n
        self._lock = threading.Lock()
        self._shared: Dict[Tuple[int, ...], _Slots] = {}

    def group(self, ranks: Sequence[int], rank: int) -> Group:
        ranks = tuple(ranks)
        if len(ranks) == 1:
            return LocalGroup(rank)
        with self._lock:
            shared = self._shared.setdefault(ranks, _Slots(len(ranks)))
        return ThreadGroup(ranks, rank, shared)

    def abort(self) -> None:
        """Break every barrier, so that ranks waiting on a rank that
        failed raise instead of waiting forever."""
        with self._lock:
            for s in self._shared.values():
                s.barrier.abort()


def run_threads(n: int, fn: Callable[[int, ThreadWorld], object]) -> list:
    """Run ``fn(rank, world)`` for ranks 0..n-1, each in its own thread
    (autograd's backward in that thread too), and return the results in
    rank order. If a rank raises, the others' barriers break and the first
    error is raised here."""
    world = ThreadWorld(n)
    results: list = [None] * n
    errors: list = [None] * n

    def target(rank: int) -> None:
        torch.autograd.set_multithreading_enabled(False)
        try:
            results[rank] = fn(rank, world)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[rank] = e
            world.abort()

    threads = [threading.Thread(target=target, args=(r,), name=f"rank{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        first = next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                     failed[0])
        raise first
    return results


# ---------------------------------------------------------------------------
# the collectives, with their transposes
# ---------------------------------------------------------------------------


def axis_index(group: Group) -> int:
    """This rank's position along the group (``lax.axis_index``)."""
    return group.index


def axis_size(group: Group) -> int:
    return group.size


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group; its backward sums the cotangents too."""
    return x if group.size == 1 else _PSum.apply(x, group)


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.size == 1 else psum(x, group) / group.size


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return group.ppermute(x, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return ctx.group.ppermute(g.contiguous(), inverse), None, None


def ppermute(x: torch.Tensor, group: Group, perm: Perm) -> torch.Tensor:
    """``lax.ppermute``: (src, dst) pairs of group indices; a rank that no
    pair sends to gets zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    if group.size == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, group, perm)


def _reduce_scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = group.size
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: axis {dim} of {tuple(x.shape)} does not split into {n}")
    lead = x.movedim(dim, 0)
    return group.reduce_scatter(lead.contiguous()).movedim(0, dim)


def _gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return torch.cat(group.all_gather(x.contiguous()), dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: the ranks' ``x`` concatenated along
    ``dim`` in rank order. Its backward is ``psum_scatter``: the
    cotangents summed over the group, of which this rank keeps its slice."""
    if group.size == 1:
        return x
    return _AllGather.apply(x, group, dim % x.ndim)


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def psum_scatter(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """``lax.psum_scatter(scatter_dimension=dim, tiled=True)``: the sum of
    the ranks' ``x`` over the group, split along ``dim`` into one block per
    rank, of which this rank gets its own (``reduce_scatter_tensor`` under
    ``torch.distributed``). Its backward is the tiled ``all_gather``."""
    if group.size == 1:
        return x
    return _PSumScatter.apply(x, group, dim % x.ndim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()) / ctx.group.size, None


def copy_to_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The input of a column-parallel layer (tensor parallelism over the
    ``model`` group): the identity; its backward averages the ranks'
    cotangents, so that each holds the same share of the replicated
    input's cotangent (see the module docstring)."""
    return x if group.size == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The output of a row-parallel layer: the ranks' partial sums added
    up (a ``psum`` over the ``model`` group, whose backward is a
    ``psum``)."""
    return psum(x, group)


def _all_to_all(x, group, split_axis, concat_axis):
    n = group.size
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not split "
                         f"into {n}")
    received = group.all_to_all([c.contiguous() for c in x.chunk(n, split_axis)])
    return torch.cat(received, concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, group: Group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all``: ``x`` split along ``split_axis`` into one chunk
    per rank, chunk j sent to rank j, the received chunks concatenated
    along ``concat_axis`` by source rank."""
    if group.size == 1:
        return x
    return _AllToAll.apply(x, group, split_axis % x.ndim, concat_axis % x.ndim)
