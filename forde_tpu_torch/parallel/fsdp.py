"""FSDP (``param_sharding="fsdp"``): each parameter of at least 2 x data
elements is held as a shard of its largest free dim over the data axis
(``train.state.param_layouts``), with its Adam moments and EMA, so that
per-rank parameter and optimizer memory falls by the size of the data
axis (ZeRO-3; the JAX package gets the gathers from GSPMD).

A module runs on its whole parameters: ``call(unit, *args)`` all-gathers
the shards of ``unit``'s parameters over the data axis just before the
call (``parallel.collectives.all_gather``, whose backward is the
``psum_scatter`` of their gradients: each rank receives its shard's
gradient summed over the data axis) and runs ``unit`` on them. Under
autograd the whole of the unit's parameters must not live from the
forward to the backward, or the per-rank memory would not fall: the call
runs under ``nn.remat.checkpoint``, which keeps only the unit's inputs and
in the backward gathers the parameters again and reruns the unit before
its backward (the stat buffers' writes are guarded by
``nn.remat.recomputing()`` and happen once). The units are the decoder's
blocks and its embedding, stream, norm and head modules, and the dual
encoder's blocks, embeddings, norms and projections. ``full(p)`` gathers
one parameter that a module reads directly (the towers' position and CLS
tokens): the ops that read them (add, concatenate, expand) keep no copy
for the backward.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch.func import functional_call

from forde_tpu_torch.core.mesh import AXIS_DATA, Mesh, Sharding
from forde_tpu_torch.nn import remat
from forde_tpu_torch.parallel.collectives import all_gather


def setup(model: torch.nn.Module, mesh: Mesh, layouts: Mapping[str, Sharding]) -> None:
    """Mark each parameter of ``model`` that ``layouts`` splits over the
    data axis with ``fsdp`` = (data group, dim), which ``full`` and
    ``call`` gather over."""
    if mesh.shape[AXIS_DATA] == 1:
        return
    group = mesh.group(AXIS_DATA)
    for name, p in model.named_parameters():
        dim = layouts[name].dim_of(AXIS_DATA) if name in layouts else None
        if dim is not None:
            p.fsdp = (group, dim)


def full(p: torch.Tensor) -> torch.Tensor:
    """The whole of an FSDP-split parameter (``p`` itself when it is not
    split)."""
    spec = getattr(p, "fsdp", None)
    return p if spec is None else all_gather(p, *spec)


def _split(unit: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in unit.named_parameters() if getattr(p, "fsdp", None) is not None}


def is_split(unit: torch.nn.Module) -> bool:
    """Whether ``unit`` holds an FSDP-split parameter."""
    return bool(_split(unit))


def call(unit: torch.nn.Module, *args, **kwargs):
    """``unit(*args, **kwargs)`` on the whole of its FSDP-split
    parameters, gathered for the call (and again in the backward)."""
    split = _split(unit)
    if not split:
        return unit(*args, **kwargs)

    def run(*inputs):
        return functional_call(unit, {n: full(p) for n, p in split.items()}, inputs, kwargs)

    if not torch.is_grad_enabled():
        return run(*args)
    return remat.checkpoint(run, *args)
