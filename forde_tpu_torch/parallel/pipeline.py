"""GPipe pipeline parallelism over the ``pipe`` mesh axis (port of
forde_tpu/parallel/pipeline.py).

Stage s of S owns the decoder layers [s*L/S, (s+1)*L/S) and keeps only
their parameters, Adam moments and stat buffers (``drop_other_stages``,
called by ``train.state.shard_model``); the other layers are ``Elsewhere``
placeholders. The model stays an unrolled ``ModuleList``: the JAX
package's ``--scan_layers`` stacks the layers so that a stage's slice is a
shard of dim 0, and here it is the checkpoint layout, which the flag still
requires, as the JAX loop does.

Schedule (classic GPipe, the JAX package's SPMD form): the batch splits
into M microbatches. At tick t (t = 0..M+S-2) every stage applies its
layers to its current activation: stage 0 takes microbatch t, the others
what the previous stage sent, and stage S-1 emits microbatch t-(S-1); the
activations (the streams under mHC) move one stage down the ring with
``ppermute``. Every stage computes every tick and the ticks outside a
stage's window [s, s+M) are masked out of its outputs, aux loss and stats
with ``torch.where`` on a tensor condition: a stage-dependent branch would
build a different autograd graph on each rank, and the ``ppermute``
backwards would then run in different orders (a hang on the thread
transport). The (S-1)/(M+S-1) bubble is computed, as in the JAX package.

Semantics (the JAX package's): the logits are the unpipelined model's;
the MoE aux loss is the mean over microbatches of their own aux losses;
the expert-usage deltas are divided by M, so that they equal one
full-batch forward's, and ``step_count`` advances by 1 per optimizer step
(``merge_stats``). The prologue (embeddings, initial streams) and the
epilogue (stream collapse, final norm, ``lm_head``) run on every stage;
the last stage's outputs reach all stages by a ``psum`` over pipe. Under
data parallelism each microbatch's rows split over data, each stage runs
its blocks on its own rows (the MoE aux loss and usage of its shard, as
the JAX stage program runs the blocks un-meshed), and the aux loss and
the stat deltas are averaged over data. An expert axis still splits the
expert banks of capacity dispatch inside a stage (the blocks see the mesh
restricted to it); ``--moe_dispatch ep`` does not compose, as in the JAX
package.

Gradients follow the port's convention (parallel/collectives.py): the
pipe ranks hold the same tokens, so each differentiates 1/S of their loss;
the ``psum`` over pipe gives the last stage's outputs their whole
cotangent, the ``ppermute`` backwards carry it down the stages, stage 0's
embeddings receive it, and ``train.step.reduce_gradients`` sums the
prologue's and epilogue's gradients over pipe (they count once) and a
stage's layers over the other axes only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.core.mesh import AXIS_DATA, AXIS_EXPERT, AXIS_PIPE
from forde_tpu_torch.parallel import fsdp
from forde_tpu_torch.parallel.collectives import pmean, ppermute, psum


class Elsewhere(torch.nn.Module):
    """A decoder layer that another GPipe stage holds."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this layer belongs to another pipeline stage")


def stage_layers(mesh, num_layers: int) -> range:
    """The layers this rank's stage owns."""
    stages = mesh.shape[AXIS_PIPE]
    if num_layers % stages:
        raise ValueError(f"pipe axis {stages} must divide num_layers {num_layers}")
    per = num_layers // stages
    s = mesh.coords[AXIS_PIPE]
    return range(s * per, (s + 1) * per)


def drop_other_stages(model: torch.nn.Module, mesh) -> List[torch.Tensor]:
    """Under a pipe axis, replace the decoder layers of the other stages
    by ``Elsewhere`` and point the kept layers' modules at the mesh
    restricted to its expert axis; returns the parameters dropped."""
    if mesh.shape[AXIS_PIPE] == 1 or not isinstance(getattr(model, "layers", None),
                                                   torch.nn.ModuleList):
        return []
    keep = stage_layers(mesh, len(model.layers))
    dropped: List[torch.Tensor] = []
    view = mesh.restrict(AXIS_EXPERT)
    for i, layer in enumerate(model.layers):
        if i in keep:
            for module in layer.modules():
                if "mesh" in vars(module):
                    module.mesh = view
        else:
            dropped.extend(layer.parameters())
            model.layers[i] = Elsewhere()
    return dropped


def _stat_buffers(model, layers) -> Dict[str, torch.Tensor]:
    """The MoE stat buffers of ``layers`` by their names in ``model``."""
    mine = {id(b) for i in layers for b in model.layers[i].buffers()}
    return {n: b for n, b in model.named_buffers()
            if id(b) in mine and n.endswith(("expert_usage", "step_count"))}


def pp_forward(model: torch.nn.Module, input_ids: torch.Tensor, mesh,
               num_microbatches: int) -> Tuple[torch.Tensor, torch.Tensor,
                                               Optional[Dict[str, torch.Tensor]]]:
    """The pipelined forward of a ``FORDEDecoderLM`` put on ``mesh`` by
    ``train.state.shard_model``. ``input_ids``: this rank's rows, M
    microbatches in order (``train.step.lm_batch`` with ``accum_steps``
    M). Returns (fp32 logits of those rows, the aux loss averaged over the
    microbatches, {stat buffer name: its delta} for this stage's MoE
    layers, or None without MoE): usage deltas over M, step_count deltas
    0 (``merge_stats`` adds them)."""
    cfg = model.config
    if not cfg.scan_layers:
        raise ValueError("pipeline parallelism requires scan_layers=True")
    stages = mesh.shape[AXIS_PIPE]
    m = num_microbatches
    b, s = input_ids.shape
    if b % m:
        raise ValueError(f"num_microbatches {m} must divide the batch {b}")
    pipe = mesh.group(AXIS_PIPE)
    stage = pipe.index
    device = input_ids.device
    layers = stage_layers(mesh, cfg.num_layers)
    mhc = cfg.use_hyper_connections

    x, streams = model.embed(input_ids, torch.arange(s, device=device)[None, :])
    carried = streams if mhc else x
    feed = carried.reshape(m, b // m, *carried.shape[1:])
    buffers = _stat_buffers(model, layers)
    start = {n: t.clone() for n, t in buffers.items()}
    deltas = {n: torch.zeros_like(t) for n, t in buffers.items()}

    first = torch.tensor(stage == 0, device=device)
    last = torch.tensor(stage == stages - 1, device=device)
    recv = torch.zeros_like(feed[0])
    outs = [torch.zeros_like(feed[0]) for _ in range(m)]
    aux_acc = torch.zeros((), device=device)
    ring = [(i, (i + 1) % stages) for i in range(stages)]
    ticks = m + stages - 1
    for t in range(ticks):
        y = torch.where(first, feed[min(t, m - 1)], recv)
        active = torch.tensor(0 <= t - stage < m, device=device)
        aux = torch.zeros((), device=device)
        for i in layers:
            out, new_streams, a = fsdp.call(model.layers[i], y[:, :, 0, :] if mhc else y,
                                            y if mhc else None, None, None, None, None,
                                            True, True)
            y = new_streams if mhc else out
            aux = aux + a
        aux_acc = aux_acc + torch.where(active, aux, 0.0)
        with torch.no_grad():  # this tick's stat writes, kept where the tick is real
            for n, buf in buffers.items():
                deltas[n] += torch.where(active, buf - start[n], 0)
                buf.copy_(start[n])
        if 0 <= t - (stages - 1) < m:
            outs[t - (stages - 1)] = torch.where(last, y, outs[t - (stages - 1)])
        if t < ticks - 1:
            recv = ppermute(y, pipe, ring)

    out = psum(torch.cat(outs), pipe)  # only the last stage's are non-zero
    data = mesh.group(AXIS_DATA)
    aux_total = pmean(psum(aux_acc, pipe), data)
    stats = None
    if buffers:
        stats = {}
        for n, d in deltas.items():
            if n.endswith("step_count"):
                stats[n] = torch.zeros_like(d)
            else:
                stats[n] = (d if data.size == 1 else data.all_reduce(d) / data.size) / m
    logits = model.head(out[:, :, 0, :] if mhc else out, out if mhc else None)
    return logits, aux_total / m, stats


@torch.no_grad()
def merge_stats(model: torch.nn.Module, stats_delta: Optional[Dict[str, torch.Tensor]],
                step_increment: int = 1) -> None:
    """Fold a ``pp_forward`` stats delta into the model's buffers: usage
    sums accumulate, ``step_count`` advances by ``step_increment`` (1 per
    optimizer step: microbatches are not steps)."""
    if not stats_delta:
        return
    buffers = dict(model.named_buffers())
    for name, delta in stats_delta.items():
        if name.endswith("step_count"):
            buffers[name] += step_increment
        else:
            buffers[name] += delta


def make_pp_train_step(mesh, num_microbatches: int, aux_loss_weight: float = 1.0):
    """One optimizer step over the pipelined forward: ``train.step.
    train_step`` (the same metric keys) with the L blocks run by the GPipe
    schedule and the stats folded back by ``merge_stats``. The batch is
    ``train.step.lm_batch(ids, mesh, num_microbatches)``."""
    from forde_tpu_torch.train.step import Shares, reduce_gradients

    def step(state, batch):
        model = state.model
        logits, aux, delta = pp_forward(model, batch["input_ids"], mesh, num_microbatches)
        shares = Shares(mesh, batch["labels"])
        share = F.cross_entropy(logits.float().flatten(0, 1),
                                batch["labels"].long().flatten(), ignore_index=-100,
                                reduction="sum") / shares.targets
        lm = shares.total(share)
        objective = shares.objective(share, aux_loss_weight * aux)
        params = state.optimizer.params
        grads = torch.autograd.grad(objective, params, materialize_grads=True)
        grad_norm = state.optimizer.step(reduce_gradients(state, grads))
        merge_stats(model, delta)
        state.step += 1
        return state, {
            "loss/total": lm + aux_loss_weight * aux.detach(),
            "loss/lm": lm,
            "loss/aux": aux.detach(),
            "training/grad_norm": grad_norm,
        }

    return step
