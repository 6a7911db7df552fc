"""The decoder LM's train and eval steps (port of forde_tpu/train/step.py).

``train_step`` runs the model with the MoE stat buffers updating, takes
the shifted next-token cross-entropy in fp32 (the logits at position t
predict the token at t + 1), adds ``aux_loss_weight`` times the MoE
load-balancing loss, and applies one clipped AdamW update in place. A
parameter that the loss does not reach (the NSA importance scorer, whose
output only picks indices) gets a zero gradient, as under ``jax.grad``, so
AdamW still decays it. The metrics carry the JAX package's keys, as 0-d
tensors on the model's device (no host synchronisation).

``make_accum_train_step`` takes one optimizer step from several
microbatches' gradients (gradient accumulation).

On a mesh (a state from ``train.state.shard_train_state``) each rank runs
its block of the global batch (``lm_batch``: its rows over data, its
positions over context, and its block of the shifted targets, so that a
context block's last target is the next block's first token). A rank
differentiates its share of the global batch's loss (``Shares``): its
summed cross-entropy over the global target count, divided by the number
of ranks that hold the same tokens (along the expert, model and pipe
axes), plus the aux loss (the same on every rank) over the number of
ranks. ``reduce_gradients`` then sums every gradient once over the ranks
that hold the same part of its parameter: the whole mesh for a replicated
one, the data and context axes for a slice of an expert bank.
Every step builder (this module's, LoRA's, distillation's, the dual
encoder's) calls it between the backward and the optimizer, so EMA follows
the reduced parameters. The metrics are the global batch's on every rank.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.core import mesh as mesh_lib
from forde_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def lm_loss(logits: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits[:, :-1]`` (fp32) against
    ``input_ids[:, 1:]``. The last position's label is ignored rather than
    sliced away, so the (B, S, V) logits are not copied."""
    labels = F.pad(input_ids[:, 1:].long(), (0, 1), value=-100)
    return F.cross_entropy(
        logits.float().flatten(0, 1), labels.flatten(), ignore_index=-100
    )


def lm_batch(input_ids, mesh: Optional["mesh_lib.Mesh"], accum_steps: int = 1) -> Batch:
    """This rank's part of a global (B, S) batch of token ids (a tensor):
    ``input_ids`` and ``labels``, the shifted targets (-100 where a
    position has none), each split as ``tokens_sharding`` splits tokens.
    With ``accum_steps`` each of the microbatches (B / accum_steps rows,
    in order) is split on its own, so that a rank's k-th microbatch is its
    part of the global k-th one. No mesh, or the trivial one: the batch
    as it is."""
    if mesh is None or mesh.trivial:
        return {"input_ids": input_ids}
    labels = F.pad(input_ids[:, 1:], (0, 1), value=-100)
    sharding = mesh_lib.tokens_sharding(mesh)
    b = input_ids.shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} not divisible by grad_accum {accum_steps}")

    def split(x):
        parts = x.reshape(accum_steps, b // accum_steps, *x.shape[1:]).unbind(0)
        return torch.cat([sharding(p) for p in parts]).contiguous()

    return {"input_ids": split(input_ids), "labels": split(labels)}


class Shares:
    """How this rank's loss terms add up to the global batch's loss, for
    a local (B_local, S_local) ``labels`` block on ``mesh``."""

    def __init__(self, mesh: "mesh_lib.Mesh", labels: torch.Tensor):
        self.tokens = mesh.group(mesh_lib.AXIS_DATA, mesh_lib.AXIS_CONTEXT)
        # the ranks that hold the same tokens
        self.replicas = mesh.size // self.tokens.size
        self.world = mesh.size
        b, s = labels.shape
        self.positions = b * s * self.tokens.size  # B * S of the global batch
        self.targets = self.positions - b * mesh.shape[mesh_lib.AXIS_DATA]  # B * (S - 1)

    def total(self, share: torch.Tensor) -> torch.Tensor:
        """The global value of a local share (a metric: no gradient)."""
        return self.tokens.all_reduce(share.detach().float().reshape(1))[0]

    def objective(self, local: torch.Tensor, replicated: torch.Tensor) -> torch.Tensor:
        """What this rank differentiates: ``local`` its share of a sum over
        the global batch, ``replicated`` a term every rank holds alike."""
        return local / self.replicas + replicated / self.world


def lm_losses(model: torch.nn.Module, logits: torch.Tensor, aux: torch.Tensor, batch: Batch,
              aux_loss_weight: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(objective, total, lm) of one forward: without ``labels`` the
    batch's mean shifted cross-entropy (the objective is the total); with
    them (``lm_batch``) this rank's share of the global batch's."""
    if "labels" not in batch:
        lm = lm_loss(logits, batch["input_ids"])
        total = lm + aux_loss_weight * aux
        return total, total, lm
    shares = Shares(model.mesh, batch["labels"])
    share = F.cross_entropy(logits.float().flatten(0, 1), batch["labels"].long().flatten(),
                            ignore_index=-100, reduction="sum") / shares.targets
    lm = shares.total(share)
    objective = shares.objective(share, aux_loss_weight * aux)
    return objective, lm + aux_loss_weight * aux.detach(), lm


def loss_fn(
    model: torch.nn.Module, batch: Batch, aux_loss_weight: float, update_stats: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(objective, total, lm, aux) of one batch (``lm_losses``);
    ``update_stats`` adds the call's router statistics to the MoE
    buffers."""
    logits, aux_loss = model(batch["input_ids"], update_stats=update_stats)
    objective, total, lm = lm_losses(model, logits, aux_loss, batch, aux_loss_weight)
    return objective, total, lm, aux_loss


def reduce_gradients(state, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each gradient over the ranks that hold the same part of its
    parameter: every mesh axis but those its layout splits
    (``state.layouts``). A replicated parameter sums over the whole mesh,
    a slice of an expert bank over data and context, a tensor-parallel
    slice over all but the model axis, a GPipe stage's layer over all but
    the pipe axis; an FSDP shard arrives summed over the data axis already
    (the ``psum_scatter`` of its gather's backward) and is not summed over
    it again. One all-reduce per set of axes, over the gradients flattened
    into one fp32 buffer. Under ``torch.distributed`` it runs even on one
    rank (one NCCL all-reduce in a fused step's CUDA graph); on one process
    with no process group it returns ``grads``."""
    mesh = state.mesh
    if mesh is None or (mesh.trivial and not mesh.distributed):
        return list(grads)
    layouts = state.layouts or [mesh_lib.Sharding(mesh, ())] * len(grads)
    kinds: Dict[Tuple[str, ...], List[int]] = {}
    for i, sh in enumerate(layouts):
        kinds.setdefault(tuple(a for a in mesh_lib.ALL_AXES if a not in sh.axes), []).append(i)
    out = list(grads)
    for axes, idx in kinds.items():
        group = mesh.group(*axes)
        if group.size == 1 and not mesh.distributed:
            continue
        flat = group.all_reduce(torch.cat([grads[i].float().reshape(-1) for i in idx]))
        for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = piece.view(grads[i].shape).to(grads[i].dtype)
    return out


def train_step(
    state: TrainState, batch: Batch, aux_loss_weight: float = 1.0
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step in place. Returns (state, metrics):
    ``loss/total``, ``loss/lm``, ``loss/aux`` and ``training/grad_norm``
    (the global norm of the gradients before clipping)."""
    params = state.optimizer.params
    objective, total, lm, aux = loss_fn(state.model, batch, aux_loss_weight)
    grads = torch.autograd.grad(objective, params, materialize_grads=True)
    grad_norm = state.optimizer.step(reduce_gradients(state, grads))
    state.step += 1
    return state, {
        "loss/total": total.detach(),
        "loss/lm": lm.detach(),
        "loss/aux": aux.detach(),
        "training/grad_norm": grad_norm,
    }


def make_accum_train_step(accum_steps: int, aux_loss_weight: float = 1.0):
    """Gradient accumulation: one optimizer step from ``accum_steps``
    sequential microbatch forwards and backwards (port of the JAX
    package's ``make_accum_train_step``).

    The (B, S) batch splits on axis 0 into ``accum_steps`` equal
    microbatches (an uneven split raises). Gradients are summed in fp32
    and scaled by ``1 / accum_steps``, and so are the total, LM and aux
    losses: the gradients and the LM loss average as the full batch's
    would, up to fp32 summation order. As in the JAX package, the MoE
    load-balancing aux loss is averaged per microbatch (it is not linear in
    the batch's composition), and the stat buffers see ``accum_steps``
    updates per optimizer step, ``step_count`` advancing with them. Peak
    activation memory is one microbatch's."""

    def accum_train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        ids = batch["input_ids"]
        b = ids.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by grad_accum {accum_steps}")
        params = state.optimizer.params
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        sums = torch.zeros(3, dtype=torch.float32, device=ids.device)
        micro = {k: v.reshape(accum_steps, b // accum_steps, *v.shape[1:]).unbind(0)
                 for k, v in batch.items()}
        for i in range(accum_steps):
            mb = {k: v[i] for k, v in micro.items()}
            objective, total, lm, aux = loss_fn(state.model, mb, aux_loss_weight)
            g = torch.autograd.grad(objective, params, materialize_grads=True)
            torch._foreach_add_(grads, [x.float() for x in g])
            sums += torch.stack([total.detach(), lm.detach(), aux.detach()]).float()
        inv = 1.0 / accum_steps
        torch._foreach_mul_(grads, inv)
        grad_norm = state.optimizer.step(reduce_gradients(state, grads))
        state.step += 1
        sums *= inv
        return state, {
            "loss/total": sums[0],
            "loss/lm": sums[1],
            "loss/aux": sums[2],
            "training/grad_norm": grad_norm,
        }

    return accum_train_step


@torch.no_grad()
def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
    """Forward-only loss: no stat update, no gradients."""
    _, _, lm, aux = loss_fn(state.model, batch, 0.0, update_stats=False)
    return {"loss/lm": lm, "loss/aux": aux}
