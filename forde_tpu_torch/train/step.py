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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


def loss_fn(
    model: torch.nn.Module, input_ids: torch.Tensor, aux_loss_weight: float,
    update_stats: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, lm, aux) of one batch; ``update_stats`` adds the call's
    router statistics to the MoE buffers."""
    logits, aux_loss = model(input_ids, update_stats=update_stats)
    lm = lm_loss(logits, input_ids)
    return lm + aux_loss_weight * aux_loss, lm, aux_loss


def train_step(
    state: TrainState, batch: Batch, aux_loss_weight: float = 1.0
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step in place. Returns (state, metrics):
    ``loss/total``, ``loss/lm``, ``loss/aux`` and ``training/grad_norm``
    (the global norm of the gradients before clipping)."""
    params = state.optimizer.params
    total, lm, aux = loss_fn(state.model, batch["input_ids"], aux_loss_weight)
    grads = torch.autograd.grad(total, params, materialize_grads=True)
    grad_norm = state.optimizer.step(grads)
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
        for mb in ids.reshape(accum_steps, b // accum_steps, *ids.shape[1:]):
            total, lm, aux = loss_fn(state.model, mb, aux_loss_weight)
            g = torch.autograd.grad(total, params, materialize_grads=True)
            torch._foreach_add_(grads, [x.float() for x in g])
            sums += torch.stack([total.detach(), lm.detach(), aux.detach()]).float()
        inv = 1.0 / accum_steps
        torch._foreach_mul_(grads, inv)
        grad_norm = state.optimizer.step(grads)
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
    _, lm, aux = loss_fn(state.model, batch["input_ids"], 0.0, update_stats=False)
    return {"loss/lm": lm, "loss/aux": aux}
