"""Knowledge distillation: a (small) student trained against a frozen
teacher's logits (port of forde_tpu/train/distill.py). The workflow it
serves is speculative decoding (models/speculative.py): distill a 1-2
layer draft from the full target so that its proposals are accepted often.

Loss per step (Hinton et al.):

    total = alpha * CE(student, shifted labels)
          + (1 - alpha) * T^2 * KL( softmax(teacher/T) || softmax(student/T) )
          + aux_loss_weight * moe_aux

The teacher's forward runs under ``torch.no_grad()`` with its stat
buffers left as they are, and its logits go to fp32. On a mesh (the
teacher built on the student's, ``load_teacher(mesh=)``) each rank adds
its shares of the global batch's CE and KL means (train/step.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.train.state import TrainState
from forde_tpu_torch.train.step import Shares, lm_loss, reduce_gradients


def make_distill_step(
    teacher_model: torch.nn.Module,
    aux_loss_weight: float = 0.0,
    alpha: float = 0.5,
    temperature: float = 2.0,
):
    """A ``(state, batch) -> (state, metrics)`` distillation step. The
    teacher must share the student's vocabulary. Metrics: the train step's
    and ``loss/kl``."""

    def distill_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Tuple[TrainState, Dict]:
        ids = batch["input_ids"]
        with torch.no_grad():
            t_logits, _ = teacher_model(ids, update_stats=False)
            t_lp = F.log_softmax(t_logits.float() / temperature, dim=-1)
        logits, aux = state.model(ids, update_stats=True)
        logits = logits.float()
        s_lp = F.log_softmax(logits / temperature, dim=-1)
        kl_rows = (torch.exp(t_lp) * (t_lp - s_lp)).sum(-1)
        if "labels" in batch:
            shares = Shares(state.model.mesh, batch["labels"])
            lm_share = F.cross_entropy(logits.flatten(0, 1), batch["labels"].long().flatten(),
                                       ignore_index=-100, reduction="sum") / shares.targets
            kl_share = kl_rows.sum() / shares.positions * temperature ** 2
            objective = shares.objective(alpha * lm_share + (1.0 - alpha) * kl_share,
                                         aux_loss_weight * aux)
            lm, kl = shares.total(lm_share), shares.total(kl_share)
            total = alpha * lm + (1.0 - alpha) * kl + aux_loss_weight * aux.detach()
        else:
            lm = lm_loss(logits, ids)
            kl = kl_rows.mean() * temperature ** 2
            total = objective = alpha * lm + (1.0 - alpha) * kl + aux_loss_weight * aux
        grads = torch.autograd.grad(objective, state.optimizer.params, materialize_grads=True)
        grad_norm = state.optimizer.step(reduce_gradients(state, grads))
        state.step += 1
        return state, {
            "loss/total": total.detach(),
            "loss/lm": lm.detach(),
            "loss/kl": kl.detach(),
            "loss/aux": aux.detach(),
            "training/grad_norm": grad_norm,
        }

    return distill_step


def load_teacher(checkpoint_dir: str, device, mesh=None) -> torch.nn.Module:
    """The teacher from a train.loop checkpoint (``model_config.json`` +
    ``params.npz``; a LoRA checkpoint arrives merged), frozen, on
    ``device``; on ``mesh`` it runs the multi-device paths, with this
    rank's part of its parameters (``train.state.shard_model``). The JAX package returns (model,
    variables); the port's model holds its weights."""
    from forde_tpu_torch.train.checkpoint import load_lm_params
    from forde_tpu_torch.train.state import shard_model

    _, model = load_lm_params(checkpoint_dir, device, mesh=mesh)
    if mesh is not None:
        shard_model(model, mesh)
    return model.requires_grad_(False)
