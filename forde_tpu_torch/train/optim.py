"""Global-norm clipping and AdamW with optax's semantics, optionally with
both moments stored in bfloat16 (port of forde_tpu/train/optim.py and of
the chain ``make_optimizer`` builds in forde_tpu/train/state.py).

One step, over every parameter of the model (``logit_scale`` included,
as ``optax.adamw`` with no mask decays it), never over the gradient taps
or the stat buffers, which are not parameters:

    clip:   g <- g                    if ||g|| < max_norm  (optax's select)
            g <- g * max_norm / ||g|| otherwise
    adam:   m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
            u  = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps),  t = count + 1
    decay:  u <- u + weight_decay * p
    lr:     p <- p - lr(count) * u    (the schedule read at the count before
                                       this step: with warmup, step 1's LR is 0)

``torch.nn.utils.clip_grad_norm_`` is not used: it divides by
``||g|| + 1e-6`` and so differs from optax. With ``moment_dtype`` bfloat16
both moments are stored in bf16 and widened for the update, whose math
stays fp32; ``None`` stores them in the parameter dtype (``optax.adamw``).
The update is written with ``torch._foreach_*`` ops and runs in place, on
the parameters' device, with no host synchronisation. The step count is an
int32 tensor on that device, as optax keeps it, and the bias corrections
and a scheduled LR are computed from it there in fp32: a step captured in
a CUDA graph reads them anew on every replay.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence, Union

import torch

if TYPE_CHECKING:
    from forde_tpu_torch.train.state import LRSchedule


class AdamW:
    # optax.adamw's defaults, the only values the JAX package uses
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        learning_rate: Union[float, "LRSchedule"],
        weight_decay: float = 0.0,
        grad_clip_norm: Optional[float] = 1.0,
        moment_dtype: Optional[torch.dtype] = None,
    ):
        self.params: List[torch.Tensor] = list(params)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.moment_dtype = moment_dtype
        self.mu = [torch.zeros_like(p, dtype=moment_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype or p.dtype) for p in self.params]
        device = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=device)  # steps taken

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update of every parameter in place from ``grads`` (one per
        parameter, same order). Returns the global norm of ``grads`` before
        clipping, as a 0-d fp32 tensor on the parameters' device."""
        grads = [g.float() for g in grads]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip_norm is not None:
            scale = torch.where(
                norm < self.grad_clip_norm,
                torch.ones_like(norm),
                self.grad_clip_norm / norm,
            )
            grads = torch._foreach_mul(grads, scale)
        lr = self.learning_rate
        lr = float(lr) if isinstance(lr, (int, float)) else lr.at(self.count)  # before the increment
        self.count.add_(1)
        # Bias corrections in fp32 from the int32 count, as optax computes them.
        t = self.count.to(torch.float32)
        c1, c2 = 1.0 - torch.pow(self.b1, t), 1.0 - torch.pow(self.b2, t)
        lowp = self.moment_dtype is not None
        mu = [m.float() for m in self.mu] if lowp else self.mu
        nu = [v.float() for v in self.nu] if lowp else self.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, c1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        if isinstance(lr, float):
            torch._foreach_add_(self.params, updates, alpha=-lr)
        else:
            torch._foreach_mul_(updates, lr)
            torch._foreach_sub_(self.params, updates)
        if lowp:
            torch._foreach_copy_(self.mu, mu)
            torch._foreach_copy_(self.nu, nu)
        return norm
