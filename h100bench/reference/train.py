"""The reference's first training steps: the loss, its gradients by
autograd, global-norm clipping and AdamW, written from optax's
definitions (``clip_by_global_norm`` then ``adamw``: b1 0.9, b2 0.999, eps
1e-8, weight decay on every parameter, the bias corrections at step t).

``readings`` returns what the comparison reads: each step's total loss,
each leaf's norm (``compare.leaf_norms``) of the first step's clipped
gradient (what the optimizer takes in) and the norm of each row of the
token embedding's, each leaf's norm of its change after the steps, and
the router usage (L, E) summed over the steps.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from h100bench.compare import leaf_norms

B1, B2, EPS = 0.9, 0.999, 1e-8


def readings(params: Dict[str, torch.Tensor], names: Sequence[str], batches: List,
             loss_fn: Callable, lr: float, weight_decay: float, clip: float,
             rows: str = "token_embed.weight") -> dict:
    """``loss_fn(p, batch) -> (total loss, usage)`` over the dict ``p`` of
    every tensor; ``names`` are those trained (the others are read only);
    ``rows`` is the embedding whose first gradient is read row by row."""
    names = list(names)
    p = dict(params)
    leaves = [params[n].detach().clone().requires_grad_(True) for n in names]
    p.update(zip(names, leaves))
    mu = [torch.zeros_like(x) for x in leaves]
    nu = [torch.zeros_like(x) for x in leaves]
    losses, usage, out = [], None, {}
    for t, ids in enumerate(batches, 1):
        total, u = loss_fn(p, ids)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads)).float()
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        grads = [g * scale for g in grads]
        if t == 1:
            out["grad_norms"] = leaf_norms(zip(names, grads))
            out["embed_rows"] = grads[names.index(rows)].norm(dim=-1).cpu()
        with torch.no_grad():
            for x, g, m, v in zip(leaves, grads, mu, nu):
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).addcmul_(g, g, value=1 - B2)
                update = (m / (1 - B1 ** t)) / ((v / (1 - B2 ** t)).sqrt() + EPS)
                x.sub_(lr * (update + weight_decay * x))
        losses.append(float(total.detach()))
        usage = u if usage is None else usage + u
    out["change_norms"] = leaf_norms((n, x.detach() - params[n]) for n, x in zip(names, leaves))
    return dict(out, losses=losses, usage=usage.cpu())
