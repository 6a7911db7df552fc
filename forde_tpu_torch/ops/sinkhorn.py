"""Sinkhorn-Knopp projection onto the doubly-stochastic manifold (port of
forde_tpu/ops/sinkhorn.py).

Two seeds, softplus(logits) and exp(logits / temperature), each followed
by a fixed number of alternating row / column normalisations with an
epsilon in every denominator. The matrices are tiny (num_streams <= 8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _normalize_iters(m: torch.Tensor, num_iterations: int, epsilon: float) -> torch.Tensor:
    for _ in range(num_iterations):
        m = m / (m.sum(dim=1, keepdim=True) + epsilon)
        m = m / (m.sum(dim=0, keepdim=True) + epsilon)
    return m


def sinkhorn_knopp(
    logits: torch.Tensor, num_iterations: int = 5, epsilon: float = 1e-8
) -> torch.Tensor:
    """Softplus-seeded variant."""
    m = F.softplus(logits.float()) + epsilon
    return _normalize_iters(m, num_iterations, epsilon).to(logits.dtype)


def sinkhorn_knopp_exp(
    logits: torch.Tensor,
    num_iterations: int = 5,
    temperature: float = 1.0,
    epsilon: float = 1e-8,
) -> torch.Tensor:
    """Exp/temperature-seeded variant, the one the model uses."""
    m = torch.exp(logits.float() / temperature) + epsilon
    return _normalize_iters(m, num_iterations, epsilon).to(logits.dtype)
