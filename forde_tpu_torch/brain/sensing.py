"""Sensing: per-neuron statistics of the fast loop (port of
``hoyer_sparsity`` in forde_tpu/brain/sensing.py). Computed in fp32
whatever the input dtype."""

from __future__ import annotations

import torch


def hoyer_sparsity(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Hoyer sparsity (sqrt(N) - L1/L2) / (sqrt(N) - 1) along ``dim``.

    All-zero vectors and N == 1 both give 0.0, as in the JAX package.
    """
    x = x.float()
    n = x.shape[dim]
    l1 = x.abs().sum(dim)
    l2 = torch.sqrt((x * x).sum(dim))
    if n == 1:
        return torch.zeros_like(l1)
    safe_l2 = torch.where(l2 == 0, torch.ones_like(l2), l2)
    sparsity = (float(n) ** 0.5 - l1 / safe_l2) / (float(n) ** 0.5 - 1.0)
    return torch.where(l2 == 0, torch.zeros_like(sparsity), sparsity)
