"""Clustering of neuron and expert statistics (port of
forde_tpu/brain/clustering.py): the GMM of ops/gmm.py, on the device.
Labels are arbitrary up to permutation."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from forde_tpu_torch.ops.gmm import fit_gmm


def cluster_neurons_gmm(
    aggregated_stats: torch.Tensor,
    num_clusters: int,
    generator: Optional[torch.Generator] = None,
    num_iters: int = 50,
    kmeans_iters: int = 10,
    init_means: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cluster (N, D) or (L, N, D) stats into ``num_clusters`` neuron
    types. Returns (int32 assignments, {weights, means, covariances})."""
    return fit_gmm(
        aggregated_stats.float(), num_clusters, generator,
        num_iters=num_iters, kmeans_iters=kmeans_iters, init_means=init_means,
    )


def cluster_experts(
    expert_stats: torch.Tensor,
    num_clusters: int = 3,
    generator: Optional[torch.Generator] = None,
    init_means: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cluster experts by usage statistics, (E, D) or (L, E, D), into one
    GMM over all rows. Cluster roles by convention: 0 generalist, 1
    specialist, 2 under-utilized. ``init_means`` (K, D) seeds the GMM."""
    shape = expert_stats.shape
    assignments, params = cluster_neurons_gmm(
        expert_stats.reshape(-1, shape[-1]), num_clusters, generator, init_means=init_means
    )
    return assignments.reshape(shape[:-1]), params
