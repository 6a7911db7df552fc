"""Clustering of neuron statistics into neuron types (port of
``cluster_neurons_gmm`` in forde_tpu/brain/clustering.py): the GMM of
ops/gmm.py, on the device. Labels are arbitrary up to permutation."""

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
