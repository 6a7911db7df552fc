"""Dual-encoder slow loop: the per-neuron brain update of every
StatefulLayer (port of forde_tpu/brain/neuron_slow_loop.py).

Per StatefulLayer:
  1. SENSE   — average the accumulated [act_gini, act_gdp, act_var] sums
               (the layer's ``act_stats`` / ``step_count`` buffers) and the
               [grad_gini, grad_gdp] sums (the train state's ``grad_stats``
               over ``grad_step_count`` steps) into an (F, 5) matrix ordered
               [grad_gini, grad_gdp, act_gini, act_gdp, act_var].
  2. CLUSTER — GMM into ``num_clusters`` neuron types, then relabel by
               ascending mean grad_gini: 0 = Generalist (relu), 1 = Pooling
               (tanh), 2 = Specialist (binary step). Forde-lite replaces
               the GMM with the rule-based assigner.
  3. SMOOTH  — mode filter over a near-square 2-D grid of the neurons.
  4. ACTUATE — write the new assignments into ``neuron_assignments``; a
               layer that sensed no step keeps its old ones.
  5. RESET   — zero both accumulators and both step counts.

The update runs on the model's device, in place, with no host
synchronisation: layers of one width go through one batched GMM call.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from forde_tpu_torch.brain.clustering import cluster_neurons_gmm
from forde_tpu_torch.brain.smoothing import near_square_grid, smooth_assignments
from forde_tpu_torch.core.config import BrainConfig
from forde_tpu_torch.nn.stateful import stateful_layers


def forde_lite_assignments(stats: torch.Tensor, brain: BrainConfig) -> torch.Tensor:
    """Rule-based assigner: instantaneous thresholds instead of a GMM.
    stats (..., F, 5) -> int32 (..., F)."""
    is_spec = stats[..., 0] > brain.lite_spec_grad_gini
    is_pool = (~is_spec) & (stats[..., 2] < brain.lite_pool_act_gini)
    return torch.where(is_spec, 2, torch.where(is_pool, 1, 0)).to(torch.int32)


def canonicalize_labels(
    assignments: torch.Tensor, grad_gini: torch.Tensor, num_clusters: int
) -> torch.Tensor:
    """Relabel clusters by ascending member-mean grad_gini (empty clusters
    last; a stable sort, as ``jnp.argsort``). (..., F) -> int32 (..., F)."""
    resp = torch.nn.functional.one_hot(assignments.long(), num_clusters).float()
    counts = resp.sum(-2)
    means = (resp * grad_gini[..., None]).sum(-2) / counts.clamp(min=1.0)
    means = torch.where(counts > 0, means, torch.full_like(means, float("inf")))
    order = torch.argsort(means, dim=-1, stable=True)  # order[i]: i-th smallest
    ranks = torch.arange(num_clusters, device=order.device).expand_as(order)
    mapping = torch.empty_like(order).scatter_(-1, order, ranks)
    return torch.gather(mapping, -1, assignments.long()).to(torch.int32)


def layer_update(
    stats5: torch.Tensor,
    generator: Optional[torch.Generator],
    brain: BrainConfig,
    forde_lite: bool,
    init_means: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cluster + canonicalise + smooth (F, 5) or (L, F, 5) stats into int32
    (…, F) assignments. ``init_means`` seeds the GMM (see ops/gmm.py)."""
    f = stats5.shape[-2]
    if forde_lite:
        assignments = forde_lite_assignments(stats5, brain)
        info = {}
    else:
        raw, params = cluster_neurons_gmm(
            stats5, brain.num_clusters, generator,
            num_iters=brain.gmm_iterations, kmeans_iters=brain.gmm_kmeans_iterations,
            init_means=init_means,
        )
        assignments = canonicalize_labels(raw, stats5[..., 0], brain.num_clusters)
        info = {"gmm_weights": params["weights"]}
    gh, gw = near_square_grid(f)
    lead = stats5.shape[:-2]
    smoothed = smooth_assignments(
        assignments.reshape(*lead, gh, gw),
        kernel_size=brain.smoothing_kernel_size,
        num_clusters=brain.num_clusters,
    ).reshape(*lead, f).to(torch.int32)
    return smoothed, {"smoothing_changes": (smoothed != assignments).sum(-1), **info}


@torch.no_grad()
def neuron_slow_loop_step(
    model: torch.nn.Module,
    grad_stats: Dict[str, torch.Tensor],
    grad_step_count: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    brain: BrainConfig = BrainConfig(),
    forde_lite: bool = False,
) -> Dict[str, Any]:
    """One brain update over every StatefulLayer of ``model`` (built with
    sensing), in place: new ``neuron_assignments``, and ``act_stats``,
    ``step_count``, ``grad_stats`` and ``grad_step_count`` reset to 0.

    Returns the diagnostics {"layers": {name: {"assignments", "stats",
    "smoothing_changes", "gmm_weights" (GMM only)}}, "skipped": 0-d bool,
    true when no layer had sensed a step}, as tensors on the device.
    """
    layers = stateful_layers(model)
    grad_steps = torch.clamp(grad_step_count, min=1).float()
    by_width: Dict[int, list] = {}
    for name, layer in layers.items():
        by_width.setdefault(layer.neuron_assignments.shape[0], []).append(name)

    diagnostics: Dict[str, Any] = {"layers": {}}
    any_active = torch.zeros((), dtype=torch.bool, device=grad_step_count.device)
    for names in by_width.values():
        stats5 = torch.stack([
            torch.cat([
                grad_stats[n] / grad_steps,
                layers[n].act_stats / torch.clamp(layers[n].step_count, min=1).float(),
            ], dim=-1)
            for n in names
        ])
        new, info = layer_update(stats5, generator, brain, forde_lite)
        for i, n in enumerate(names):
            layer = layers[n]
            active = layer.step_count > 0
            any_active |= active
            layer.neuron_assignments.copy_(torch.where(active, new[i], layer.neuron_assignments))
            diagnostics["layers"][n] = {
                "assignments": layer.neuron_assignments.clone(),
                "stats": stats5[i],
                **{k: v[i] for k, v in info.items()},
            }

    diagnostics["skipped"] = ~any_active
    for n, layer in layers.items():
        layer.act_stats.zero_()
        layer.step_count.zero_()
        grad_stats[n].zero_()
    grad_step_count.zero_()
    return diagnostics
