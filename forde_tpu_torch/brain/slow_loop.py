"""The MoE slow loop ("brain update") of the decoder LM: Sense -> Cluster
-> Smooth -> Analyze -> Actuate -> Reset (port of
forde_tpu/brain/slow_loop.py).

  1. SENSE   — each MoE layer's ``expert_usage`` sums over ``step_count``
               training steps: the (L, E) mean router probability.
  2. CLUSTER — a GMM over the experts' [usage mean, usage variance]
               across layers (E, 2).
  3. SMOOTH  — a mode filter over a (1, gh, gw) grid of the experts.
  4. ANALYZE — load imbalance and relative routing entropy.
  5. ACTUATE — nudge every router bias toward balance (specialists
               damped); scaled to 0 when no step was sensed, as the JAX
               package masks instead of returning early.
  6. RESET   — zero the MoE layers' buffers.

The update runs on the model's device, in place, with no host
synchronisation unless ``verbose`` prints the report.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from forde_tpu_torch.brain.actuation import (
    apply_router_adjustments,
    compute_router_adjustments,
    reset_stats_buffer,
)
from forde_tpu_torch.brain.clustering import cluster_experts
from forde_tpu_torch.brain.smoothing import near_square_grid, smooth_assignments_3d
from forde_tpu_torch.core.config import BrainConfig


def collect_moe_stats(
    model: torch.nn.Module, num_layers: int, num_experts: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((L, E) fp32 usage sums, 0-d int32 step count: the largest of the
    layers') from the decoder's MoE layers; a layer without MoE reads 0.
    Under GPipe stages (parallel/pipeline.py) each stage holds its own
    layers' rows, summed over the pipe axis."""
    from forde_tpu_torch.core.mesh import AXIS_PIPE

    device = next(model.parameters()).device
    usage = torch.zeros(num_layers, num_experts, dtype=torch.float32, device=device)
    step_count = torch.zeros((), dtype=torch.int32, device=device)
    for i, block in enumerate(model.layers):
        moe = getattr(block, "moe", None)
        if moe is not None:
            usage[i] = moe.expert_usage.float()
            step_count = torch.maximum(step_count, moe.step_count.to(torch.int32))
    mesh = getattr(model, "mesh", None)
    if mesh is not None and mesh.shape[AXIS_PIPE] > 1:
        usage = mesh.group(AXIS_PIPE).all_reduce(usage)
    return usage, step_count


@torch.no_grad()
def moe_slow_loop_step(
    model: torch.nn.Module,
    config: Any,
    generator: Optional[torch.Generator] = None,
    epoch: int = 0,
    step: int = 0,
    brain: BrainConfig = BrainConfig(),
    verbose: bool = False,
    init_means: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One brain update of the decoder LM ``model``, in place: its router
    biases nudged and its MoE buffers reset. ``init_means`` (K, 2) seeds
    the GMM instead of k-means++ from ``generator`` (see ops/gmm.py).
    Returns the JAX package's diagnostics dict, as tensors on the device;
    ``verbose`` prints its report."""
    num_experts = config.num_experts
    usage_sum, step_count = collect_moe_stats(model, config.num_layers, num_experts)
    active = step_count > 0
    expert_usage = usage_sum / torch.clamp(step_count, min=1).float()

    usage_mean = expert_usage.mean(0)
    usage_var = expert_usage.var(0, unbiased=False)
    cluster_features = torch.stack([usage_mean, usage_var], dim=-1)
    assignments, gmm_params = cluster_experts(
        cluster_features, brain.num_clusters, generator, init_means=init_means
    )

    gh, gw = near_square_grid(num_experts)
    smoothed = smooth_assignments_3d(
        assignments.reshape(1, gh, gw), kernel_size=brain.smoothing_kernel_size,
        num_clusters=brain.num_clusters,
    ).reshape(-1).to(torch.int32)
    smoothing_changes = (assignments != smoothed).sum()
    assignments = smoothed

    eps = 1e-8
    load_imbalance = (usage_mean - 1.0 / num_experts).abs().mean()
    routing_entropy = -(usage_mean * torch.log(usage_mean + eps)).sum()
    relative_entropy = routing_entropy / math.log(float(num_experts))

    adjustments = compute_router_adjustments(
        assignments, usage_mean, target_balance=brain.target_balance,
        max_adjustment=brain.max_adjustment, specialist_damping=brain.specialist_damping,
    ) * active.float()
    updates_count = apply_router_adjustments(model, adjustments)
    reset_stats_buffer(model)

    diagnostics = {
        "skipped": ~active,
        "expert_usage": usage_mean,
        "assignments": assignments,
        "load_imbalance": load_imbalance,
        "routing_entropy": relative_entropy,
        "adjustments": adjustments,
        "step_count": step_count,
        "smoothing_changes": smoothing_changes,
        "gmm_weights": gmm_params["weights"],
        "updates_count": torch.tensor(updates_count),
        "cluster_features": cluster_features,
    }
    if verbose:
        _print_report({k: v.cpu() for k, v in diagnostics.items()}, epoch, step)
    return diagnostics


def _print_report(diag: Dict[str, torch.Tensor], epoch: int, step: int) -> None:
    print(f"\n{'=' * 50}")
    print(f"MoE Slow Loop - Epoch {epoch}, Step {step}")
    print(f"{'=' * 50}")
    if bool(diag["skipped"]):
        print("No stats accumulated yet; update was a no-op.")
        return
    print(f"Steps accumulated: {int(diag['step_count'])}")
    print(f"Expert usage: {diag['expert_usage'].numpy()}")
    roles = {0: "Generalist", 1: "Specialist", 2: "Under-utilized"}
    assignments = diag["assignments"]
    for c in sorted(set(int(a) for a in assignments)):
        count = int((assignments == c).sum())
        print(f"Cluster {c} ({roles.get(c, 'Unknown')}): {count} experts")
    print(f"Smoothing changed {int(diag['smoothing_changes'])} assignments")
    print(f"Mean load imbalance: {float(diag['load_imbalance']):.4f}")
    print(f"Routing entropy (relative): {float(diag['routing_entropy']):.4f}")
    print(f"Router adjustments: {diag['adjustments'].numpy()}")
    print(f"Applied updates to {int(diag['updates_count'])} router biases")
    print(f"{'=' * 50}\n", flush=True)
