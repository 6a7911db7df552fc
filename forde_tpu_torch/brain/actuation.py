"""Actuation of the MoE slow loop: router-bias nudges and the reset of
the sensing buffers (port of forde_tpu/brain/actuation.py). The JAX
package rewrites the parameter and ``stats_buffer`` trees; here the
model's router biases and MoE buffers change in place."""

from __future__ import annotations

import torch

from forde_tpu_torch.nn.moe import MoEStatefulLayer


def compute_router_adjustments(
    expert_assignments: torch.Tensor,
    expert_usage: torch.Tensor,
    target_balance: float = 0.1,
    max_adjustment: float = 0.1,
    specialist_damping: float = 0.5,
) -> torch.Tensor:
    """Router bias nudges (E,): under-used experts up, over-used down,
    clipped to +-max_adjustment, damped for the specialist cluster (1)."""
    deviation = expert_usage - 1.0 / expert_usage.shape[0]
    adjustments = torch.clamp(-deviation * target_balance, -max_adjustment, max_adjustment)
    return torch.where(expert_assignments == 1, adjustments * specialist_damping, adjustments)


@torch.no_grad()
def apply_router_adjustments(model: torch.nn.Module, adjustments: torch.Tensor) -> int:
    """Add ``adjustments`` to every router bias of its shape (the
    parameters named ``...router_linear.bias``), in place. Returns the
    number of biases updated."""
    count = 0
    for name, param in model.named_parameters():
        if "router_linear" in name and name.endswith("bias") and param.shape == adjustments.shape:
            param.add_(adjustments.to(param.dtype))
            count += 1
    return count


@torch.no_grad()
def reset_stats_buffer(model: torch.nn.Module) -> None:
    """Zero every MoE layer's ``expert_usage`` and ``step_count``."""
    for module in model.modules():
        if isinstance(module, MoEStatefulLayer):
            module.expert_usage.zero_()
            module.step_count.zero_()
