"""StatefulLayer multiplex op and gradient-stat tap (port of
forde_tpu/ops/stateful.py).

    F(z) = relu(z)         where assignment == 0  (Generalist)
           tanh(z)         where assignment == 1  (Pooling)
           binary_step(z)  where assignment == 2  (Specialist)
    out  = F(z) + gate * z,   gate = specialist_gate for specialists else 1

Its gradient is the JAX package's straight-through rule, computed in z's
dtype:

    d out / d z = 1[z > 0]          (gen)
                  1 - tanh(z)^2     (pool)
                  1                 (spec, straight-through)
                + gate

Plain PyTorch in the input dtype, as in the JAX package, which has no
kernel for it (its two Pallas versions measured slower than XLA's fusion
into the matmuls).

``grad_stat_tap`` is the identity on z whose (F, 2) ``slot`` receives, as
its gradient, the per-neuron [grad_gini, grad_gdp] of dL/dz: the stats of
the backward pass come out of the same backward, from ``moment_sums`` of
the cotangent.
"""

from __future__ import annotations

import torch

from forde_tpu_torch.ops import stat_sums

GENERALIST, POOLING, SPECIALIST = 0, 1, 2


def _gate(a: torch.Tensor, specialist_gate: float, dt: torch.dtype) -> torch.Tensor:
    # Filled on the device (no host-to-device copy, which a CUDA graph
    # cannot capture); the gate is rounded to dt as before.
    gate = torch.full(a.shape, specialist_gate, dtype=dt, device=a.device)
    return torch.where(a == SPECIALIST, gate, 1.0)


class _Multiplex(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, a, specialist_gate):
        ctx.save_for_backward(z, a)
        ctx.specialist_gate = specialist_gate
        dt = z.dtype
        fz = torch.where(
            a == GENERALIST,
            torch.relu(z),
            torch.where(a == POOLING, torch.tanh(z), (z > 0).to(dt)),
        )
        return fz + _gate(a, specialist_gate, dt) * z

    @staticmethod
    def backward(ctx, g):
        z, a = ctx.saved_tensors
        dt = z.dtype
        one = torch.ones((), dtype=dt, device=z.device)
        dfdz = torch.where(
            a == GENERALIST,
            (z > 0).to(dt),
            torch.where(a == POOLING, one - torch.tanh(z) ** 2, one),
        )
        dz = g.to(dt) * (dfdz + _gate(a, ctx.specialist_gate, dt))
        return dz, None, None


def stateful_multiplex(
    z: torch.Tensor, assignments: torch.Tensor, specialist_gate: float = 0.1
) -> torch.Tensor:
    """Apply the FORDE neuron multiplex to (..., F) pre-activations.

    ``assignments``: int (F,) neuron types (0 gen / 1 pool / 2 spec).
    """
    return _Multiplex.apply(z, assignments.to(torch.int32), float(specialist_gate))


def grad_stats_from_cotangent(g: torch.Tensor, group=None) -> torch.Tensor:
    """Per-neuron [grad_gini (Hoyer), grad_gdp (mean |g|)] (F, 2) fp32 of
    dL/dz (..., F), from one ``moment_sums`` pass over g (summed over
    ``group``, the data axis, under data parallelism)."""
    n = g.numel() // g.shape[-1]
    l1, sumsq, _ = stat_sums.global_moment_sums(g, group)
    n *= 1 if group is None else group.size
    l2 = torch.sqrt(sumsq)
    safe_l2 = torch.where(l2 == 0, torch.ones_like(l2), l2)
    denom = (float(n) ** 0.5 - 1.0) if n > 1 else 1.0
    gini = torch.where(
        l2 == 0, torch.zeros_like(l2), (float(n) ** 0.5 - l1 / safe_l2) / denom
    )
    return torch.stack([gini, l1 / n], dim=-1)


class _GradStatTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, slot, group):
        ctx.group = group
        return z.view_as(z)

    @staticmethod
    def backward(ctx, g):
        return g, grad_stats_from_cotangent(g, ctx.group), None


def grad_stat_tap(z: torch.Tensor, slot: torch.Tensor, group=None) -> torch.Tensor:
    """Identity on ``z``; the gradient of ``slot`` (an (F, 2) fp32 zeros
    leaf with ``requires_grad=True``) comes back as the per-neuron
    [grad_gini, grad_gdp] of dL/dz. No (B, S, F) copy of dL/dz is kept."""
    return _GradStatTap.apply(z, slot, group)
