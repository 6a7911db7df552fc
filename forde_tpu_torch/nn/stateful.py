"""StatefulLayer (port of forde_tpu/nn/stateful.py).

Dense -> neuron multiplex (relu / tanh / binary step by the per-neuron
``neuron_assignments`` buffer, plus the gated residual) -> Dense. The
buffer is the "brain map" the slow loop rewrites; it is int32, shape (F,).

Built with ``sense=True`` the layer also holds the fast loop's state: the
buffers ``act_stats`` ((F, 3) fp32 sums of [act_gini, act_gdp, act_var])
and ``step_count`` (int32), and the gradient tap slot ``z_tap``. Sensing
is chosen per call (``forward(x, sense=True)``), so the sensed and the
unsensed training steps run one module and one state, and an unsensed
call leaves the buffers as they are. A sensed call adds the statistics of
its pre-activations z to the buffers and, when a training step has set
``z_tap`` (an (F, 2) fp32 zeros leaf with ``requires_grad=True``), routes z
through ``grad_stat_tap``, so that ``z_tap.grad`` holds [grad_gini,
grad_gdp] of dL/dz after the backward.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from forde_tpu_torch.nn.layers import Dense
from forde_tpu_torch.ops import stat_sums
from forde_tpu_torch.ops.stateful import grad_stat_tap, stateful_multiplex

GRAD_TAP_NAME = "z_tap"


def activation_stats(z: torch.Tensor) -> torch.Tensor:
    """Per-neuron [act_gini, act_gdp, act_var] (F, 3) fp32 of z (..., F),
    from one ``moment_sums`` pass over the detached z."""
    n = z.numel() // z.shape[-1]
    l1, sumsq, sm = stat_sums.moment_sums(z.detach())
    mean = sm / n
    l2 = torch.sqrt(sumsq)
    safe_l2 = torch.where(l2 == 0, torch.ones_like(l2), l2)
    denom = (float(n) ** 0.5 - 1.0) if n > 1 else 1.0
    gini = torch.where(
        l2 == 0, torch.zeros_like(l2), (float(n) ** 0.5 - l1 / safe_l2) / denom
    )
    var = torch.clamp(sumsq / n - mean ** 2, min=0.0)
    return torch.stack([gini, l1 / n, var], dim=-1)


class StatefulLayer(torch.nn.Module):
    def __init__(
        self,
        hidden_dim: int,
        d_model: int,
        specialist_gate: float = 0.1,
        dtype: torch.dtype = torch.float32,
        sense: bool = False,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.specialist_gate = specialist_gate
        self.dtype = dtype
        self.sense = sense
        self.w_in = Dense(d_model, hidden_dim, dtype=dtype, param_dtype=param_dtype, device=device)
        self.w_out = Dense(hidden_dim, d_model, dtype=dtype, param_dtype=param_dtype, device=device)
        self.register_buffer(
            "neuron_assignments",
            torch.zeros(hidden_dim, dtype=torch.int32, device=device),
        )
        self.z_tap: Optional[torch.Tensor] = None
        if sense:
            self.register_buffer(
                "act_stats", torch.zeros(hidden_dim, 3, dtype=torch.float32, device=device)
            )
            self.register_buffer(
                "step_count", torch.zeros((), dtype=torch.int32, device=device)
            )

    def forward(self, x: torch.Tensor, sense: bool = False) -> torch.Tensor:
        z = self.w_in(x)
        if sense:
            if not self.sense:
                raise ValueError("sense=True needs a StatefulLayer built with sense=True")
            if self.z_tap is not None:
                z = grad_stat_tap(z, self.z_tap)
            self.act_stats.add_(activation_stats(z))
            self.step_count.add_(1)
        y = stateful_multiplex(z, self.neuron_assignments, self.specialist_gate)
        return self.w_out(y.to(self.dtype))


def stateful_layers(model: torch.nn.Module) -> Dict[str, StatefulLayer]:
    """Every StatefulLayer of ``model`` by module name, in name order."""
    return dict(sorted(
        (name, m) for name, m in model.named_modules() if isinstance(m, StatefulLayer)
    ))
