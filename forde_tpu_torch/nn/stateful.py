"""StatefulLayer, serving path (port of forde_tpu/nn/stateful.py).

Dense -> neuron multiplex (relu / tanh / binary step by the per-neuron
``neuron_assignments`` buffer, plus the gated residual) -> Dense. The
buffer is the "brain map" the slow loop rewrites; it is int32, shape (F,).

Only ``sense=False`` is ported: the activation statistics and the
gradient tap of the fast loop come with the training path.
"""

from __future__ import annotations

import torch

from forde_tpu_torch.nn.layers import Dense
from forde_tpu_torch.ops.stateful import stateful_multiplex


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
        if sense:
            raise NotImplementedError(
                "StatefulLayer(sense=True) (activation stats, gradient tap) "
                "comes with the training path; serving runs sense=False"
            )
        self.specialist_gate = specialist_gate
        self.dtype = dtype
        self.w_in = Dense(d_model, hidden_dim, dtype=dtype, param_dtype=param_dtype, device=device)
        self.w_out = Dense(hidden_dim, d_model, dtype=dtype, param_dtype=param_dtype, device=device)
        self.register_buffer(
            "neuron_assignments",
            torch.zeros(hidden_dim, dtype=torch.int32, device=device),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.w_in(x)
        y = stateful_multiplex(z, self.neuron_assignments, self.specialist_gate)
        return self.w_out(y.to(self.dtype))
