"""StatefulLayer multiplex op, forward (port of forde_tpu/ops/stateful.py).

    F(z) = relu(z)         where assignment == 0  (Generalist)
           tanh(z)         where assignment == 1  (Pooling)
           binary_step(z)  where assignment == 2  (Specialist)
    out  = F(z) + gate * z,   gate = specialist_gate for specialists else 1

Plain PyTorch in the input dtype, as in the JAX package, which has no
kernel for it (its two Pallas versions measured slower than XLA's fusion
into the matmuls). The straight-through backward and the gradient-stat
tap come with the training path.
"""

from __future__ import annotations

import torch

GENERALIST, POOLING, SPECIALIST = 0, 1, 2


def stateful_multiplex(
    z: torch.Tensor, assignments: torch.Tensor, specialist_gate: float = 0.1
) -> torch.Tensor:
    """Apply the FORDE neuron multiplex to (..., F) pre-activations.

    ``assignments``: int (F,) neuron types (0 gen / 1 pool / 2 spec).
    """
    dt = z.dtype
    a = assignments.to(torch.int32)
    fz = torch.where(
        a == GENERALIST,
        torch.relu(z),
        torch.where(a == POOLING, torch.tanh(z), (z > 0).to(dt)),
    )
    gate = torch.where(
        a == SPECIALIST,
        torch.tensor(specialist_gate, dtype=dt, device=z.device),
        torch.tensor(1.0, dtype=dt, device=z.device),
    )
    return fz + gate * z
