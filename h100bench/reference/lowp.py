"""Operand rounding of the reference's products.

``rnd(x, precision)`` returns ``x`` itself in fp32 (None), or ``x`` as it
reads after a cast to TF32 (the tensor cores' 10-bit mantissa, as a
float32 product with TF32 on reads its operands) or to fp8 e4m3 with one
scale per tensor (the largest magnitude onto e4m3's 448, as fp8 training
scales a tensor); ``out`` rounds an fp8 product's result to bf16. The
rounding passes gradients straight through, so a training step of the
control differentiates the same function as the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

E4M3_MAX = 448.0
# the control of a configuration: the next precision below the one it states
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def rnd(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """A product's operand as the precision's products read it."""
    if precision is None or x.numel() == 0:
        return x
    raw = x.detach()
    if precision == "tf32":  # 10 bits of mantissa, rounded to nearest
        low = ((raw.float().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    elif precision == "fp8":
        scale = E4M3_MAX / raw.abs().amax().clamp(min=1e-30)
        low = (raw * scale).to(torch.float8_e4m3fn).float() / scale
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return x + (low - raw) if x.requires_grad else low


def out(y: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """A product's result as the precision's products give it: bf16 for
    fp8 products (as fp8 GEMMs write them), else unrounded."""
    if precision != "fp8":
        return y
    low = y.detach().to(torch.bfloat16).float()
    return y + (low - y.detach()) if y.requires_grad else low
