"""Dense and LayerNorm with the arithmetic of ``flax.linen``.

Parameters are stored in the parameter dtype (fp32); the computation runs
in the compute dtype, as Flax does:

* ``Dense`` casts the input, the weight and the bias to the compute dtype
  before the product. Its weight is (out, in), the transpose of Flax's
  ``kernel``.
* ``LayerNorm`` uses epsilon 1e-6 (torch's default is 1e-5), computes in
  fp32 and casts the result to the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class Dense(torch.nn.Linear):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__(
            in_features, out_features, bias=bias, device=device, dtype=param_dtype
        )
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Flax's default: weight ~ N(0, 1/fan_in), bias 0."""
        self.weight.normal_(0.0, self.in_features ** -0.5, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class LayerNorm(torch.nn.LayerNorm):
    def __init__(
        self,
        features: int,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__(features, eps=1e-6, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        )
        return y.to(self.compute_dtype)
