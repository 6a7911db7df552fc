"""Manifold-constrained hyper-connections: multi-stream residuals (port
of forde_tpu/nn/hyper_connections.py).

The streams of a (B, S, D) activation are a (B, S, N, D) tensor: stream 0
is the residual path, the rest learned projections. Each sublayer mixes
the streams with a doubly-stochastic matrix (Sinkhorn-Knopp of learned
logits), adds its output into stream 0 and reads stream 0 back out.
"""

from __future__ import annotations

from typing import Tuple

import torch

from forde_tpu_torch.nn.layers import Dense
from forde_tpu_torch.ops.sinkhorn import sinkhorn_knopp_exp


class HyperConnectionStream(torch.nn.Module):
    """(B, S, D) -> (B, S, num_streams, D): the input, then one fused Dense
    to the (num_streams - 1) other streams."""

    def __init__(self, num_streams: int, d_model: int, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.num_streams = num_streams
        if num_streams > 1:
            self.stream_init = Dense(
                d_model, (num_streams - 1) * d_model, dtype=dtype,
                param_dtype=param_dtype, device=device,
            )

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        if self.num_streams > 1:
            self.stream_init.weight.normal_(0.0, 0.02, generator=generator)
            self.stream_init.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        if self.num_streams == 1:
            return x[:, :, None, :]
        projected = self.stream_init(x).reshape(b, s, self.num_streams - 1, d)
        return torch.cat([x[:, :, None, :], projected], dim=2)


class ManifoldHyperConnection(torch.nn.Module):
    """Mix the streams with ``sinkhorn_knopp_exp(mixing_logits)`` (cast to
    the streams' dtype), add the sublayer output into one stream and read
    that stream back out."""

    def __init__(self, num_streams: int, sinkhorn_iterations: int = 5,
                 temperature: float = 1.0, param_dtype=torch.float32, device=None):
        super().__init__()
        self.sinkhorn_iterations = sinkhorn_iterations
        self.temperature = temperature
        self.mixing_logits = torch.nn.Parameter(
            torch.zeros(num_streams, num_streams, dtype=param_dtype, device=device)
        )

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.mixing_logits.normal_(0.0, 0.1, generator=generator)

    def forward(
        self, streams: torch.Tensor, sublayer_output: torch.Tensor,
        output_stream_idx: int = 0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        mixing = sinkhorn_knopp_exp(
            self.mixing_logits, self.sinkhorn_iterations, self.temperature
        ).to(streams.dtype)
        mixed = torch.einsum("ij,bsjd->bsid", mixing, streams)
        mixed[:, :, output_stream_idx, :] += sublayer_output.to(mixed.dtype)
        return mixed, mixed[:, :, output_stream_idx, :]


class StreamCollapser(torch.nn.Module):
    """(B, S, N, D) -> (B, S, D) by ``collapse_method``: "weighted_sum"
    (softmax of learned weights, cast to the streams' dtype), "first", or
    "concat" (a Dense of the concatenated streams)."""

    def __init__(self, d_model: int, num_streams: int, collapse_method: str = "weighted_sum",
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.collapse_method = collapse_method
        if collapse_method == "weighted_sum":
            self.stream_weights = torch.nn.Parameter(
                torch.ones(num_streams, dtype=param_dtype, device=device)
            )
        elif collapse_method == "concat":
            self.collapse_proj = Dense(
                num_streams * d_model, d_model, dtype=dtype, param_dtype=param_dtype,
                device=device,
            )
        elif collapse_method != "first":
            raise ValueError(f"unknown collapse_method {collapse_method!r}")

    def forward(self, streams: torch.Tensor) -> torch.Tensor:
        b, s, n, d = streams.shape
        if self.collapse_method == "first":
            return streams[:, :, 0, :]
        if self.collapse_method == "concat":
            return self.collapse_proj(streams.reshape(b, s, n * d))
        weights = torch.softmax(self.stream_weights.float(), dim=0).to(streams.dtype)
        return torch.einsum("bsnd,n->bsd", streams, weights)
