"""Mixture-of-Experts layers with a stacked expert bank (port of
forde_tpu/nn/moe.py).

The experts are one (E, d, h) and one (E, h, d) parameter, so the whole
bank runs as two batched products: over every token ("dense" dispatch,
the reference's math) or over per-expert buffers of ``capacity`` tokens
("capacity" dispatch, capacity = max(int(factor * T * k / E), k)).
``MoEStatefulLayer`` adds the FORDE sensing buffers ``expert_usage`` (the
summed mean router probability of each expert) and ``step_count``, which
the MoE slow loop reads.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.nn.layers import Dense
from forde_tpu_torch.ops import moe_dispatch


DISPATCHES = ("dense", "capacity")


def _dispatch_check(dispatch: str) -> None:
    if dispatch == "ep":
        raise NotImplementedError(
            "moe_dispatch='ep' (expert parallelism over a device mesh) is not "
            "ported to forde_tpu_torch yet (it waits for the multi-device "
            "slice; see ROADMAP.md)"
        )
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {dispatch!r}")


class ExpertsFFN(torch.nn.Module):
    """The expert bank: (E, d, h) up, tanh-approximated gelu, (E, h, d)
    down, each expert a Dense -> gelu -> Dense."""

    def __init__(self, num_experts: int, hidden_dim: int, d_model: int,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        e, d, h = num_experts, d_model, hidden_dim
        kw = dict(dtype=param_dtype, device=device)
        self.w_up = torch.nn.Parameter(torch.zeros(e, d, h, **kw))
        self.w_down = torch.nn.Parameter(torch.zeros(e, h, d, **kw))
        self.b_up = torch.nn.Parameter(torch.zeros(e, h, **kw))
        self.b_down = torch.nn.Parameter(torch.zeros(e, d, **kw))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Each expert's weights ~ N(0, 1/fan_in), biases 0."""
        for w in (self.w_up, self.w_down):
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
        self.b_up.zero_()
        self.b_down.zero_()

    def all_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Every expert on every token: x (B, S, D) -> (E, B, S, D)."""
        dt = self.dtype
        h = torch.einsum("bsd,edh->ebsh", x.to(dt), self.w_up.to(dt))
        h = F.gelu(h + self.b_up.to(dt)[:, None, None, :], approximate="tanh")
        out = torch.einsum("ebsh,ehd->ebsd", h, self.w_down.to(dt))
        return out + self.b_down.to(dt)[:, None, None, :]

    def dispatched(self, expert_inputs: torch.Tensor) -> torch.Tensor:
        """Each expert on its own buffer: (E, C, D) -> (E, C, D)."""
        dt = self.dtype
        h = torch.einsum("ecd,edh->ech", expert_inputs.to(dt), self.w_up.to(dt))
        h = F.gelu(h + self.b_up.to(dt)[:, None, :], approximate="tanh")
        out = torch.einsum("ech,ehd->ecd", h, self.w_down.to(dt))
        return out + self.b_down.to(dt)[:, None, :]


class MoERouter(torch.nn.Module):
    """The linear router."""

    def __init__(self, d_model: int, num_experts: int, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.router_linear = Dense(d_model, num_experts, dtype=dtype,
                                   param_dtype=param_dtype, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.router_linear.weight.normal_(0.0, 0.02, generator=generator)
        self.router_linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.router_linear(x)


class MoELayer(torch.nn.Module):
    """Top-k routed MoE FFN; returns (output, aux_loss, router_probs).
    The router's softmax and top-k run in fp32."""

    def __init__(self, num_experts: int = 8, top_k: int = 2, expert_hidden_dim: int = 2048,
                 d_model: int = 512, aux_loss_weight: float = 0.01, dispatch: str = "dense",
                 capacity_factor: float = 2.0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        _dispatch_check(dispatch)
        self.num_experts = num_experts
        self.top_k = top_k
        self.aux_loss_weight = aux_loss_weight
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.router = MoERouter(d_model, num_experts, **kw)
        self.experts = ExpertsFFN(num_experts, expert_hidden_dim, d_model, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        router_logits = self.router(x).float()
        router_probs = torch.softmax(router_logits, dim=-1)
        top_k_indices, top_k_probs = moe_dispatch.top_k_gating(router_logits, self.top_k)
        if self.dispatch == "dense":
            all_out = self.experts.all_tokens(x)  # (E, B, S, D)
            combine = moe_dispatch.combine_matrix(top_k_indices, top_k_probs, self.num_experts)
            output = moe_dispatch.dense_combine(all_out, combine)
        else:
            b, s, d = x.shape
            t, k = b * s, self.top_k
            capacity = max(int(self.capacity_factor * t * k / self.num_experts), k)
            plan = moe_dispatch.capacity_route(
                top_k_indices.reshape(t, k), top_k_probs.reshape(t, k), self.num_experts,
                capacity,
            )
            expert_out = self.experts.dispatched(moe_dispatch.capacity_gather(x.reshape(t, d), plan))
            output = moe_dispatch.capacity_combine(expert_out, plan).reshape(b, s, d)
        aux_loss = moe_dispatch.load_balancing_loss(
            router_probs, top_k_indices, self.num_experts
        ) * self.aux_loss_weight
        return output.to(x.dtype), aux_loss, router_probs


class MoEStatefulLayer(torch.nn.Module):
    """``MoELayer`` plus the sensing buffers ``expert_usage`` (E,) fp32 and
    ``step_count`` int32. ``forward(x, update_stats)``: with
    ``update_stats`` the buffers gain this call's mean router probability
    and one step, in place (the JAX package's mutable ``stats_buffer``);
    serving leaves them as loaded."""

    def __init__(self, num_experts: int = 8, top_k: int = 2, expert_hidden_dim: int = 2048,
                 d_model: int = 512, aux_loss_weight: float = 0.01, dispatch: str = "dense",
                 capacity_factor: float = 2.0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.moe_layer = MoELayer(
            num_experts, top_k, expert_hidden_dim, d_model, aux_loss_weight, dispatch,
            capacity_factor, dtype=dtype, param_dtype=param_dtype, device=device,
        )
        self.register_buffer(
            "expert_usage", torch.zeros(num_experts, dtype=torch.float32, device=device)
        )
        self.register_buffer("step_count", torch.zeros((), dtype=torch.int32, device=device))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        output, aux_loss, router_probs = self.moe_layer(x)
        if update_stats:
            with torch.no_grad():
                self.expert_usage += router_probs.mean(dim=(0, 1)).float()
                self.step_count += 1
        return output, aux_loss
