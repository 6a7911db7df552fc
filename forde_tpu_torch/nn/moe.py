"""Mixture-of-Experts layers with a stacked expert bank (port of
forde_tpu/nn/moe.py).

The experts are one (E, d, h) and one (E, h, d) parameter, so the whole
bank runs as two batched products: over every token ("dense" dispatch,
the reference's math) or over per-expert buffers of ``capacity`` tokens
("capacity" dispatch, capacity = max(int(factor * T * k / E), k)).
``MoEStatefulLayer`` adds the FORDE sensing buffers ``expert_usage`` (the
summed mean router probability of each expert) and ``step_count``, which
the MoE slow loop reads. With ``quantized`` (int8 serving, ops/quant.py)
the bank holds int8 weights with per-(expert, output channel) scales and
both products run int8 over dynamically quantized activations, one
``int8_matmul`` per expert.

Dense dispatch weights each token's experts by a combine matrix that is
exactly 0 for the E - k experts it did not pick, so a whole bank (no
expert or model axis), not quantized, outside a CUDA graph's capture, runs
it over the routed rows only once the mean rows an expert, T*k/E, reach
``ROUTED_MIN_ROWS`` (``ExpertsFFN.routed``): the T*k choices sorted by
expert, each expert's two products on its own contiguous group, the
outputs summed back per token. That is dense dispatch's result in the
same dtype, with no capacity and no drops; only the order of the fp32
sums differs, and the experts a token did not pick get no gradient from
it in either. It costs a host read of the group sizes a call and ~8x the
bank's launches, so below the constant (short prefills) and in a graph's
capture (the pooled decode) ``all_tokens`` runs. The counters
``moe.routed`` and ``moe.dense`` (``obs/spans.py``) count the calls of
each.

``ROUTED_MIN_ROWS`` was measured on one H100 80GB HBM3 at 700 W (fp32,
TF32 off, 8 experts top-2, d 512, h 2,048). Routed / dense ms a call of
one MoE layer, "loop" back to back (the card's pace) and "single"
between two synchronisations (a host-bound caller), and of one whole
``nsa_prefill`` of a one-row prompt of the fp32 LM:

    T       rows/expert  fwd loop      fwd single    fwd+bwd loop   fwd+bwd single  prefill
    512       128        1.41 / 0.61   1.35 / 0.73    3.66 / 2.51    4.16 / 2.59    65.5 / 56.1
    1,024     256        1.39 / 0.95   1.41 / 1.12    3.26 / 2.67    3.99 / 3.19    64.1 / 54.6
    1,536     384        1.24 / 1.47   1.35 / 1.67    4.17 / 3.94    3.93 / 4.33    51.0 / 49.6
    2,048     512        1.35 / 1.78   1.43 / 1.97    3.61 / 5.01    3.17 / 5.45    51.6 / 48.8
    4,096   1,024        1.71 / 3.39   1.95 / 3.52    4.33 / 10.14   4.61 / 10.58   -
    16,384  4,096        4.19 / 13.18  4.30 / 13.75  11.74 / 39.29  11.86 / 39.94   -

A routed forward costs ~1.2-1.4 ms of host time at any size (its loop
times' floor), so the layer alone crosses over at 320-512 rows, but a
whole prefill, host-bound, stays faster dense up to 2,048 tokens (512
rows, the model's longest). 1,024 rows is the first size at which routed
wins every reading; the training step's 8 x 2,048 tokens give 4,096.

Given a ``mesh`` (core/mesh.py) the layer takes this rank's tokens (split
over data and context) and, with an expert axis above 1, this rank's
slice of the bank (train/state.py keeps it): ``"ep"`` dispatch runs
``parallel.expert_parallel.expert_parallel_ffn`` (all-to-all or psum), and
dense or capacity dispatch runs as the psum variant of the same dispatch
(the JAX package gets the same values from GSPMD over its expert-sharded
bank). The router's aux loss and ``expert_usage`` are the global batch's:
fractions and mean probabilities are averaged over the token axes (data,
context) before their product. A capacity plan covers this rank's tokens,
where the JAX package's pjit plan covers the global batch: without drops
(``capacity_factor >= num_experts``) the two agree.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from forde_tpu_torch.nn.layers import Dense
from forde_tpu_torch.nn.remat import recomputing
from forde_tpu_torch.obs import spans
from forde_tpu_torch.ops import moe_dispatch
from forde_tpu_torch.ops.quant import int8_matmul, quantize_activations


DISPATCHES = ("dense", "capacity", "ep")

# the mean routed rows an expert (T*k/E) from which dense dispatch runs
# routed (measured: the module's note)
ROUTED_MIN_ROWS = 1024


def _dispatch_check(dispatch: str) -> None:
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {dispatch!r}")


def _token_group(mesh):
    from forde_tpu_torch.core.mesh import AXIS_CONTEXT, AXIS_DATA

    return mesh.group(AXIS_DATA, AXIS_CONTEXT)


def global_load_balancing_loss(router_probs, top_k_indices, num_experts: int, mesh):
    """``load_balancing_loss`` of the global batch from this rank's
    tokens: routed fractions and mean probabilities averaged over the
    token axes, then their product."""
    from forde_tpu_torch.parallel.collectives import pmean

    group = _token_group(mesh)
    num_tokens = router_probs.shape[0] * router_probs.shape[1]
    top_k = top_k_indices.shape[-1]
    counts = F.one_hot(top_k_indices.reshape(-1), num_experts).sum(0)
    fraction = pmean(counts.to(torch.float32) / (num_tokens * top_k), group)
    prob = pmean(router_probs.mean(dim=(0, 1)), group)
    return num_experts * torch.sum(fraction * prob)


class ExpertsFFN(torch.nn.Module):
    """The expert bank: (E, d, h) up, tanh-approximated gelu, (E, h, d)
    down, each expert a Dense -> gelu -> Dense. ``quantized``: ``w_up_q``,
    ``w_down_q`` int8 and ``w_up_scale`` (E, h), ``w_down_scale`` (E, d)
    fp32 in place of ``w_up``, ``w_down`` (the JAX package's leaves).
    ``tp_group``: under tensor parallelism the bank holds this rank's
    slice of the hidden dim (column-split up, row-split down), and the
    partial outputs are summed over the model axis before ``b_down``."""

    def __init__(self, num_experts: int, hidden_dim: int, d_model: int,
                 dtype=torch.float32, param_dtype=torch.float32, device=None,
                 quantized: bool = False):
        super().__init__()
        self.dtype, self.quantized = dtype, quantized
        e, d, h = num_experts, d_model, hidden_dim
        kw = dict(dtype=param_dtype, device=device)
        if quantized:
            frozen = dict(requires_grad=False)
            int8 = dict(dtype=torch.int8, device=device)
            self.w_up_q = torch.nn.Parameter(torch.zeros(e, d, h, **int8), **frozen)
            self.w_up_scale = torch.nn.Parameter(torch.ones(e, h, device=device), **frozen)
            self.w_down_q = torch.nn.Parameter(torch.zeros(e, h, d, **int8), **frozen)
            self.w_down_scale = torch.nn.Parameter(torch.ones(e, d, device=device), **frozen)
            kw = dict(dtype=torch.float32, device=device)
        else:
            self.w_up = torch.nn.Parameter(torch.zeros(e, d, h, **kw))
            self.w_down = torch.nn.Parameter(torch.zeros(e, h, d, **kw))
        self.b_up = torch.nn.Parameter(torch.zeros(e, h, **kw))
        self.b_down = torch.nn.Parameter(torch.zeros(e, d, **kw))
        self.tp_group = None

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Each expert's weights ~ N(0, 1/fan_in), biases 0."""
        for w in (self.w_up, self.w_down):
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
        self.b_up.zero_()
        self.b_down.zero_()

    @staticmethod
    def _q_products(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                    group=None) -> torch.Tensor:
        """Expert e's rows of ``x`` (E, N, din) or one (N, din) for every
        expert, times ``w_q[e]`` in int8 over activations quantized per
        row: (E, N, dout) fp32 (the JAX package's ``_q_einsum``). ``group``:
        din is split over it (a row-parallel product: whole-row scales, the
        int32 sums added over the group)."""
        xq, x_scale = quantize_activations(x, group)
        acc = torch.stack([int8_matmul(xq if xq.ndim == 2 else xq[e], w_q[e])
                           for e in range(w_q.shape[0])])
        if group is not None:
            acc = group.all_reduce(acc)
        return acc.float() * x_scale * w_scale[:, None, :]

    def _quantized(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) or (E, N, D) -> (E, N, D) through the int8 bank."""
        hid = self._q_products(x, self.w_up_q, self.w_up_scale) + self.b_up[:, None, :]
        hid = F.gelu(hid, approximate="tanh")
        out = self._q_products(hid, self.w_down_q, self.w_down_scale, self.tp_group)
        return (out + self.b_down[:, None, :]).to(self.dtype)

    def _down(self, h: torch.Tensor, equation: str) -> torch.Tensor:
        out = torch.einsum(equation, h, self.w_down.to(self.dtype))
        if self.tp_group is not None:
            from forde_tpu_torch.parallel.collectives import reduce_from_model

            out = reduce_from_model(out, self.tp_group)
        return out

    def _up_input(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return x
        from forde_tpu_torch.parallel.collectives import copy_to_model

        return copy_to_model(x, self.tp_group)

    def all_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Every expert on every token: x (B, S, D) -> (E, B, S, D)."""
        if self.quantized:
            b, s, d = x.shape
            return self._quantized(x.reshape(b * s, d)).reshape(-1, b, s, d)
        dt = self.dtype
        h = torch.einsum("bsd,edh->ebsh", self._up_input(x.to(dt)), self.w_up.to(dt))
        h = F.gelu(h + self.b_up.to(dt)[:, None, None, :], approximate="tanh")
        return self._down(h, "ebsh,ehd->ebsd") + self.b_down.to(dt)[:, None, None, :]

    def routed(self, x: torch.Tensor, top_k_indices: torch.Tensor,
               top_k_probs: torch.Tensor) -> torch.Tensor:
        """Each expert on its routed tokens only: x (B, S, D) -> (B, S, D),
        each token's top-k outputs summed by ``top_k_probs`` (dense
        dispatch's result; the whole bank, neither quantized nor split)."""
        b, s, d = x.shape
        dt = self.dtype
        order = moe_dispatch.routed_order(top_k_indices, self.w_up.shape[0])
        rows = moe_dispatch.routed_rows(x.reshape(b * s, d).to(dt), order)
        w_up, b_up, w_down, b_down = (p.to(dt).unbind(0) for p in (
            self.w_up, self.b_up, self.w_down, self.b_down))
        outs = []
        # the one host read, last: the gather and the views are made before
        # the host waits, so the first product follows the wait at once
        for e, group in enumerate(rows.split(order.counts.tolist())):
            if group.shape[0]:
                h = F.gelu(torch.addmm(b_up[e], group, w_up[e]), approximate="tanh")
                outs.append(torch.addmm(b_down[e], h, w_down[e]))
        return moe_dispatch.routed_combine(torch.cat(outs), order, top_k_probs).reshape(b, s, d)

    def dispatched(self, expert_inputs: torch.Tensor) -> torch.Tensor:
        """Each expert on its own buffer: (E, C, D) -> (E, C, D)."""
        if self.quantized:
            return self._quantized(expert_inputs)
        dt = self.dtype
        h = torch.einsum("ecd,edh->ech", self._up_input(expert_inputs.to(dt)), self.w_up.to(dt))
        h = F.gelu(h + self.b_up.to(dt)[:, None, :], approximate="tanh")
        return self._down(h, "ech,ehd->ecd") + self.b_down.to(dt)[:, None, :]


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
                 param_dtype=torch.float32, device=None, quantized: bool = False,
                 mesh=None):
        super().__init__()
        _dispatch_check(dispatch)
        if dispatch == "ep" and quantized:
            raise ValueError("quantized serving supports dense/capacity dispatch (EP moves "
                             "fp tensors)")
        self.mesh = mesh
        self.num_experts = num_experts
        self.top_k = top_k
        self.aux_loss_weight = aux_loss_weight
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.router = MoERouter(d_model, num_experts, **kw)
        self.experts = ExpertsFFN(num_experts, expert_hidden_dim, d_model, **kw,
                                  quantized=quantized)

    def _routed(self, x: torch.Tensor, split: bool) -> bool:
        """Whether dense dispatch runs over the routed rows: a whole bank
        (no expert or model axis), not quantized, outside a CUDA graph's
        capture (the group sizes are read to the host), and at least
        ``ROUTED_MIN_ROWS`` routed rows an expert on average."""
        e = self.experts
        rows = x.shape[0] * x.shape[1] * self.top_k
        return (not split and not e.quantized and e.tp_group is None
                and not (x.is_cuda and torch.cuda.is_current_stream_capturing())
                and rows >= ROUTED_MIN_ROWS * self.num_experts)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        router_logits = self.router(x).float()
        router_probs = torch.softmax(router_logits, dim=-1)
        top_k_indices, top_k_probs = moe_dispatch.top_k_gating(router_logits, self.top_k)
        mesh = self.mesh
        split = mesh is not None and self.experts.b_up.shape[0] < self.num_experts
        if self.dispatch == "ep" and mesh is None:
            raise ValueError('dispatch="ep" requires a mesh (MoELayer(mesh=...))')
        if self.dispatch == "ep" or (split and self.dispatch == "capacity"):
            from forde_tpu_torch.parallel.expert_parallel import expert_parallel_ffn

            e = self.experts
            output = expert_parallel_ffn(
                x, top_k_indices, top_k_probs, (e.w_up, e.b_up, e.w_down, e.b_down), mesh,
                num_experts=self.num_experts, top_k=self.top_k,
                capacity_factor=self.capacity_factor,
                variant="auto" if self.dispatch == "ep" else "psum", tp_group=e.tp_group,
            )
        elif self.dispatch == "dense" and self._routed(x, split):
            spans.count("moe.routed")
            output = self.experts.routed(x, top_k_indices, top_k_probs)
        elif self.dispatch == "dense":
            spans.count("moe.dense")
            all_out = self.experts.all_tokens(x)  # (E or this rank's E/ep, B, S, D)
            combine = moe_dispatch.combine_matrix(top_k_indices, top_k_probs, self.num_experts)
            if split:
                from forde_tpu_torch.core.mesh import AXIS_EXPERT
                from forde_tpu_torch.parallel.collectives import psum

                group = mesh.group(AXIS_EXPERT)
                e0 = group.index * all_out.shape[0]
                combine = combine[..., e0:e0 + all_out.shape[0]]
                output = psum(moe_dispatch.dense_combine(all_out, combine), group)
            else:
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
        if mesh is not None and not mesh.trivial:
            aux_loss = global_load_balancing_loss(router_probs, top_k_indices,
                                                  self.num_experts, mesh)
        else:
            aux_loss = moe_dispatch.load_balancing_loss(router_probs, top_k_indices,
                                                        self.num_experts)
        aux_loss = aux_loss * self.aux_loss_weight
        return output.to(x.dtype), aux_loss, router_probs


class MoEStatefulLayer(torch.nn.Module):
    """``MoELayer`` plus the sensing buffers ``expert_usage`` (E,) fp32 and
    ``step_count`` int32. ``forward(x, update_stats)``: with
    ``update_stats`` the buffers gain this call's mean router probability
    and one step, in place (the JAX package's mutable ``stats_buffer``);
    serving leaves them as loaded, and the recomputation of a rematted
    block (nn/remat.py) does not add them again."""

    def __init__(self, num_experts: int = 8, top_k: int = 2, expert_hidden_dim: int = 2048,
                 d_model: int = 512, aux_loss_weight: float = 0.01, dispatch: str = "dense",
                 capacity_factor: float = 2.0, dtype=torch.float32,
                 param_dtype=torch.float32, device=None, quantized: bool = False,
                 mesh=None):
        super().__init__()
        self.moe_layer = MoELayer(
            num_experts, top_k, expert_hidden_dim, d_model, aux_loss_weight, dispatch,
            capacity_factor, dtype=dtype, param_dtype=param_dtype, device=device,
            quantized=quantized, mesh=mesh,
        )
        self.register_buffer(
            "expert_usage", torch.zeros(num_experts, dtype=torch.float32, device=device)
        )
        self.register_buffer("step_count", torch.zeros((), dtype=torch.int32, device=device))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        output, aux_loss, router_probs = self.moe_layer(x)
        if update_stats and not recomputing():
            with torch.no_grad():
                usage = router_probs.mean(dim=(0, 1)).float()
                mesh = self.moe_layer.mesh
                if mesh is not None and not mesh.trivial:
                    from forde_tpu_torch.parallel.collectives import pmean

                    usage = pmean(usage, _token_group(mesh))  # the global batch's mean
                self.expert_usage += usage
                self.step_count += 1
        return output, aux_loss
