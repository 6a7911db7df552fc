"""LoRA fine-tuning of the decoder LM (port of forde_tpu/train/lora.py).

A frozen base model and trainable low-rank adapters over selected
projection weights,

    W_eff = W + (alpha / rank) * A @ B,   A: (..., in, r), B: (..., r, out)

with A ~ N(0, 1/in) and B = 0, so the merged model equals the base
exactly at init. The adapters keep the JAX package's Flax layout and keys:
each adapted leaf's Flax path (``layer_0/sparse_attention/local_attention/
qkv_proj/kernel``, ``layer_0/moe/moe_layer/experts/w_up``) with
``/lora_a`` and ``/lora_b`` appended, so a JAX adapter tree crosses over
unchanged and checkpoints carry the JAX keys. The delta is computed in
that layout (``A @ B`` over the leading axes of a stacked expert bank)
and then laid onto the torch parameter: transposed for a Dense ``kernel``,
whose torch ``weight`` is (out, in); as it is for ``w_up``/``w_down``.

The step (``make_lora_train_step``) merges each target, runs the base
model on the merged weights with ``torch.func.functional_call`` (so the
gradient reaches A and B through every attention kernel's backward), and
asks autograd for the adapters' gradients only, inside the same call (a
``remat`` backward recomputes the blocks on the merged weights too). The
optimizer holds the adapters alone; the base never changes. ``init_lora``
draws A from a ``torch.Generator``, which cannot reproduce ``jax.random``:
parity tests carry the JAX package's adapters across as numpy.

The adapters are kept per layer, as the model's parameters are. A
checkpoint of a LoRA run over a ``scan_layers`` base writes them in the
JAX package's scanned layout, ``layers/block/<path>/lora_a`` of shape
(L, ..., in, r) (``train/checkpoint.relayout``), and reads either.

Serving merges the adapters into the base weights once at load
(``train/checkpoint.load_lm_params``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from forde_tpu_torch.interop import flax_keys
from forde_tpu_torch.train.state import TrainState
from forde_tpu_torch.train.optim import AdamW

# Attention projections by default (the standard LoRA recipe); add
# "w_up,w_down" to adapt the stacked MoE expert banks too.
DEFAULT_TARGETS = ("qkv_proj", "out_proj", "q_proj", "k_proj", "v_proj")


@dataclasses.dataclass
class LoRAAdapters:
    """``tensors``: adapter tensors by Flax key ("<leaf path>/lora_a",
    "<leaf path>/lora_b"), in the optimizer's order. ``targets``: each
    adapted leaf path -> (torch parameter name, whether the Flax layout
    transposes it)."""

    tensors: Dict[str, torch.Tensor]
    targets: Dict[str, Tuple[str, bool]]


def _is_target(path: Tuple[str, ...], leaf: torch.Tensor, targets: Sequence[str]) -> bool:
    """A leaf is adapted if it is a >= 2-D ``kernel`` whose module name ends
    with a target (so ``out_proj`` covers ``compressed_out_proj`` and
    ``topk_out_proj``), or a >= 2-D leaf named by a target (the MoE expert
    banks ``w_up``/``w_down``, which are parameters, not modules)."""
    if leaf.ndim < 2:
        return False
    if path[-1] == "kernel" and len(path) >= 2:
        return any(path[-2].endswith(t) for t in targets)
    return path[-1] in targets


def param_paths(model: torch.nn.Module) -> Dict[str, Tuple[str, bool]]:
    """Flax path (under ``params``) of each parameter of ``model`` ->
    (torch name, transposed)."""
    keys = flax_keys(n for n, _ in model.named_parameters())
    return {key[len("params/"):]: (name, t) for name, (key, t) in keys.items()}


def _flax_shape(p: torch.Tensor, transposed: bool) -> Tuple[int, ...]:
    return tuple(p.shape[:-2]) + (p.shape[-1], p.shape[-2]) if transposed else tuple(p.shape)


def lora_targets(model: torch.nn.Module, paths: Sequence[str]) -> Dict[str, Tuple[str, bool]]:
    """The torch parameter of each adapted Flax leaf path of ``paths``; a
    path the model does not have raises."""
    known = param_paths(model)
    missing = sorted(set(paths) - set(known))
    if missing:
        raise KeyError(f"adapters for leaves the model does not have: {missing}")
    return {p: known[p] for p in sorted(paths)}


def init_lora(
    model: torch.nn.Module,
    rank: int,
    generator: Optional[torch.Generator],
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> LoRAAdapters:
    """Adapters for every target leaf of ``model``: A (..., in, r) ~
    N(0, 1/in), B (..., r, out) zero, on the model's device, trainable
    (``requires_grad``). Raises if no leaf matches (a mistyped
    --lora_targets is loud, not a silent full freeze)."""
    named = dict(model.named_parameters())
    paths = param_paths(model)
    chosen = sorted(p for p, (name, _) in paths.items()
                    if _is_target(tuple(p.split("/")), named[name], targets))
    if not chosen:
        leaves = sorted({p.split("/")[-1] if not p.endswith("/kernel") else p.split("/")[-2]
                         for p, (name, _) in paths.items() if named[name].ndim >= 2})
        raise ValueError(f"lora targets {tuple(targets)} matched no kernel in the param tree; "
                         f"available >=2-D leaves: {leaves}")
    tensors = {}
    for path in chosen:
        name, transposed = paths[path]
        p = named[name]
        *lead, fan_in, fan_out = _flax_shape(p, transposed)
        a = torch.randn((*lead, fan_in, rank), generator=generator, dtype=dtype, device=p.device)
        tensors[f"{path}/lora_a"] = (a / math.sqrt(fan_in)).requires_grad_()
        tensors[f"{path}/lora_b"] = torch.zeros((*lead, rank, fan_out), dtype=dtype,
                                                device=p.device, requires_grad=True)
    return LoRAAdapters(tensors, {p: paths[p] for p in chosen})


def merge_lora(model: torch.nn.Module, adapters: LoRAAdapters, scale: float) -> Dict[str, torch.Tensor]:
    """{torch parameter name: base + scale * A @ B} for every adapted leaf,
    in the base's dtype (the sum taken in fp32). A function of the base and
    the adapters, differentiable in the adapters: the step runs the model
    on it, and serving copies it into the weights once."""
    named = dict(model.named_parameters())
    out = {}
    for path, (name, transposed) in adapters.targets.items():
        a, b = adapters.tensors[f"{path}/lora_a"], adapters.tensors[f"{path}/lora_b"]
        delta = torch.matmul(a, b) * scale
        if transposed:
            delta = delta.transpose(-1, -2)
        base = named[name]
        out[name] = (base.detach().float() + delta.float()).to(base.dtype)
    return out


def adapter_param_count(adapters: LoRAAdapters) -> int:
    return sum(t.numel() for t in adapters.tensors.values())


def create_lora_train_state(
    full_state: TrainState,
    rank: int,
    generator: Optional[torch.Generator],
    targets: Sequence[str] = DEFAULT_TARGETS,
) -> TrainState:
    """A train state whose optimizer trains adapters over ``full_state``'s
    model, which is frozen (``requires_grad`` off). The optimizer has
    ``full_state``'s settings (LR schedule, weight decay, clipping, moment
    dtype); EMA and checkpoints see the adapters only."""
    model = full_state.model
    model.requires_grad_(False)
    adapters = init_lora(model, rank, generator, targets)
    opt = full_state.optimizer
    optimizer = AdamW(list(adapters.tensors.values()), opt.learning_rate,
                      weight_decay=opt.weight_decay, grad_clip_norm=opt.grad_clip_norm,
                      moment_dtype=opt.moment_dtype)
    return TrainState(model=model, optimizer=optimizer, lora=adapters)


class _LossAndGrads(torch.nn.Module):
    """The base model's forward, the loss and the adapters' gradients as
    one module call. ``functional_call`` puts the merged weights in place
    for the length of one call, and under ``remat`` the backward reruns
    each block's forward: the backward has to run inside the same call, or
    the recomputation would read the frozen base weights."""

    def __init__(self, model: torch.nn.Module, adapters, aux_loss_weight: float):
        super().__init__()
        self.model = model
        self.adapters = adapters
        self.aux_loss_weight = aux_loss_weight

    def forward(self, batch: Dict[str, torch.Tensor]):
        from forde_tpu_torch.train.step import lm_losses

        logits, aux = self.model(batch["input_ids"], update_stats=True)
        objective, total, lm = lm_losses(self.model, logits, aux, batch, self.aux_loss_weight)
        grads = torch.autograd.grad(objective, self.adapters, materialize_grads=True)
        return total.detach(), lm.detach(), aux.detach(), grads


def make_lora_train_step(scale: float, aux_loss_weight: float = 1.0):
    """``(state, batch) -> (state, metrics)`` over a LoRA state: merge ->
    forward on the merged weights (MoE stat buffers updating, as in
    ``train_step``) -> CE + aux -> gradients of the adapters only -> one
    AdamW update of the adapters. The JAX package passes the frozen base as
    a step argument; here the state's model holds it."""

    def lora_train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        from forde_tpu_torch.train.step import reduce_gradients

        merged = merge_lora(state.model, state.lora, scale)
        step = _LossAndGrads(state.model, state.optimizer.params, aux_loss_weight)
        total, lm, aux, grads = torch.func.functional_call(
            step, {f"model.{name}": t for name, t in merged.items()}, (batch,), strict=False)
        grad_norm = state.optimizer.step(reduce_gradients(state, grads))
        state.step += 1
        return state, {
            "loss/total": total,
            "loss/lm": lm,
            "loss/aux": aux,
            "training/grad_norm": grad_norm,
        }

    return lora_train_step


def lora_scale(rank: int, alpha: float) -> float:
    return float(alpha) / float(rank)


def parse_targets(spec: Optional[str]) -> Tuple[str, ...]:
    if not spec:
        return DEFAULT_TARGETS
    return tuple(t.strip() for t in spec.split(",") if t.strip())
