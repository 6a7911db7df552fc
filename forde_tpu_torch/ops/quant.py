"""Weight-only int8 quantization for serving (port of
forde_tpu/ops/quant.py).

Symmetric per-output-channel int8 weights and dynamic per-row (per-token)
int8 activations, so that each product runs int8 x int8 -> int32 and is
rescaled by both scales, as in the JAX package:

* weights: ``q = round(w / s)`` with ``s = max|w| / 127`` per output
  channel (one (dout,) fp32 vector);
* activations: quantized per row on the fly; the rescale
  ``acc * x_scale * w_scale`` is exact (both scales are outer factors of
  the integer sum).

The int32 accumulator is exact, and ``torch.round`` rounds half to even
as ``jnp.round`` does, so the int8 arrays and the accumulators equal the
JAX package's bit for bit. The products are ``torch._int_mm``, a library
call (the JAX package computes them with XLA's ``dot_general`` outside
any Pallas kernel). On CUDA it takes more than 16 rows and K and N that
are multiples of 8; ``int8_matmul`` pads the rows and K, and computes an
N tail of fewer than 8 columns in fp64, where the integer sum is exact,
on the CPU as well, so that the CPU runs what the card runs.

Layouts: ``quantize_params`` rewrites a Flax-layout tree (``kernel_q``
(din, dout), ``scale``, ``bias``; the expert bank's ``w_up_q``,
``w_up_scale``, ``w_down_q``, ``w_down_scale``) or a ``FORDEDecoderLM``
(into a new model with ``config.quantized``). The port's ``QDense`` keeps
its int8 weight as ``weight_q`` (dout, din), the layout of a Linear
``weight``, which ``interop`` transposes to and from Flax's ``kernel_q``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Dense submodules the decoder swaps to QDense under config.quantized.
# The NSA branch projections (its local qkv_proj included) keep fp
# weights (nsa_prefill reads them); embeddings are gathers.
QUANT_MODULE_NAMES = frozenset({"qkv_proj", "out_proj", "ffn_up", "ffn_down", "lm_head"})


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., din, dout) fp kernel -> (int8 kernel, (..., dout) fp32
    scale). The leading ... covers stacked layouts ((L,) of
    ``scan_layers``, (E,) of an expert bank)."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=-2) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_activations(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantization: (..., din) float ->
    ((..., din) int8, (..., 1) fp32 scale). The one recipe of
    ``int8_dense`` and the expert bank. ``group``: the ranks of a
    row-parallel product, each holding a slice of din; the scale is the
    whole row's (its largest magnitude over the group)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None and group.size > 1:
        amax = torch.stack(group.all_gather(amax)).amax(0)
    x_scale = torch.clamp(amax, min=1e-12) / 127.0
    xq = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    return xq, x_scale


_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
_ALIGN = 8  # and K, N multiples of 8


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exactly: ``torch._int_mm``
    within the shapes it takes on CUDA, on every device. Rows are padded to
    17, K to a multiple of 8 with zeros, and the last N % 8 columns are
    summed in fp64. ``wq`` may be a strided view (the transpose of a (N, K)
    weight)."""
    m, k = xq.shape
    n = wq.shape[1]
    if m < _MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _MIN_ROWS - m))
    if k % _ALIGN:
        pad = _ALIGN - k % _ALIGN
        xq, wq = F.pad(xq, (0, pad)), F.pad(wq, (0, 0, 0, pad))
    n_main = n - n % _ALIGN
    parts = []
    if n_main:
        parts.append(torch._int_mm(xq, wq[:, :n_main]))
    if n_main < n:
        # Sums of at most K products of |127 * 127| are exact in fp64.
        parts.append((xq.double() @ wq[:, n_main:].double()).to(torch.int32))
    acc = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return acc[:m]


def int8_dense(x: torch.Tensor, kernel_q: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, out_dtype=torch.float32,
               group=None) -> torch.Tensor:
    """``x @ dequant(kernel_q)`` as an int8 product: x (..., din) float,
    kernel_q (din, dout) int8, w_scale (dout,). Activations are quantized
    per row; the int32 accumulator is rescaled by both scales (fp32).
    ``group``: a row-parallel product (x and kernel_q hold this rank's
    slice of din): the rows' scales are the whole rows', and the int32
    partial sums are summed over the group, exactly, before the rescale."""
    xq, x_scale = quantize_activations(x, group)
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), kernel_q).reshape(*lead, -1)
    if group is not None and group.size > 1:
        acc = group.all_reduce(acc)
    out = acc.float() * x_scale * w_scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def _int8_param(*shape, device=None) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.zeros(shape, dtype=torch.int8, device=device),
                              requires_grad=False)


class QDense(torch.nn.Module):
    """Serving counterpart of ``nn.layers.Dense`` with int8 weights:
    ``weight_q`` (out, in) int8, ``scale`` (out,) fp32 and ``bias`` (out,)
    fp32, made from a trained weight by ``quantize_params``. The output is
    in the compute dtype. ``tp``: as ``Dense.tp`` (a row-parallel product
    through ``int8_dense``'s ``group``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight_q = _int8_param(out_features, in_features, device=device)
        self.scale = torch.nn.Parameter(torch.ones(out_features, device=device),
                                        requires_grad=False)
        self.bias = (torch.nn.Parameter(torch.zeros(out_features, device=device),
                                        requires_grad=False) if bias else None)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.tp[1] if self.tp is not None and self.tp[0] == "row" else None
        return int8_dense(x, self.weight_q.t(), self.scale, self.bias, self.compute_dtype,
                          group=group)


def quantize_params(params):
    """Quantize trained weights for serving.

    A Flax-layout tree (nested dicts of numpy arrays or tensors): every
    subtree named in ``QUANT_MODULE_NAMES`` that holds a ``kernel`` becomes
    {kernel_q, scale, bias}, and a stacked expert bank (``experts`` with
    ``w_up``) becomes {w_up_q, w_up_scale, w_down_q, w_down_scale, b_up,
    b_down}; nothing under ``sparse_attention`` changes, nor anything
    else. Leaves keep their kind (numpy in, numpy out).

    A ``FORDEDecoderLM``: a new model with ``config.quantized``, on the
    same device and in eval mode, holding the same weights quantized.
    """
    if isinstance(params, torch.nn.Module):
        return _quantize_model(params)

    def as_tensor(v):
        return torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v

    def like(v, t):
        return t.numpy() if isinstance(v, np.ndarray) else t

    def walk(name, node, in_nsa):
        if not isinstance(node, Mapping):
            return node
        in_nsa = in_nsa or name == "sparse_attention"
        if not in_nsa and name in QUANT_MODULE_NAMES and "kernel" in node:
            kernel = node["kernel"]
            q, scale = quantize_weight(as_tensor(kernel))
            out = {"kernel_q": like(kernel, q), "scale": like(kernel, scale)}
            if "bias" in node:
                out["bias"] = like(node["bias"], as_tensor(node["bias"]).float())
            return out
        if name == "experts" and "w_up" in node:
            out = {}
            for part in ("up", "down"):
                w = node[f"w_{part}"]
                q, scale = quantize_weight(as_tensor(w))
                out[f"w_{part}_q"], out[f"w_{part}_scale"] = like(w, q), like(w, scale)
            for b in ("b_up", "b_down"):
                out[b] = like(node[b], as_tensor(node[b]).float())
            return out
        return {k: walk(k, v, in_nsa) for k, v in node.items()}

    return walk("", params, False)


@torch.no_grad()
def _quantize_model(model: torch.nn.Module) -> torch.nn.Module:
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.nn.moe import ExpertsFFN

    device = model.token_embed.weight.device
    qmodel = FORDEDecoderLM(model.config.replace(quantized=True), device=device)
    src = model.state_dict()
    state = {k: src[k] for k in qmodel.state_dict() if k in src}
    for name, mod in qmodel.named_modules():
        if isinstance(mod, QDense):
            q, scale = quantize_weight(src[f"{name}.weight"].t())
            state[f"{name}.weight_q"], state[f"{name}.scale"] = q.t().contiguous(), scale
            if mod.bias is not None:
                state[f"{name}.bias"] = src[f"{name}.bias"].float()
        elif isinstance(mod, ExpertsFFN) and mod.quantized:
            for part in ("up", "down"):
                q, scale = quantize_weight(src[f"{name}.w_{part}"])
                state[f"{name}.w_{part}_q"], state[f"{name}.w_{part}_scale"] = q, scale
    qmodel.load_state_dict(state)
    return qmodel.eval()
