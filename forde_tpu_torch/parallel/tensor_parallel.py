"""Tensor parallelism over the ``model`` mesh axis: the modules' side of
the Megatron layout (the JAX package gets it from GSPMD over the
shardings of ``core/mesh.tp_param_spec``).

``train.state.shard_model`` keeps each rank's slice of the split
parameters; ``setup`` then tells each module what its slice is, from the
layouts:

* a ``Dense``/``QDense`` split on its output features runs
  column-parallel, one split on its input features row-parallel (its
  partial products summed over the model axis before the bias;
  ``nn/layers.py``, ``ops/quant.py``);
* an attention module whose projections split runs H/tp of its heads: the
  window ring and the dense, NSA-pool and top-k decode caches hold those
  heads only (the top-k scores and indices, from the replicated importance
  scorer, stay whole). A fused ``qkv_proj`` splits by head, not in
  contiguous blocks, so that a rank's q, k and v columns are those of its
  heads (``core.mesh.Sharding.blocks``);
* a ``StatefulLayer`` whose ``w_in`` splits runs its F/tp hidden columns
  (``nn/stateful.py``);
* an expert bank whose hidden dim splits sums its partial outputs over the
  model axis before the combine (``nn/moe.py``);
* a split ``lm_head`` gives this rank's vocabulary columns, and the
  decoder all-gathers the logits over the model axis before the loss and
  before sampling (``models/decoder_lm.py``).

Under the port's gradient convention (parallel/collectives.py) the model
ranks hold the same tokens, so each differentiates 1/tp of their loss, and
``train.step.reduce_gradients`` sums a replicated parameter's gradient over
the model axis too, a split one not.
"""

from __future__ import annotations

from typing import Mapping

import torch

from forde_tpu_torch.core.mesh import AXIS_MODEL, Mesh, Sharding

_ATTENTION_PROJECTIONS = ("qkv_proj", "compressed_q_proj", "topk_q_proj")


def _split_dim(layouts: Mapping[str, Sharding], name: str):
    sh = layouts.get(name)
    return None if sh is None else sh.dim_of(AXIS_MODEL)


def setup(model: torch.nn.Module, mesh: Mesh, layouts: Mapping[str, Sharding]) -> None:
    """Set the tensor-parallel mode of every module of ``model`` (whose
    split parameters already hold this rank's slices) from ``layouts``."""
    from forde_tpu_torch.nn.layers import Dense
    from forde_tpu_torch.nn.moe import ExpertsFFN
    from forde_tpu_torch.nn.stateful import StatefulLayer
    from forde_tpu_torch.ops.quant import QDense

    if mesh.shape[AXIS_MODEL] == 1:
        return
    group = mesh.group(AXIS_MODEL)
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, (Dense, QDense)):
            dim = _split_dim(layouts, prefix + ("weight" if isinstance(module, Dense)
                                                else "weight_q"))
            if dim is not None:
                module.tp = ("column" if dim == 0 else "row", group)
        elif isinstance(module, ExpertsFFN):
            leaf = "w_down_q" if module.quantized else "w_down"
            if _split_dim(layouts, prefix + leaf) is not None:
                module.tp_group = group
        elif isinstance(module, StatefulLayer):
            if _split_dim(layouts, prefix + "w_in.weight") is not None:
                module.tp_group = group
    for name, module in model.named_modules():  # after the projections' modes
        proj = next((getattr(module, p) for p in _ATTENTION_PROJECTIONS
                     if isinstance(getattr(module, p, None), (Dense, QDense))), None)
        if proj is not None and proj.tp is not None and hasattr(module, "num_heads"):
            if module.num_heads % group.size:
                raise ValueError(f"{name}: {module.num_heads} heads do not split over "
                                 f"tensor_parallelism {group.size}")
            module.num_heads //= group.size
