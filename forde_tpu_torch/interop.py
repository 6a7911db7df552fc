"""Weights between the JAX package's Flax trees and this package's modules.

A Flax path maps to a ``state_dict`` key by joining its names with "."
(``block_3`` becomes ``blocks.3``, ``layer_3`` becomes ``layers.3``) and
renaming the leaf:

* Dense ``kernel`` (in, out)  -> Linear ``weight`` (out, in), transposed
* Embed ``embedding``         -> Embedding ``weight``
* LayerNorm ``scale``         -> LayerNorm ``weight`` (``bias`` stays)
* ``cls_token``, ``register_tokens``, ``pos_embed``, ``logit_scale``, the
  stacked expert banks ``w_up``, ``w_down``, ``b_up``, ``b_down`` (not
  transposed), ``mixing_logits``, ``stream_weights``
                              -> parameters of the same name
* int8 serving (ops/quant.py): a QDense's ``kernel_q`` (in, out) ->
  ``weight_q`` (out, in) int8, transposed as a ``kernel`` is, and its
  per-output-channel ``scale`` (beside ``kernel_q``, so not a LayerNorm's)
  -> ``scale``; the expert bank's ``w_up_q``, ``w_up_scale``,
  ``w_down_q``, ``w_down_scale`` -> parameters of the same name
* brain ``neuron_assignments`` -> the int32 buffer of the same name
* stats_buffer ``act_stats``, ``expert_usage`` (fp32), ``step_count``
  (int32)                     -> the buffers of the same name

The way back names each ``weight`` by the module that holds it (an exact
map of the port's module names, ``_WEIGHT_OWNERS``), not by its rank.

A decoder LM trained with ``scan_layers`` keeps its blocks under
``layers/block/...`` with a leading (L,) axis; ``split_scan_layers``
turns that into the unrolled ``layer_{i}/...`` trees the port's model has,
and ``stack_scan_layers`` turns them back (``state_dict_to_flax`` writes
a tree in either layout).

The JAX train state's ``perturbations`` (the zero tap slots) and
``grad_stats`` trees hold one (F, 2) leaf ``z_tap`` per StatefulLayer; the
port keys the same arrays by the layer's module name
(``vision/block_0/stateful/z_tap`` <-> ``vision.blocks.0.stateful``).

Trees are nested dicts of numpy arrays, flattened as "/"-joined paths in
a checkpoint's ``params.npz`` (``params/...``, ``brain/...``,
``stats_buffer/...``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "embedding": "weight",
    "scale": "weight",
    "bias": "bias",
    "cls_token": "cls_token",
    "register_tokens": "register_tokens",
    "pos_embed": "pos_embed",
    "logit_scale": "logit_scale",
    "w_up": "w_up",
    "w_down": "w_down",
    "b_up": "b_up",
    "b_down": "b_down",
    "mixing_logits": "mixing_logits",
    "stream_weights": "stream_weights",
    "kernel_q": "weight_q",
    "w_up_q": "w_up_q",
    "w_up_scale": "w_up_scale",
    "w_down_q": "w_down_q",
    "w_down_scale": "w_down_scale",
}
# Leaves transposed between Flax's (in, out) and torch's (out, in).
_TRANSPOSED = ("kernel", "kernel_q")
# A QDense's scale keeps its name (a LayerNorm's becomes ``weight``).
_QDENSE_LEAVES = {**_LEAF_TO_TORCH, "scale": "scale"}
_BRAIN_LEAVES = ("neuron_assignments",)
_STATS_LEAVES = {"act_stats": np.float32, "expert_usage": np.float32, "step_count": np.int32}
_TAP_LEAF = "z_tap"
_BLOCK = re.compile(r"^(block|layer)_(\d+)$")
_TORCH_LIST = {"block": "blocks", "layer": "layers"}
_FLAX_ITEM = {v: k for k, v in _TORCH_LIST.items()}
# The Flax leaf behind each torch ``weight``, by the name of the module
# that holds it (the same in both packages).
_WEIGHT_OWNERS = {
    **dict.fromkeys(("token_embed", "pos_embed"), "embedding"),
    **dict.fromkeys(("attn_norm", "mlp_norm", "ffn_norm", "final_norm"), "scale"),
    **dict.fromkeys((
        # dual encoder
        "patch_embed", "qkv_proj", "out_proj", "w_in", "w_out",
        "image_projection", "text_projection",
        # decoder LM
        "stream_init", "collapse_proj", "router_linear", "ffn_up", "ffn_down",
        "lm_head", "gate_compressed", "gate_top_k", "importance_scorer",
        "compressed_q_proj", "compressed_k_proj", "compressed_v_proj",
        "compressed_out_proj", "topk_q_proj", "topk_k_proj", "topk_v_proj",
        "topk_out_proj",
        # the standalone NSA branches (nn/nsa_modules.py)
        "q_proj", "k_proj", "v_proj",
    ), "kernel"),
}


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": leaf}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _torch_key(path: str, leaf_map: Mapping[str, str]) -> str:
    *parents, leaf = path.split("/")
    if leaf not in leaf_map:
        raise KeyError(f"no mapping for the Flax leaf {path!r}")
    names = []
    for p in parents:
        m = _BLOCK.match(p)
        names += [_TORCH_LIST[m.group(1)], m.group(2)] if m else [p]
    return ".".join(names + [leaf_map[leaf]])


def split_scan_layers(tree: Mapping) -> dict:
    """A ``scan_layers`` tree (``layers/block/...`` leaves with a leading
    (L,) axis) -> the unrolled ``layer_{i}/...`` tree; other trees are
    returned as they are."""
    scanned = tree.get("layers")
    if not (isinstance(scanned, Mapping) and "block" in scanned):
        return dict(tree)
    out = {k: v for k, v in tree.items() if k != "layers"}
    for path, value in flatten(scanned["block"]).items():
        for i, row in enumerate(np.asarray(value)):
            out[f"layer_{i}/{path}"] = row
    return unflatten(flatten(out))


def stack_scan_layers(tree: Mapping) -> dict:
    """Inverse of ``split_scan_layers``: the unrolled ``layer_{i}/...``
    subtrees of ``tree`` -> ``layers/block/...`` leaves with a leading (L,)
    axis, each leaf's dtype kept (fp32 params, an (L,) int32
    ``step_count``); a tree without them is returned as it is."""
    index = {}
    for k in tree:
        m = _BLOCK.match(str(k))
        if m and m.group(1) == "layer":
            index[int(m.group(2))] = k
    if not index:
        return dict(tree)
    if sorted(index) != list(range(len(index))):
        raise ValueError(f"layers {sorted(index)} are not 0..{len(index) - 1}")
    per_layer = [flatten(tree[index[i]]) for i in range(len(index))]
    for i, flat in enumerate(per_layer[1:], 1):
        if flat.keys() != per_layer[0].keys():
            raise KeyError(f"layer_{i} has other leaves than layer_0: "
                           f"{sorted(set(flat) ^ set(per_layer[0]))}")
    out = {k: v for k, v in tree.items() if k not in index.values()}
    out["layers"] = {"block": unflatten({
        path: np.stack([flat[path] for flat in per_layer]) for path in per_layer[0]})}
    return out


def flax_to_state_dict(
    params: Mapping,
    brain: Mapping,
    expected: Optional[Mapping[str, torch.Tensor]] = None,
    stats_buffer: Optional[Mapping] = None,
) -> Dict[str, torch.Tensor]:
    """The Flax ``params``, ``brain`` and (optional) ``stats_buffer``
    collections -> a ``state_dict``.

    With ``expected`` (a module's ``state_dict()``), raises on any key it
    leaves unused, any key it is missing, and any shape that differs;
    values take the dtype of the expected tensor. Leaves of a kind it does
    not know always raise.
    """
    out: Dict[str, torch.Tensor] = {}
    flat = flatten(params)
    for path, value in flat.items():
        parent, _, leaf = path.rpartition("/")
        qdense = f"{parent}/kernel_q" in flat
        key = _torch_key(path, _QDENSE_LEAVES if qdense else _LEAF_TO_TORCH)
        t = torch.from_numpy(np.array(value))
        if leaf in _TRANSPOSED:
            t = t.T.contiguous()
        out[key] = t
    for path, value in flatten(brain).items():
        key = _torch_key(path, {n: n for n in _BRAIN_LEAVES})
        out[key] = torch.from_numpy(np.array(value, np.int32))
    for path, value in flatten(stats_buffer or {}).items():
        leaf = path.rsplit("/", 1)[-1]
        key = _torch_key(path, {n: n for n in _STATS_LEAVES})
        out[key] = torch.from_numpy(np.array(value, _STATS_LEAVES[leaf]))
    if expected is None:
        return out
    unused = sorted(set(out) - set(expected))
    missing = sorted(set(expected) - set(out))
    if unused or missing:
        raise KeyError(f"Flax tree vs module: unused {unused}, missing {missing}")
    for key, ref in expected.items():
        if tuple(out[key].shape) != tuple(ref.shape):
            raise ValueError(
                f"{key}: Flax shape {tuple(out[key].shape)} != {tuple(ref.shape)}"
            )
        out[key] = out[key].to(ref.dtype)
    return out


def _flax_names(key: str) -> list:
    """"layers.3.moe.expert_usage" -> ["layer_3", "moe", "expert_usage"]."""
    parts, names = key.split("."), []
    i = 0
    while i < len(parts):
        if parts[i] in _FLAX_ITEM and i + 1 < len(parts) and parts[i + 1].isdigit():
            names.append(f"{_FLAX_ITEM[parts[i]]}_{parts[i + 1]}")
            i += 2
        else:
            names.append(parts[i])
            i += 1
    return names


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor],
                       scan_layers: bool = False) -> Dict[str, dict]:
    """Inverse of ``flax_to_state_dict``: {"params": tree, "brain": tree,
    "stats_buffer": tree} of numpy arrays, the JAX package's layout
    (``brain`` and ``stats_buffer`` empty where the model has none), with
    ``scan_layers`` the scanned one (``stack_scan_layers``). A ``weight``
    takes the Flax leaf of its module (``_WEIGHT_OWNERS``); one under a
    module of another name raises."""
    trees: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "brain": {}, "stats_buffer": {}}
    for key, (path, transposed) in flax_keys(state_dict).items():
        collection, _, flax_path = path.partition("/")
        value = state_dict[key].detach().cpu()
        if collection == "brain":
            value = value.numpy().astype(np.int32)
        elif collection == "stats_buffer":
            value = value.numpy().astype(_STATS_LEAVES[flax_path.rsplit("/", 1)[-1]])
        else:
            value = value.numpy() if value.dtype == torch.int8 else value.float().numpy()
            value = np.array(value.T if transposed else value)
        trees[collection][flax_path] = value
    stack = stack_scan_layers if scan_layers else dict
    return {k: stack(unflatten(v)) for k, v in trees.items()}


def flax_keys(names) -> Dict[str, Tuple[str, bool]]:
    """The checkpoint key of each ``state_dict`` key of ``names``
    ("params/...", "brain/..." or "stats_buffer/...", the Flax path under
    its collection) and whether the Flax layout transposes the tensor: the
    naming of ``state_dict_to_flax``, without the values."""
    out = {}
    for key in names:
        *names_, leaf = _flax_names(key)
        collection = "params"
        if leaf in _BRAIN_LEAVES:
            collection = "brain"
        elif leaf in _STATS_LEAVES:
            collection = "stats_buffer"
        elif leaf == "weight_q":
            leaf = "kernel_q"
        elif leaf == "weight":
            owner = names_[-1] if names_ else ""
            if owner not in _WEIGHT_OWNERS:
                raise KeyError(f"no Flax leaf known for the weight of module {owner!r} ({key})")
            leaf = _WEIGHT_OWNERS[owner]
        out[key] = ("/".join([collection] + names_ + [leaf]), leaf in _TRANSPOSED)
    return out


def grad_stats_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A ``perturbations`` or ``grad_stats`` tree -> {layer name: (F, 2)
    fp32 tensor}."""
    out = {}
    for path, value in flatten(tree).items():
        key = _torch_key(path, {_TAP_LEAF: _TAP_LEAF})
        out[key.removesuffix("." + _TAP_LEAF)] = torch.from_numpy(np.array(value, np.float32))
    return out


def grad_stats_key(name: str) -> str:
    """The Flax path of a StatefulLayer's (F, 2) slot in the ``perturbations``
    and ``grad_stats`` trees ("vision.blocks.0.stateful" ->
    "vision/block_0/stateful/z_tap")."""
    return "/".join(_flax_names(name) + [_TAP_LEAF])


def grad_stats_to_flax(grad_stats: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``grad_stats_from_flax``: the JAX package's tree of
    numpy arrays."""
    return unflatten({
        grad_stats_key(name): t.detach().cpu().float().numpy()
        for name, t in grad_stats.items()
    })
