"""Checkpoints of the dual encoder and the decoder LM that both packages
read and write.

A checkpoint directory holds ``model_config.json`` in the JAX package's
schema (``{"model": config_to_dict(cfg), "train": {...}}``) and
``params.npz``, the Flax trees keyed by "/"-joined paths: ``params`` and
``brain`` for the dual encoder
(``params/vision/block_0/attention/qkv_proj/kernel``,
``brain/text/block_1/stateful/neuron_assignments``), ``params`` and
``stats_buffer`` for the decoder LM
(``params/layer_0/sparse_attention/local_attention/qkv_proj/kernel``,
``stats_buffer/layer_0/moe/expert_usage``; a ``scan_layers`` model's
``layers/block/...`` leaves carry a leading (L,) axis). The JAX package's
Orbax train-state directories need JAX to read; flatten their trees into
``params.npz`` on the JAX side.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from forde_tpu_torch.core.config import (
    DualEncoderConfig,
    LLMConfig,
    config_from_dict,
    config_to_dict,
)

MODEL_CONFIG_FILENAME = "model_config.json"
PARAMS_FILENAME = "params.npz"


def save_params(
    directory: str,
    cfg,
    params_npz_dict: Mapping[str, np.ndarray],
    train_meta: Optional[dict] = None,
) -> None:
    """Write ``model_config.json`` and ``params.npz`` (keys "/"-joined Flax
    paths under ``params/`` and ``brain/`` or ``stats_buffer/``)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, MODEL_CONFIG_FILENAME), "w") as f:
        json.dump({"model": config_to_dict(cfg), "train": train_meta or {}}, f, indent=1)
    np.savez(os.path.join(directory, PARAMS_FILENAME), **params_npz_dict)


# The dual encoder's writer, by its name in the first slices of the port.
save_clip_params = save_params


def load_meta(directory: str) -> Tuple[object, dict]:
    """(config, train meta) from ``model_config.json``."""
    path = os.path.join(directory, MODEL_CONFIG_FILENAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{directory} has no {MODEL_CONFIG_FILENAME}")
    with open(path) as f:
        d = json.load(f)
    return config_from_dict(d["model"]), d.get("train", {})


def load_clip_params(directory: str, device) -> Tuple[DualEncoderConfig, torch.nn.Module]:
    """(config, serving model on ``device``) from a checkpoint directory.

    The model is built with ``sense=False`` (the serving path) and holds
    the checkpoint's parameters and neuron assignments exactly: a key
    that is unused or missing raises.
    """
    from forde_tpu_torch.interop import flax_to_state_dict, unflatten
    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder

    cfg, _ = load_meta(directory)
    with np.load(os.path.join(directory, PARAMS_FILENAME)) as npz:
        tree = unflatten({k: npz[k] for k in npz.files})
    model = FORDEDualEncoder(cfg.replace(sense=False), device=device)
    state = flax_to_state_dict(
        tree.get("params", {}), tree.get("brain", {}), expected=model.state_dict()
    )
    model.load_state_dict(state)
    return cfg, model.eval()


def load_lm_params(directory: str, device) -> Tuple[LLMConfig, torch.nn.Module]:
    """(config, decoder LM on ``device`` in eval mode) from a checkpoint
    directory, the unrolled or the ``scan_layers`` layout. The model holds
    the checkpoint's parameters and MoE stat buffers exactly: a key that
    is unused or missing raises (a checkpoint without ``stats_buffer``
    keeps the buffers at zero)."""
    from forde_tpu_torch.interop import flax_to_state_dict, split_scan_layers, unflatten
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    cfg, _ = load_meta(directory)
    if not isinstance(cfg, LLMConfig):
        raise ValueError(f"{directory} holds a {type(cfg).__name__}, not a decoder LM")
    with np.load(os.path.join(directory, PARAMS_FILENAME)) as npz:
        tree = unflatten({k: npz[k] for k in npz.files})
    model = FORDEDecoderLM(cfg, device=device)
    expected = model.state_dict()
    stats = tree.get("stats_buffer")
    if stats is None:
        stat_keys = {k for k in expected if k.endswith(("expert_usage", "step_count"))}
        expected = {k: v for k, v in expected.items() if k not in stat_keys}
    state = flax_to_state_dict(
        split_scan_layers(tree.get("params", {})), {}, expected=expected,
        stats_buffer=split_scan_layers(stats or {}),
    )
    model.load_state_dict(state, strict=stats is not None)
    return cfg, model.eval()
