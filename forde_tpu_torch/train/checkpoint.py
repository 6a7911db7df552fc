"""Dual-encoder checkpoints that both packages read and write.

A checkpoint directory holds ``model_config.json`` in the JAX package's
schema (``{"model": config_to_dict(cfg), "train": {...}}``) and
``params.npz``, the Flax ``params`` and ``brain`` trees keyed by
"/"-joined paths (``params/vision/block_0/attention/qkv_proj/kernel``,
``brain/text/block_1/stateful/neuron_assignments``). The JAX package's
Orbax train-state directories need JAX to read; flatten their ``params``
and ``brain`` trees into ``params.npz`` on the JAX side.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from forde_tpu_torch.core.config import (
    DualEncoderConfig,
    config_from_dict,
    config_to_dict,
)

MODEL_CONFIG_FILENAME = "model_config.json"
PARAMS_FILENAME = "params.npz"


def save_clip_params(
    directory: str,
    cfg: DualEncoderConfig,
    params_npz_dict: Mapping[str, np.ndarray],
    train_meta: Optional[dict] = None,
) -> None:
    """Write ``model_config.json`` and ``params.npz`` (keys "/"-joined Flax
    paths under ``params/`` and ``brain/``)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, MODEL_CONFIG_FILENAME), "w") as f:
        json.dump({"model": config_to_dict(cfg), "train": train_meta or {}}, f, indent=1)
    np.savez(os.path.join(directory, PARAMS_FILENAME), **params_npz_dict)


def load_clip_meta(directory: str) -> Tuple[DualEncoderConfig, dict]:
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

    cfg, _ = load_clip_meta(directory)
    with np.load(os.path.join(directory, PARAMS_FILENAME)) as npz:
        tree = unflatten({k: npz[k] for k in npz.files})
    model = FORDEDualEncoder(cfg.replace(sense=False), device=device)
    state = flax_to_state_dict(
        tree.get("params", {}), tree.get("brain", {}), expected=model.state_dict()
    )
    model.load_state_dict(state)
    return cfg, model.eval()
