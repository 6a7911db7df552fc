#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package's training loops (Orbax) into
the layout forde_tpu_torch reads: ``model_config.json`` + ``params.npz``.

  python scripts/orbax_to_npz.py SRC DST

SRC is a ``forde_tpu.train.loop`` or ``forde_tpu.train.clip_loop``
``--checkpoint_dir`` (its ``model_config.json`` says which). The latest
step is restored through the JAX package's own loader
(``forde_tpu.train.checkpoint.load_lm_state`` or ``load_clip_state``), and
DST receives the trees the port's loaders (``serve``, ``eval_lm``,
``embed``, ``--init_from``, ``--distill_from``) read, keyed by their
"/"-joined Flax paths:

* ``params/...``, and ``ema_params/...`` where the run kept an EMA;
* ``stats_buffer/...`` (the decoder LM's MoE buffers, the dual encoder's
  activation sums) and ``brain/...`` (the dual encoder's neuron
  assignments).

A ``--scan_layers`` run stays scanned (``layers/block/...`` leaves with a
leading (L,) axis). A LoRA run comes out merged, as ``load_lm_state``
returns it: the base with the adapters added, an ordinary dense
checkpoint whose train meta no longer names ``lora``. Optimizer state is
not converted: the port cannot ``--resume`` a converted run, only serve,
evaluate or warm-start from it.

This script imports JAX and the JAX package; the port imports neither,
nor this script. The layout (the key of each array, the file names) is the
port's own: ``forde_tpu_torch.interop.flatten`` and ``train/checkpoint``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Tuple

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from forde_tpu_torch.interop import flatten  # noqa: E402
from forde_tpu_torch.train.checkpoint import MODEL_CONFIG_FILENAME, PARAMS_FILENAME  # noqa: E402


def read_checkpoint(src: str) -> Tuple[object, dict, dict]:
    """(the JAX config, {collection: tree of numpy arrays}, train meta) of
    the latest step of a JAX training run's checkpoint directory."""
    import jax

    from forde_tpu.train import checkpoint as ckpt

    meta_path = os.path.join(src, MODEL_CONFIG_FILENAME)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{src} is not a checkpoint of the JAX training loops: it has "
                                f"no {MODEL_CONFIG_FILENAME}")
    with open(meta_path) as f:
        saved = json.load(f)
    kind = saved["model"].get("kind")
    steps = [d for d in os.listdir(src) if d.isdigit() and os.path.isdir(os.path.join(src, d))]
    if not steps:
        raise FileNotFoundError(f"{src} holds no Orbax step directory")
    if kind == "llm":
        config, state = ckpt.load_lm_state(src)
        trees = {"params": state.params, "stats_buffer": state.stats_buffer}
    elif kind == "dual_encoder":
        config, state = ckpt.load_clip_state(src)
        trees = {"params": state.params, "brain": state.brain,
                 "stats_buffer": state.stats_buffer}
    else:
        raise ValueError(f"{meta_path}: unknown model kind {kind!r}")
    if state.ema_params is not None:
        trees["ema_params"] = state.ema_params
    meta = {k: v for k, v in saved.get("train", {}).items() if k != "lora"}
    meta["step"] = int(jax.device_get(state.step))
    return config, {k: jax.device_get(v) for k, v in trees.items() if v}, meta


def write_checkpoint(dst: str, config, trees: dict, train_meta: dict) -> Dict[str, np.ndarray]:
    """Write ``model_config.json`` (the JAX package's schema, which the port
    reads) and ``params.npz`` (each tree of ``trees`` flattened under its
    collection's name) into ``dst``; returns the arrays written."""
    from forde_tpu.core.config import config_to_dict

    os.makedirs(dst, exist_ok=True)
    arrays = {}
    for collection, tree in trees.items():
        arrays.update(flatten(tree, collection))
    with open(os.path.join(dst, MODEL_CONFIG_FILENAME), "w") as f:
        json.dump({"model": config_to_dict(config), "train": train_meta}, f, indent=1)
    np.savez(os.path.join(dst, PARAMS_FILENAME), **arrays)
    return arrays


def convert(src: str, dst: str) -> Dict[str, np.ndarray]:
    """Convert the JAX run in ``src`` into the port's checkpoint in ``dst``;
    returns the arrays of its ``params.npz``."""
    config, trees, meta = read_checkpoint(src)
    return write_checkpoint(dst, config, trees, meta)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert a JAX (Orbax) training checkpoint into forde_tpu_torch's "
                    "model_config.json + params.npz (params, EMA, stat buffers, brain; a "
                    "LoRA run merged; a scanned run stays scanned). Optimizer state is not "
                    "converted: the port cannot --resume a converted run.")
    p.add_argument("src", help="a forde_tpu train.loop / clip_loop --checkpoint_dir")
    p.add_argument("dst", help="the directory to write")
    args = p.parse_args(argv)
    arrays = convert(args.src, args.dst)
    size = sum(a.nbytes for a in arrays.values())
    print(f"{args.src} -> {args.dst}: {len(arrays)} arrays, {size / 2 ** 20:.1f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
