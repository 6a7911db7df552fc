#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package's training loops (Orbax) into
the layout forde_tpu_torch reads: ``model_config.json`` + ``params.npz``,
and with ``--train_state`` the whole train state (``opt_state.npz`` too).

  python scripts/orbax_to_npz.py SRC DST
  python scripts/orbax_to_npz.py --train_state SRC DST
  python scripts/orbax_to_npz.py --train_state --lora_base BASE_DST SRC DST

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
not converted: the port serves, evaluates or warm-starts from DST.

``--train_state`` converts the run whole, so that the port's
``train.loop --resume`` or ``train.clip_loop --resume`` goes on from its
step (``forde_tpu_torch.train.checkpoint.restore_train_state``). The state
is rebuilt as the JAX loops' ``--resume`` rebuilds it (its optimizer from
the train meta, the EMA where the run kept one) and restored; DST then
holds, besides the trees above, ``opt_state.npz``:

* ``mu/...`` and ``nu/...``: Adam's moments under the params' paths,
  widened to fp32 as the port writes them (a bf16 moment too);
* ``count``: Adam's count (int32); ``step``: the train state's step
  (int64); the optimizer's states are found by type, and a schedule whose
  count is not Adam's is refused (the port keeps one count and reads the
  LR at it);
* the dual encoder's ``grad_stats/...`` and ``grad_step_count``.

A LoRA run stays unmerged: ``params/...`` are its adapters (with their EMA
and moments), and its train meta keeps ``lora`` with ``base`` naming
``--lora_base``, the directory the run's base was converted into (a LoRA
run is refused without it). The train meta carries what shapes the
optimizer (moment dtype, warmup, LR schedule), ``ema_decay`` and ``step``.
A run over a mesh (tensor parallelism, say) is restored whole onto one
device, and the port resumes it under any layout.

This script imports JAX and the JAX package; the port imports neither,
nor this script. The layout (the key of each array, the file names) is the
port's own: ``forde_tpu_torch.interop.flatten`` and ``train/checkpoint``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from forde_tpu_torch.interop import flatten  # noqa: E402
from forde_tpu_torch.train.checkpoint import (  # noqa: E402
    MODEL_CONFIG_FILENAME,
    OPT_STATE_FILENAME,
    PARAMS_FILENAME,
)


def _saved_meta(src: str) -> Tuple[str, dict]:
    """(model kind, the train meta) of a JAX training run's checkpoint
    directory; raises if it is not one."""
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
    if kind not in ("llm", "dual_encoder"):
        raise ValueError(f"{meta_path}: unknown model kind {kind!r}")
    return kind, saved.get("train", {})


def read_checkpoint(src: str) -> Tuple[object, dict, dict]:
    """(the JAX config, {collection: tree of numpy arrays}, train meta) of
    the latest step of a JAX training run's checkpoint directory."""
    import jax

    from forde_tpu.train import checkpoint as ckpt

    kind, train = _saved_meta(src)
    if kind == "llm":
        config, state = ckpt.load_lm_state(src)
        trees = {"params": state.params, "stats_buffer": state.stats_buffer}
    else:
        config, state = ckpt.load_clip_state(src)
        trees = {"params": state.params, "brain": state.brain,
                 "stats_buffer": state.stats_buffer}
    if state.ema_params is not None:
        trees["ema_params"] = state.ema_params
    meta = {k: v for k, v in train.items() if k != "lora"}
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


def read_train_state(src: str):
    """(the JAX config, the train meta, the restored train state) of the
    latest step of ``src``, rebuilt as the JAX loops' ``--resume`` rebuilds
    it: the optimizer from the train meta (``_optimizer_meta``), the EMA
    where the meta has ``ema_decay``, and a LoRA run's adapter state
    (``create_lora_train_state`` over a base of the run's config), not
    merged. The target is abstract (``jax.eval_shape``: the tree, shapes
    and dtypes, no weights drawn and no base read), on one device."""
    import jax

    from forde_tpu.train import checkpoint as ckpt
    from forde_tpu.train.ema import init_ema

    kind, meta = _saved_meta(src)
    config = ckpt.load_model_config(src)
    opt_meta = ckpt._optimizer_meta(meta)
    rng = jax.random.PRNGKey(0)
    lora = meta.get("lora")
    if kind == "dual_encoder":
        from forde_tpu.train.clip_step import create_clip_train_state

        def build():
            return create_clip_train_state(config, rng, 1e-4, 0.0, batch_size=1, **opt_meta)
    elif lora:
        from forde_tpu.train import lora as lora_lib
        from forde_tpu.train.state import create_train_state

        def build():  # the JAX loop's --lora_rank state over its base (same config)
            full = create_train_state(config, rng, 1e-4, 0.0,
                                      init_batch_shape=(1, min(64, config.max_seq_len)),
                                      **opt_meta)
            return lora_lib.create_lora_train_state(full, full.params, int(lora["rank"]), rng,
                                                    full.tx, targets=tuple(lora["targets"]))
    else:
        from forde_tpu.train.state import create_train_state

        def build():
            return create_train_state(config, rng, 1e-4, 0.0,
                                      init_batch_shape=(1, min(64, config.max_seq_len)),
                                      **opt_meta)
    ema = float(meta.get("ema_decay", 0.0) or 0.0) > 0
    target = jax.eval_shape(lambda: init_ema(build()) if ema else build())
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    target = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=one), target)
    return config, meta, ckpt.restore_checkpoint(src, target)


def optimizer_arrays(opt_state) -> Dict[str, np.ndarray]:
    """``opt_state.npz``'s optimizer part of an optax state (the chain of
    ``make_optimizer``): ``mu/...``, ``nu/...`` widened to fp32 and Adam's
    ``count``. The states are found by type, so the nesting of
    ``optax.adamw`` and of ``adamw_lowp`` both serve; a schedule count
    (warmup or cosine) other than Adam's is refused."""
    import jax
    import optax

    kinds = (optax.ScaleByAdamState, optax.ScaleByScheduleState)
    found = [x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, kinds))
             if isinstance(x, kinds)]
    adam = [x for x in found if isinstance(x, optax.ScaleByAdamState)]
    if len(adam) != 1:
        raise ValueError(f"the optimizer state holds {len(adam)} Adam states, not one")
    adam = jax.device_get(adam[0])
    count = int(adam.count)
    for sched in found:
        if isinstance(sched, optax.ScaleByScheduleState) and int(sched.count) != count:
            raise ValueError(f"the LR schedule's count {int(sched.count)} is not Adam's {count}: "
                             "the port keeps one count and reads the LR at it")
    arrays = {}
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        arrays.update({k: _widened(v) for k, v in flatten(tree, name).items()})
    arrays["count"] = np.asarray(count, np.int32)
    return arrays


def _widened(a: np.ndarray) -> np.ndarray:
    """A floating array in fp32 (``jax.device_get`` gives a bf16 leaf as
    an ``ml_dtypes`` array, which ``np.savez`` would write as raw bytes)."""
    a = np.asarray(a)
    return a if a.dtype.kind in "iub" else a.astype(np.float32)


def convert_train_state(src: str, dst: str,
                        lora_base: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Convert the JAX run in ``src`` whole into a train state the port's
    ``--resume`` continues (``model_config.json``, ``params.npz``,
    ``opt_state.npz`` in ``dst``); ``lora_base``: the directory a LoRA
    run's base was converted into. Returns the arrays of both files."""
    import jax

    _, meta = _saved_meta(src)
    lora = meta.get("lora")
    if lora and not lora_base:
        raise ValueError(f"{src} is a LoRA run: --lora_base must name the directory its base "
                         f"({lora['base']}) was converted into")
    if lora and not os.path.isfile(os.path.join(lora_base, PARAMS_FILENAME)):
        raise FileNotFoundError(f"--lora_base {lora_base} holds no {PARAMS_FILENAME}")
    if lora_base and not lora:
        raise ValueError(f"--lora_base is for a LoRA run; {src} is not one")
    config, meta, state = read_train_state(src)
    meta = dict(meta)
    if lora:
        meta["lora"] = {**lora, "base": os.path.abspath(lora_base)}
    step = int(jax.device_get(state.step))
    meta["step"] = step
    trees = {"params": state.params, "stats_buffer": state.stats_buffer,
             "ema_params": state.ema_params}
    opt_arrays = optimizer_arrays(state.opt_state)
    opt_arrays["step"] = np.asarray(step, np.int64)
    if hasattr(state, "grad_stats"):
        trees["brain"] = state.brain
        opt_arrays.update({k: _widened(v) for k, v in
                           flatten(jax.device_get(state.grad_stats), "grad_stats").items()})
        opt_arrays["grad_step_count"] = np.asarray(jax.device_get(state.grad_step_count), np.int32)
    trees = {k: jax.tree_util.tree_map(_widened, jax.device_get(v))
             for k, v in trees.items() if v}
    arrays = write_checkpoint(dst, config, trees, meta)
    np.savez(os.path.join(dst, OPT_STATE_FILENAME), **opt_arrays)
    return {**arrays, **opt_arrays}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert a JAX (Orbax) training checkpoint into forde_tpu_torch's "
                    "model_config.json + params.npz (params, EMA, stat buffers, brain; a "
                    "LoRA run merged; a scanned run stays scanned). With --train_state the "
                    "whole train state (Adam's moments and count, the step, the gradient "
                    "statistics; a LoRA run's adapters unmerged) goes into opt_state.npz too, "
                    "and the port's train.loop / clip_loop --resume goes on from its step.")
    p.add_argument("src", help="a forde_tpu train.loop / clip_loop --checkpoint_dir")
    p.add_argument("dst", help="the directory to write")
    p.add_argument("--train_state", action="store_true",
                   help="convert the whole train state, for the port's --resume")
    p.add_argument("--lora_base", default=None, metavar="BASE_DST",
                   help="with --train_state, for a LoRA run: the directory its base was "
                        "converted into (the converted run's train meta names it)")
    args = p.parse_args(argv)
    if args.lora_base and not args.train_state:
        p.error("--lora_base needs --train_state (without it a LoRA run comes out merged)")
    if args.train_state:
        arrays = convert_train_state(args.src, args.dst, args.lora_base)
    else:
        arrays = convert(args.src, args.dst)
    size = sum(a.nbytes for a in arrays.values())
    print(f"{args.src} -> {args.dst}: {len(arrays)} arrays, {size / 2 ** 20:.1f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
