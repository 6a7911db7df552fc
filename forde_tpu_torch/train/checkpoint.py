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
``layers/block/...`` leaves carry a leading (L,) axis: a decoder LM whose
config has ``scan_layers`` is written in that layout, and read in either),
and ``ema_params`` beside ``params`` where the run kept an EMA. The JAX
package's Orbax train-state directories need JAX to read:
``scripts/orbax_to_npz.py`` converts one into this layout, and with
``--train_state`` into a whole train state (``opt_state.npz`` below,
a LoRA run's adapters unmerged) that ``--resume`` continues.

A training run's checkpoint (``save_train_state``) adds ``opt_state.npz``:
Adam's moments and count, the host step and the dual encoder's gradient
statistics, which ``restore_train_state`` reads back for ``--resume``. A
LoRA run's ``params`` are its adapters, and ``load_lm_params`` merges them
into the base recorded in the train meta.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import struct
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Callable, Dict, List, Mapping, Optional, Tuple

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
    paths under ``params/`` and ``brain/`` or ``stats_buffer/``), a decoder
    LM's in the layout its ``cfg.scan_layers`` names (``relayout``)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, MODEL_CONFIG_FILENAME), "w") as f:
        json.dump({"model": config_to_dict(cfg), "train": train_meta or {}}, f, indent=1)
    if isinstance(cfg, LLMConfig):
        params_npz_dict = relayout(params_npz_dict, cfg.scan_layers)
    np.savez(os.path.join(directory, PARAMS_FILENAME), **params_npz_dict)


def relayout(flat: Mapping[str, np.ndarray], scan_layers: bool) -> Dict[str, np.ndarray]:
    """A checkpoint's flat arrays ("<collection>/<Flax path>") in the
    scanned layout (``scan_layers``: each collection's ``layer_{i}/...``
    stacked into ``layers/block/...``) or the unrolled one (split back);
    keys of no collection ("count", "step") stay as they are."""
    from forde_tpu_torch.interop import flatten, split_scan_layers, stack_scan_layers, unflatten

    change = stack_scan_layers if scan_layers else split_scan_layers
    out, collections = {}, {}
    for key, value in flat.items():
        collection, _, path = key.partition("/")
        if path:
            collections.setdefault(collection, {})[path] = value
        else:
            out[key] = value
    for collection, paths in collections.items():
        for path, value in flatten(change(unflatten(paths))).items():
            out[f"{collection}/{path}"] = value
    return out


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


def load_clip_params(directory: str, device,
                     use_ema: bool = False) -> Tuple[DualEncoderConfig, torch.nn.Module]:
    """(config, serving model on ``device``) from a checkpoint directory.

    The model is built with ``sense=False`` (the serving path) and holds
    the checkpoint's parameters (its ``ema_params`` with ``use_ema``; a
    checkpoint without them raises) and neuron assignments exactly: a key
    that is unused or missing raises.
    """
    from forde_tpu_torch.interop import flax_to_state_dict
    from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder

    cfg, _ = load_meta(directory)
    tree = _read_tree(directory, use_ema)
    model = FORDEDualEncoder(cfg.replace(sense=False), device=device)
    state = flax_to_state_dict(
        tree["params"], tree.get("brain", {}), expected=model.state_dict()
    )
    model.load_state_dict(state)
    return cfg, model.eval()


def load_lm_params(directory: str, device, use_ema: bool = False,
                   lora_base_dir: Optional[str] = None,
                   mesh=None) -> Tuple[LLMConfig, torch.nn.Module]:
    """(config, decoder LM on ``device`` in eval mode) from a checkpoint
    directory, the unrolled or the ``scan_layers`` layout. The model holds
    the checkpoint's parameters and MoE stat buffers exactly: a key that
    is unused or missing raises (a checkpoint without ``stats_buffer``
    keeps the buffers at zero).

    ``use_ema``: the model holds the checkpoint's ``ema_params`` instead of
    its ``params`` (a checkpoint without them raises). A LoRA checkpoint
    (its train meta carries ``lora``; its ``params`` are the adapters) is
    resolved as the JAX package's ``load_lm_state`` does: the base is
    loaded from ``lora["base"]`` (or ``lora_base_dir``), the adapters (the
    EMA adapters with ``use_ema``) are merged into its weights, and the
    checkpoint's stat buffers are loaded: a plain model comes back.
    ``mesh``: the model's multi-device paths run on it (it stays whole:
    ``train.state.shard_model`` keeps a rank's part)."""
    from forde_tpu_torch.interop import flax_to_state_dict, split_scan_layers
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM

    cfg, meta = load_meta(directory)
    if not isinstance(cfg, LLMConfig):
        raise ValueError(f"{directory} holds a {type(cfg).__name__}, not a decoder LM")
    tree = _read_tree(directory, use_ema)
    weights = tree["params"]
    lora = meta.get("lora")
    if lora:
        model = _merged_lora_model(lora, weights, tree, device, lora_base_dir)
        return cfg, model.set_mesh(mesh)
    model = FORDEDecoderLM(cfg, device=device, mesh=mesh)
    expected = model.state_dict()
    stats = tree.get("stats_buffer")
    if stats is None:
        stat_keys = {k for k in expected if k.endswith(("expert_usage", "step_count"))}
        expected = {k: v for k, v in expected.items() if k not in stat_keys}
    state = flax_to_state_dict(
        split_scan_layers(weights), {}, expected=expected,
        stats_buffer=split_scan_layers(stats or {}),
    )
    model.load_state_dict(state, strict=stats is not None)
    return cfg, model.eval()


def read_npz(path: str, keep: Callable[[str], bool] = lambda key: True) -> Dict[str, np.ndarray]:
    """The arrays of an uncompressed ``.npz`` (as ``np.savez`` writes it)
    whose key ``keep`` accepts, read straight from their offsets in the
    file. ``np.load`` checks each member's CRC in Python, at about half a
    GB/s; a checkpoint of the reference-default decoder's train state is
    ~4.8 GB. A compressed member is read through ``zipfile``."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename.removesuffix(".npy")
            if not keep(key):
                continue
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as member:
                    out[key] = np.lib.format.read_array(member)
                continue
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            count = int(np.prod(shape, dtype=np.int64))
            data = np.fromfile(f, dtype=dtype, count=count)
            out[key] = data.reshape(shape[::-1]).T if fortran else data.reshape(shape)
    return out


def _read_tree(directory: str, use_ema: bool) -> dict:
    """``params.npz`` as a tree, without the weights that are not served:
    ``params``, or with ``use_ema`` the ``ema_params`` under the key
    ``params`` (a checkpoint without them raises)."""
    from forde_tpu_torch.interop import unflatten

    weights, other = ("ema_params", "params") if use_ema else ("params", "ema_params")
    tree = unflatten(read_npz(os.path.join(directory, PARAMS_FILENAME),
                              lambda k: not k.startswith(other + "/")))
    if use_ema and "ema_params" not in tree:
        raise ValueError(f"{directory} has no EMA weights (ema_params): it was not trained "
                         "with --ema_decay")
    tree["params"] = tree.pop(weights, {})
    return tree


@torch.no_grad()
def _merged_lora_model(lora: dict, weights: dict, tree: dict, device,
                       lora_base_dir: Optional[str]) -> torch.nn.Module:
    """The base of a LoRA checkpoint with its adapters merged into the
    weights and the checkpoint's stat buffers loaded."""
    from forde_tpu_torch.interop import flatten, flax_keys, split_scan_layers
    from forde_tpu_torch.train import lora as lora_lib

    _, model = load_lm_params(lora_base_dir or lora["base"], device)
    # the adapters and stat buffers of a run over a scanned base carry the
    # layers on a leading axis: merge and load them per layer
    flat = {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in flatten(split_scan_layers(weights)).items()}
    paths = {k.rsplit("/", 1)[0] for k in flat}
    adapters = lora_lib.LoRAAdapters(flat, lora_lib.lora_targets(model, paths))
    if len(flat) != 2 * len(paths):
        raise KeyError(f"LoRA adapters need lora_a and lora_b for each leaf: {sorted(flat)}")
    scale = lora_lib.lora_scale(int(lora["rank"]), float(lora["alpha"]))
    named = dict(model.named_parameters())
    for name, merged in lora_lib.merge_lora(model, adapters, scale).items():
        named[name].copy_(merged)
    stats = flatten(split_scan_layers(tree.get("stats_buffer", {})))
    buffers = {key[len("stats_buffer/"):]: name for name, (key, _) in
               flax_keys(n for n, _ in model.named_buffers()).items()
               if key.startswith("stats_buffer/")}
    if stats and set(stats) != set(buffers):
        raise KeyError(f"stat buffers: checkpoint {sorted(stats)} vs model {sorted(buffers)}")
    own = dict(model.named_buffers())
    for path, value in stats.items():
        own[buffers[path]].copy_(torch.from_numpy(np.array(value)))
    return model.eval()


# ---------------------------------------------------------------------------
# the train state
# ---------------------------------------------------------------------------

OPT_STATE_FILENAME = "opt_state.npz"


def _optimizer_meta(meta: dict) -> dict:
    """What in a train meta shapes the optimizer (the JAX package's
    ``_optimizer_meta``): the moment dtype, warmup and the LR schedule (its
    horizon and floor only where the schedule is cosine)."""
    cosine = (meta.get("lr_schedule") or "constant") == "cosine"
    return dict(
        warmup_steps=int(meta.get("warmup_steps", 0) or 0),
        moment_dtype=meta.get("moment_dtype") or None,
        lr_schedule="cosine" if cosine else "constant",
        decay_steps=int(meta.get("decay_steps", 0) or 0) if cosine else 0,
        min_lr_ratio=float(meta.get("min_lr_ratio", 0.0) or 0.0) if cosine else 0.0,
    )


def _meta_of(optimizer) -> dict:
    """The train meta of a built optimizer, for ``_optimizer_meta``."""
    lr = optimizer.learning_rate
    sched = None if isinstance(lr, (int, float)) else lr
    dtype = optimizer.moment_dtype
    return _optimizer_meta({
        "warmup_steps": sched.warmup_steps if sched else 0,
        "moment_dtype": str(dtype).removeprefix("torch.") if dtype is not None else None,
        "lr_schedule": "cosine" if sched and sched.cosine else "constant",
        "decay_steps": sched.decay_steps if sched else 0,
        "min_lr_ratio": sched.min_lr_ratio if sched else 0.0,
    })


if TYPE_CHECKING:
    from forde_tpu_torch.core.mesh import Sharding

_LAYER = re.compile(r"(?<=/)layer_(\d+)(?=/)")


def _param_paths(state) -> List[Tuple[str, bool]]:
    """The Flax path (under ``params/``) of each optimizer parameter, and
    whether the Flax layout transposes it."""
    from forde_tpu_torch.interop import flax_keys

    lora = getattr(state, "lora", None)
    if lora is not None:
        return [(k, False) for k in lora.tensors]
    keys = flax_keys(n for n, _ in state.model.named_parameters())
    return [(k[len("params/"):], t) for k, t in keys.values()]


def _state_tensors(state) -> Tuple[Dict[str, Tuple[torch.Tensor, bool]],
                                   Dict[str, Tuple[torch.Tensor, bool]]]:
    """Every tensor of a train state by its checkpoint key, with whether
    the Flax layout transposes it: (``params.npz``'s, ``opt_state.npz``'s).

    ``params.npz``: ``params/...`` (the trainable tensors: a LoRA state's
    adapters, by their keys), ``ema_params/...``, and the model's buffers
    under ``brain/...`` and ``stats_buffer/...``. ``opt_state.npz``: Adam's
    ``mu/...`` and ``nu/...`` under the params' paths, its ``count``, and
    the dual encoder's ``grad_stats/...`` and ``grad_step_count``."""
    from forde_tpu_torch.interop import flax_keys, grad_stats_key

    model, opt = state.model, state.optimizer
    paths = _param_paths(state)
    if len(paths) != len(opt.params):
        raise ValueError(f"{len(opt.params)} optimizer parameters, {len(paths)} named")
    params: Dict[str, Tuple[torch.Tensor, bool]] = {}
    for prefix, tensors in (("params", opt.params), ("ema_params", state.ema)):
        for (path, t), x in zip(paths, tensors or ()):
            params[f"{prefix}/{path}"] = (x, t)
    buffers = dict(model.named_buffers())
    for name, (key, t) in flax_keys(k for k in model.state_dict() if k in buffers).items():
        params[key] = (buffers[name], t)
    extra: Dict[str, Tuple[torch.Tensor, bool]] = {"count": (opt.count, False)}
    for prefix, tensors in (("mu", opt.mu), ("nu", opt.nu)):
        for (path, t), x in zip(paths, tensors):
            extra[f"{prefix}/{path}"] = (x, t)
    for name, g in getattr(state, "grad_stats", {}).items():
        extra[f"grad_stats/{grad_stats_key(name)}"] = (g, False)
    if hasattr(state, "grad_step_count"):
        extra["grad_step_count"] = (state.grad_step_count, False)
    return params, extra


def _key_layouts(state) -> Dict[str, "Sharding"]:
    """The layout of each split tensor of a state on a mesh by its
    checkpoint key (its parameter's, for the parameter, its EMA and its
    Adam moments; ``train.state.shard_train_state``)."""
    layouts = getattr(state, "layouts", None)
    if getattr(state, "mesh", None) is None or not layouts:
        return {}
    out = {}
    for (path, _), sh in zip(_param_paths(state), layouts):
        if sh.axes:
            for prefix in ("params", "ema_params", "mu", "nu"):
                out[f"{prefix}/{path}"] = sh
    return out


def _gather_state(state, tensors: Dict[str, Tuple[torch.Tensor, bool]]) -> None:
    """Replace each rank's part of a tensor by the whole, all-gathered
    over the axes that split it (every rank calls this; the ranks of one
    group hold the same keys, so they gather in the same order). A GPipe
    stage's layers come last: stage s's local layer j is global layer
    s * L/S + j, so the stages exchange their layers j in turn."""
    from forde_tpu_torch.core.mesh import AXIS_PIPE

    layouts = _key_layouts(state)
    for key in sorted(tensors):
        sh = layouts.get(key)
        if sh is not None and any(a != AXIS_PIPE for a in sh.axes):
            t, transposed = tensors[key]
            tensors[key] = (sh.gather(t), transposed)
    mesh = state.mesh
    if mesh.shape[AXIS_PIPE] == 1:
        return
    group = mesh.group(AXIS_PIPE)
    per = state.model.config.num_layers // group.size
    first = group.index * per
    local = sorted((_LAYER.sub(lambda m: f"layer_{int(m[1]) - first}", k), k)
                   for k in tensors if _LAYER.search(k))
    for canonical, key in local:
        t, transposed = tensors.pop(key)
        j = int(_LAYER.search(canonical)[1])
        for s, piece in enumerate(group.all_gather(t.detach().contiguous())):
            tensors[_LAYER.sub(f"layer_{s * per + j}", canonical)] = (piece, transposed)


def _other_stage(state, key: str) -> bool:
    """Whether ``key`` is a layer that another GPipe stage holds."""
    from forde_tpu_torch.core.mesh import AXIS_PIPE

    mesh = getattr(state, "mesh", None)
    m = _LAYER.search(key)
    if mesh is None or mesh.shape[AXIS_PIPE] == 1 or m is None:
        return False
    from forde_tpu_torch.parallel.pipeline import stage_layers

    return int(m[1]) not in stage_layers(mesh, state.model.config.num_layers)


def _to_numpy(t: torch.Tensor, transposed: bool) -> np.ndarray:
    t = t.detach().cpu()
    a = t.numpy() if t.dtype in (torch.int32, torch.int64, torch.int8) else t.float().numpy()
    return np.ascontiguousarray(a.T) if transposed else a


def _write_npz(path: str, arrays: Mapping[str, np.ndarray]) -> str:
    """Write ``arrays`` to a temporary name beside ``path``; returns it."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    return tmp


def save_train_state(directory: str, state, step: int, train_meta: Optional[dict] = None) -> None:
    """Write the whole train state: ``params.npz`` (what ``serve``,
    ``embed`` and ``eval_lm`` read, plus ``ema_params``), ``opt_state.npz``
    (Adam's moments, widened to fp32, its count, the host step and the
    gradient statistics) and ``model_config.json`` (the train meta, with
    ``step``). A decoder LM whose config has ``scan_layers`` is written in
    the scanned layout (``relayout``): ``params``, ``ema_params``,
    ``stats_buffer`` and Adam's ``mu``/``nu`` stacked under
    ``layers/block/...``. Each file is written under a temporary name first
    and then moved over the old one (``os.replace``), so a preemption while the
    files are written leaves the previous checkpoint whole; the three moves
    come last, back to back, and ``restore_train_state`` refuses files of
    different steps.

    On a mesh every rank calls it: each split tensor is all-gathered
    whole (``_gather_state``), and rank 0 writes the same files, in the JAX
    package's layout, that one process writes."""
    params, extra = _state_tensors(state)
    mesh = getattr(state, "mesh", None)
    if mesh is not None:
        _gather_state(state, params)
        _gather_state(state, extra)
        if mesh.rank != 0:
            return
    os.makedirs(directory, exist_ok=True)
    scanned = bool(getattr(state.model.config, "scan_layers", False))
    arrays = relayout({k: _to_numpy(t, tr) for k, (t, tr) in params.items()}, scanned)
    opt_arrays = relayout({k: _to_numpy(t, tr) for k, (t, tr) in extra.items()}, scanned)
    opt_arrays["step"] = np.asarray(step, np.int64)
    meta = {**(train_meta or {}), "step": step}
    cfg_tmp = os.path.join(directory, MODEL_CONFIG_FILENAME + ".tmp")
    with open(cfg_tmp, "w") as f:
        json.dump({"model": config_to_dict(state.model.config), "train": meta}, f, indent=1)
    names = (OPT_STATE_FILENAME, PARAMS_FILENAME)
    # the two files are written side by side: numpy's zip writer spends
    # most of its time in copies and checksums that release the GIL
    with ThreadPoolExecutor(2) as pool:
        tmps = list(pool.map(_write_npz, [os.path.join(directory, n) for n in names],
                             (opt_arrays, arrays)))
    for tmp, name in [*zip(tmps, names), (cfg_tmp, MODEL_CONFIG_FILENAME)]:
        os.replace(tmp, os.path.join(directory, name))


def has_train_state(directory: str) -> bool:
    """Whether ``directory`` holds a train state that ``--resume`` reads."""
    return all(os.path.exists(os.path.join(directory, n))
               for n in (MODEL_CONFIG_FILENAME, PARAMS_FILENAME, OPT_STATE_FILENAME))


def resume_train_state(directory: str, state):
    """``--resume``: restore the train state in ``directory`` if there is
    one, else start fresh and say so (the JAX loops' ``latest_step() is
    None`` branch)."""
    if has_train_state(directory):
        restore_train_state(directory, state)
        print(f"resumed from step {state.step}", flush=True)
    else:
        print(f"--resume: no checkpoint in {directory}; starting fresh", flush=True)
    return state


@torch.no_grad()
def restore_train_state(directory: str, state):
    """Restore a ``save_train_state`` checkpoint into ``state`` (a
    ``TrainState`` or ``CLIPTrainState`` of the same structure) in place:
    every tensor is written with ``copy_``, so a CUDA graph captured over
    the state stays valid. The checkpoint may be in either layout (scanned
    or unrolled; ``relayout``). Raises on a key that is missing or extra,
    on a shape that differs, on files of different steps, and when the
    checkpoint's optimizer meta (moment dtype, warmup, LR schedule) is not
    the state's. On a mesh each rank restores the whole checkpoint and
    keeps its own part of each tensor (and its stage's layers), so a run
    may resume under another layout or world size. Returns ``state`` with
    ``state.step`` set."""
    _, meta = load_meta(directory)
    saved, own = _optimizer_meta(meta), _meta_of(state.optimizer)
    if saved != own:
        raise ValueError(f"{directory}: the checkpoint's optimizer {saved} is not this run's {own}")
    with ThreadPoolExecutor(2) as pool:
        arrays, opt_arrays = pool.map(
            read_npz, [os.path.join(directory, n) for n in (PARAMS_FILENAME, OPT_STATE_FILENAME)])
    step = int(opt_arrays.pop("step"))
    if step != int(meta.get("step", -1)):
        raise ValueError(f"{directory}: {OPT_STATE_FILENAME} is of step {step}, "
                         f"{MODEL_CONFIG_FILENAME} of step {meta.get('step')}")
    params, extra = _state_tensors(state)
    layouts = _key_layouts(state)
    for name, want, got in (("params.npz", params, arrays), ("opt_state.npz", extra, opt_arrays)):
        got = relayout(got, False)
        missing = sorted(set(want) - set(got))
        unused = sorted(k for k in set(got) - set(want) if not _other_stage(state, k))
        if missing or unused:
            raise KeyError(f"{directory}/{name} vs the train state: missing {missing}, "
                           f"unused {unused}")
        for key, (t, transposed) in want.items():
            value = torch.from_numpy(np.array(got[key]))
            if transposed:
                value = value.transpose(-1, -2)
            if key in layouts:
                value = layouts[key](value)
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(value)
    state.step = step
    return state


@contextlib.contextmanager
def preemption_requests():
    """Within the block SIGTERM and SIGINT only record themselves in the
    list it yields, so that a loop can stop at its next step boundary and
    save (a preempted run resumes with ``--resume``). The handlers are
    installed on the main thread only, as the JAX package's are, and the
    previous ones come back after the block."""
    import signal

    stop: list = []
    previous = {}

    def request_stop(signum, frame):
        if not stop:
            print(f"signal {signum}: finishing step, saving checkpoint, exiting", flush=True)
        stop.append(signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, request_stop)
        except ValueError:  # not the main thread (e.g. under a test runner)
            pass
    try:
        yield stop
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
