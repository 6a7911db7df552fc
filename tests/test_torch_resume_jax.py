"""A JAX training run resumed in the port: ``scripts/orbax_to_npz.py
--train_state`` converts the JAX loops' Orbax train state (Adam's moments
and count, the step, the EMA, the stat buffers, the dual encoder's brain
and gradient statistics, a LoRA run's adapters) into the port's
``model_config.json`` + ``params.npz`` + ``opt_state.npz``, which
``restore_train_state`` reads for ``--resume``.

Six JAX runs on the CPU at the sizes of ``test_torch_orbax_convert.py``,
each checkpointed at its last step s:

* ``lm``: the LM loop, 1 layer, warmup 1 into a cosine schedule, bf16
  Adam moments, an EMA;
* ``scanned``: 2 layers, ``--scan_layers``;
* ``lora``: rank-4 LoRA over ``lm`` with an EMA of the adapters (its base
  converted first and named by ``--lora_base``); ``lora_scanned``: over
  ``scanned`` (the adapters in the scanned layout, (L, ...) leaves);
* ``clip``: the clip loop, a custom 1 + 1 layer preset at 32 px, an EMA,
  sensing every step, Forde-lite brain updates every 2nd step (s = 3: the
  checkpoint holds one step's gradient statistics);
* ``tp``: the LM loop under ``--tensor_parallelism 2`` (the state split
  over the model axis of the virtual CPU devices, gathered whole).

Each converted state restored by the port equals the JAX state restored
as its ``--resume`` restores it, bit for bit (bf16 moments widened to fp32
exactly). Then both take the same two steps through their train steps on
fixed numpy batches (the clip run with a Forde-lite update between them,
which reads the carried gradient statistics), and the losses, parameters,
Adam's moments, count and step, the EMA, the stat buffers, the brain and
the gradient statistics agree.

Tolerance atol = rtol = 1e-5 in fp32: the same fp32 values through each
framework's sums in other orders, one or two layers and two Adam steps.
bf16 moments: both sides round an fp32 moment to bf16 after each step, and
fp32 values that differ in their last bits may round to neighbouring bf16
values, one bf16 spacing apart (at most 2^-7 of the value); the bar is that
spacing, rtol 2^-7, with fp32's atol for moments near 0. An attention's
key bias has a gradient of 0 but for rounding (softmax ignores a value
added to a row's every score), which Adam scales into unrelated steps of
up to ~2 lr on each side: its elements are held within 4 lr per resumed
step (``KEY_BIAS_STEPS``). The gradient norm, a metric, is held at rtol 1e-3
(``NORM_TOL``: the CPU's fp32 norm of a 1.6M-element gradient). Dropout
is 0 and the GMM is not used (``torch.Generator`` and ``jax.random`` draw
different numbers).

Also: ``python -m forde_tpu_torch.train.loop --device cpu --resume`` on a
converted directory prints ``resumed from step 2`` and ends at step 4, as
the JAX loop resumed with the same flags does, with its parameters; and
the refusals: a LoRA run without ``--lora_base``, and a checkpoint whose
LR schedule count is not Adam's.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from forde_tpu.core import mesh as jmesh
from forde_tpu.core.config import BrainConfig as JaxBrainConfig
from forde_tpu.brain import neuron_slow_loop as jnsl
from forde_tpu.train import checkpoint as jckpt
from forde_tpu.train import clip_loop as jclip
from forde_tpu.train import clip_step as jclip_step
from forde_tpu.train import ema as jema
from forde_tpu.train import lora as jlora
from forde_tpu.train import loop as jloop
from forde_tpu.train import state as jstate
from forde_tpu.train import step as jstep
from forde_tpu_torch import interop
from forde_tpu_torch.brain import neuron_slow_loop as tnsl
from forde_tpu_torch.core.config import BrainConfig
from forde_tpu_torch.train import checkpoint as tckpt
from forde_tpu_torch.train import clip_step as tclip_step
from forde_tpu_torch.train import ema as tema
from forde_tpu_torch.train import lora as tlora
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train.step import train_step

from test_torch_clip_step import _adam_moments

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import orbax_to_npz  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
# The gradient norm, a metric (below the clip norm of 1.0 it scales
# nothing; above it, the update by its reciprocal): the CPU's fp32
# torch._foreach_norm sums the squares of the 1.6M-element embedding's
# gradient in order, and such a sum carries ~sqrt(n) 2^-24 ~ 1e-4 of itself.
NORM_TOL = dict(atol=0.0, rtol=1e-3)
# An attention's key bias (_key_bias) has a gradient of 0 but for rounding:
# softmax is unchanged when one value is added to every score of a row, and
# q . b_k is such a value. Adam scales that noise, different on the two
# sides, into steps of up to ~2 lr on each side (|m / sqrt(v)| <= ~2 over a
# few steps), so the two sides part by up to 4 lr per resumed step.
KEY_BIAS_STEPS = 2
LM_FLAGS = ["--use_dummy_data", "--steps_per_epoch", "2", "--num_epochs", "1",
            "--batch_size", "2", "--seq_len", "32", "--d_model", "32", "--num_heads", "2",
            "--num_experts", "2", "--window_size", "8", "--slow_loop_interval", "0",
            "--log_interval", "1", "--plots_dir", ""]
CLIP_FLAGS = ["--preset", "custom", "--image_size", "32", "--patch_size", "16",
              "--tower_layers", "1", "--tower_dim", "128", "--embed_dim", "32",
              "--text_len", "16", "--batch_size", "2", "--num_steps", "3",
              "--use_dummy_data", "--slow_loop_interval", "2", "--forde_lite",
              "--log_interval", "1", "--plots_dir", "", "--ema_decay", "0.5"]
RUN_FLAGS = {
    "lm": LM_FLAGS + ["--num_layers", "1", "--warmup_steps", "1", "--lr_schedule", "cosine",
                      "--decay_steps", "8", "--min_lr_ratio", "0.1", "--moment_dtype",
                      "bfloat16", "--ema_decay", "0.5"],
    "scanned": LM_FLAGS + ["--num_layers", "2", "--scan_layers"],
    "lora": LM_FLAGS + ["--lora_rank", "4", "--ema_decay", "0.5"],  # + --init_from lm
    "lora_scanned": LM_FLAGS + ["--lora_rank", "4"],  # + --init_from scanned
    "clip": CLIP_FLAGS,
    "tp": LM_FLAGS + ["--num_layers", "1", "--tensor_parallelism", "2"],
}
LORA_BASES = {"lora": "lm", "lora_scanned": "scanned"}
STEPS = {"clip": 3}  # s, the step of each checkpoint (2 elsewhere)
SLOW_LOOP_AFTER = 4  # the clip run's Forde-lite update, between its two resumed steps


def _flags(name, dirs):
    flags = list(RUN_FLAGS[name])
    if name.startswith("lora"):
        flags += ["--init_from", dirs[LORA_BASES[name]]]
    return flags + ["--checkpoint_dir", dirs[name]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (JAX checkpoint dir, converted dir)}: the JAX loops' runs,
    converted by the script's command line (the LoRA run with its base's
    converted directory)."""
    tmp = tmp_path_factory.mktemp("resume_jax")
    dirs = {name: str(tmp / name) for name in RUN_FLAGS}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)  # the loops' metrics go to ./runs
        for name in RUN_FLAGS:
            module = jclip if name == "clip" else jloop
            module.train(module.build_parser().parse_args(_flags(name, dirs)))
    out = {}
    for name, src in dirs.items():
        dst = str(tmp / f"{name}_port")
        extra = ["--lora_base", out[LORA_BASES[name]][1]] if name in LORA_BASES else []
        assert orbax_to_npz.main(["--train_state", *extra, src, dst]) == 0
        out[name] = (src, dst)
    out["tmp"] = tmp
    return out


# ---------------------------------------------------------------------------
# the JAX side: restored as the loops' --resume restores, then two steps
# ---------------------------------------------------------------------------

def _jax_resumed(name, src, dirs):
    """(args, mesh, the JAX train state restored as the loop's --resume
    restores it: built from the flags, LoRA adapters over the base, EMA,
    put on the loop's mesh, then restored from the latest step)."""
    if name == "clip":
        args = jclip.build_parser().parse_args(_flags(name, dirs))
        cfg = jclip.config_from_args(args)
        mesh = jmesh.create_mesh_for_batch(args.batch_size, model=args.tensor_parallelism)
        state = jclip_step.create_clip_train_state(
            cfg, jax.random.PRNGKey(1), args.learning_rate, args.weight_decay,
            batch_size=args.batch_size, text_len=args.text_len, warmup_steps=args.warmup_steps,
            moment_dtype=args.moment_dtype, lr_schedule=args.lr_schedule,
            decay_steps=args.decay_steps, min_lr_ratio=args.min_lr_ratio)
    else:
        args = jloop.build_parser().parse_args(_flags(name, dirs))
        cfg = jckpt.load_model_config(src)
        mesh = jmesh.create_mesh_for_batch(args.batch_size, model=args.tensor_parallelism)
        state = jstate.create_train_state(
            cfg, jax.random.PRNGKey(1), args.learning_rate, args.weight_decay,
            init_batch_shape=(1, min(64, args.seq_len)), warmup_steps=args.warmup_steps,
            moment_dtype=args.moment_dtype, lr_schedule=args.lr_schedule,
            decay_steps=args.decay_steps, min_lr_ratio=args.min_lr_ratio)
        if args.lora_rank:
            _, base, _ = jckpt.load_lm_params(args.init_from)
            state = jlora.create_lora_train_state(
                state, base, args.lora_rank, jax.random.PRNGKey(2), state.tx,
                targets=jlora.parse_targets(args.lora_targets))
            args.base_params = jax.device_put(base, jmesh.replicated(mesh))
    if args.ema_decay > 0:
        state = jema.init_ema(state)
    state = jstate.shard_train_state(state, mesh, param_sharding=args.param_sharding)
    state = jckpt.restore_checkpoint(src, state)
    return args, mesh, state


def _jax_step(name, args):
    if name == "clip":
        step = jclip_step.clip_train_step
    elif args.lora_rank:
        lora_step = jlora.make_lora_train_step(
            jlora.lora_scale(args.lora_rank, args.lora_alpha),
            aux_loss_weight=args.aux_loss_weight)

        def step(state, batch):
            return lora_step(state, args.base_params, batch)
    else:
        def step(state, batch):
            return jstep.train_step(state, batch, aux_loss_weight=args.aux_loss_weight)
    return jema.with_ema(step, args.ema_decay) if args.ema_decay > 0 else step


def _jax_arrays(state) -> dict:
    """Every array of a JAX train state by the port's checkpoint key, the
    layers unrolled (``relayout``), moments widened to fp32: read apart
    from the converter's ``optimizer_arrays``, so that a fault there shows."""
    host = jax.device_get(state)
    flat = {}
    for collection in ("params", "ema_params", "stats_buffer", "brain"):
        tree = getattr(host, collection, None)
        if tree:
            flat.update(interop.flatten(tree, collection))
    for prefix, tree in zip(("mu", "nu"), _adam_moments(host.opt_state)):
        flat.update(interop.flatten(tree, prefix))
    flat = {k: np.asarray(v, np.float32) if v.dtype.kind not in "iub" else v
            for k, v in flat.items()}
    adam = [x for x in jax.tree_util.tree_leaves(
        host.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    flat["count"] = np.asarray(adam[0].count)
    if hasattr(host, "grad_stats"):
        flat.update(interop.flatten(host.grad_stats, "grad_stats"))
        flat["grad_step_count"] = np.asarray(host.grad_step_count)
    return tckpt.relayout(flat, False)


# ---------------------------------------------------------------------------
# the port's side: restore_train_state on the CPU, then the same two steps
# ---------------------------------------------------------------------------

def _port_resumed(name, dst, args):
    cfg, meta = tckpt.load_meta(dst)
    opt = dict(warmup_steps=args.warmup_steps, moment_dtype=args.moment_dtype,
               lr_schedule=args.lr_schedule, decay_steps=args.decay_steps,
               min_lr_ratio=args.min_lr_ratio)
    if name == "clip":
        state = tclip_step.create_clip_train_state(cfg, None, args.learning_rate,
                                                   args.weight_decay, device="cpu", **opt)
    else:
        model = None
        if meta.get("lora"):
            _, model = tckpt.load_lm_params(meta["lora"]["base"], "cpu")
            model.train()
        state = tstate.create_train_state(cfg, None, args.learning_rate, args.weight_decay,
                                          device="cpu", model=model, **opt)
        if meta.get("lora"):
            state = tlora.create_lora_train_state(state, int(meta["lora"]["rank"]), None,
                                                  targets=meta["lora"]["targets"])
    if args.ema_decay > 0:
        tema.init_ema(state)
    tckpt.restore_train_state(dst, state)
    return state


def _port_step(name, args):
    if name == "clip":
        step = tclip_step.clip_train_step
    elif args.lora_rank:
        step = tlora.make_lora_train_step(tlora.lora_scale(args.lora_rank, args.lora_alpha),
                                          aux_loss_weight=args.aux_loss_weight)
    else:
        def step(state, batch):
            return train_step(state, batch, aux_loss_weight=args.aux_loss_weight)
    return tema.with_ema(step, args.ema_decay) if args.ema_decay > 0 else step


def _port_arrays(state) -> dict:
    params, extra = tckpt._state_tensors(state)
    return {k: tckpt._to_numpy(t, tr) for k, (t, tr) in {**params, **extra}.items()}


def _batch(name, seed):
    rng = np.random.RandomState(seed)
    if name != "clip":
        return {"input_ids": rng.randint(0, 50257, (2, 32)).astype(np.int32)}
    mask = (np.arange(16)[None, :] < np.array([16, 9])[:, None]).astype(np.int32)
    return {"image": rng.rand(2, 32, 32, 3).astype(np.float32),
            "input_ids": rng.randint(1, 1000, (2, 16)).astype(np.int32) * mask,
            "attention_mask": mask}


def _key_bias(key: str, shape) -> np.ndarray:
    """The elements of a parameter (or its EMA) that are an attention's key
    bias: the middle third of a fused ``qkv_proj`` bias, a ``k_proj`` bias
    whole (NSA's ``compressed_k_proj``, ``topk_k_proj``)."""
    mask = np.zeros(shape, bool)
    if key.startswith(("params/", "ema_params/")):
        if key.endswith("qkv_proj/bias"):
            third = shape[-1] // 3
            mask[..., third:2 * third] = True
        elif key.endswith("k_proj/bias"):
            mask[...] = True
    return mask


def _hold(got: dict, want: dict, lowp: bool, what: str, lr: float) -> None:
    """Every array of ``want`` in ``got``: integers equal, floats within
    ``TOL``; bf16 moments within one bf16 spacing (rtol 2^-7, atol as
    fp32's); a key bias within ``KEY_BIAS_STEPS`` x 4 lr."""
    assert sorted(got) == sorted(want), (
        f"{what}: port only {sorted(set(got) - set(want))}, JAX only "
        f"{sorted(set(want) - set(got))}")
    bad = []
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, f"{what} {k}: {g.shape} != {w.shape}"
        if w.dtype.kind in "iub":
            if not np.array_equal(g, w):
                bad.append(f"{k}: {int((g != w).sum())} of {w.size} differ")
            continue
        rtol = 2.0 ** -7 if lowp and k.split("/")[0] in ("mu", "nu") else TOL["rtol"]
        atol = np.where(_key_bias(k, w.shape), KEY_BIAS_STEPS * 4 * lr, TOL["atol"])
        d = np.abs(g.astype(np.float64) - w)
        off = d > atol + rtol * np.abs(w)
        if off.any():
            bad.append(f"{k}: {int(off.sum())} of {w.size} off, max |d| {d.max():.3g}, "
                       f"at {np.argwhere(off)[:8].tolist()}")
    assert not bad, f"{what}:\n" + "\n".join(bad)


@pytest.mark.parametrize("name", list(RUN_FLAGS))
def test_resumed_steps_match_jax(runs, name):
    dirs = {n: runs[n][0] for n in RUN_FLAGS}
    src, dst = runs[name]
    args, mesh, js = _jax_resumed(name, src, dirs)
    ts = _port_resumed(name, dst, args)
    s = STEPS.get(name, 2)
    assert int(js.step) == ts.step == s
    want = _jax_arrays(js)
    got = _port_arrays(ts)
    assert int(got["count"]) == s
    for k in want:  # the restored state: bit for bit
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"restored {k}")
    assert sorted(got) == sorted(want)

    lowp = args.moment_dtype == "bfloat16"
    jstep_fn, tstep_fn = _jax_step(name, args), _port_step(name, args)
    sharding = jmesh.batch_sharding(mesh) if name == "clip" else jmesh.tokens_sharding(mesh)
    for i in range(2):
        batch = _batch(name, 10 + i)
        js, jm = jstep_fn(js, jax.device_put(batch, sharding))
        ts, tm = tstep_fn(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key, value in jm.items():
            np.testing.assert_allclose(float(tm[key]), float(value),
                                       **(NORM_TOL if key == "training/grad_norm" else TOL),
                                       err_msg=f"step {s + i + 1} {key}")
        if name == "clip" and s + i + 1 == SLOW_LOOP_AFTER:
            assert int(ts.grad_step_count) == 2 and int(js.grad_step_count) == 2
            brain, stats, grads, _ = jnsl.neuron_slow_loop_step(
                js.brain, js.stats_buffer, js.grad_stats, js.grad_step_count,
                jax.random.PRNGKey(3), brain=JaxBrainConfig(), forde_lite=True)
            js = js.replace(brain=brain, stats_buffer=stats, grad_stats=grads,
                            grad_step_count=js.grad_step_count * 0)
            diag = tnsl.neuron_slow_loop_step(ts.model, ts.grad_stats, ts.grad_step_count,
                                              None, brain=BrainConfig(), forde_lite=True)
            assert not bool(diag["skipped"])
    assert int(js.step) == ts.step == s + 2
    _hold(_port_arrays(ts), _jax_arrays(js), lowp, f"{name} after 2 resumed steps",
          args.learning_rate)


def test_converted_layout(runs):
    """The files and the train meta the port's --resume reads: a scanned
    run stays scanned, a LoRA run keeps its adapters and names its
    converted base, bf16 moments are fp32 on disk."""
    for name in RUN_FLAGS:
        assert tckpt.has_train_state(runs[name][1]), name
    with np.load(os.path.join(runs["scanned"][1], "opt_state.npz")) as z:
        assert z["mu/layers/block/attn_norm/scale"].shape == (2, 32)
        assert z["step"].dtype == np.int64 and int(z["step"]) == 2
        assert z["count"].dtype == np.int32 and int(z["count"]) == 2
    with np.load(os.path.join(runs["lm"][1], "opt_state.npz")) as z:
        assert {str(z[k].dtype) for k in z.files if k.startswith(("mu/", "nu/"))} == {"float32"}
    with np.load(os.path.join(runs["lora"][1], "params.npz")) as z:
        adapters = [k for k in z.files if k.startswith("params/")]
    assert adapters and all(k.endswith(("/lora_a", "/lora_b")) for k in adapters)
    with np.load(os.path.join(runs["lora_scanned"][1], "opt_state.npz")) as z:
        scanned = {k: z[k].shape for k in z.files if k.startswith("mu/")}
    assert scanned and all(k.startswith("mu/layers/block/") and v[0] == 2
                           for k, v in scanned.items())
    _, meta = tckpt.load_meta(runs["lora"][1])
    assert meta["lora"]["base"] == os.path.abspath(runs["lm"][1])
    assert meta["lora"]["rank"] == 4 and meta["step"] == 2 and meta["ema_decay"] == 0.5
    _, meta = tckpt.load_meta(runs["lm"][1])
    assert {k: meta[k] for k in ("moment_dtype", "warmup_steps", "lr_schedule", "decay_steps",
                                 "min_lr_ratio", "ema_decay", "step")} == {
        "moment_dtype": "bfloat16", "warmup_steps": 1, "lr_schedule": "cosine",
        "decay_steps": 8, "min_lr_ratio": 0.1, "ema_decay": 0.5, "step": 2}
    with np.load(os.path.join(runs["clip"][1], "opt_state.npz")) as z:
        assert int(z["grad_step_count"]) == 1
        assert any(k.startswith("grad_stats/") and k.endswith("/z_tap") for k in z.files)


def test_cli_resume_of_a_converted_run(runs):
    """``python -m forde_tpu_torch.train.loop --device cpu --resume`` goes on
    from the converted step 2 to step 4 (two epochs of 2), as the JAX loop
    resumed with the same flags does, and ends with its parameters."""
    tmp = runs["tmp"]
    flags = [f for f in RUN_FLAGS["lm"]]
    flags[flags.index("--num_epochs") + 1] = "2"
    jax_dir, port_dir = str(tmp / "cli_jax"), str(tmp / "cli_port")
    shutil.copytree(runs["lm"][0], jax_dir)
    shutil.copytree(runs["lm"][1], port_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        want = jloop.train(jloop.build_parser().parse_args(
            flags + ["--checkpoint_dir", jax_dir, "--resume"]))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "forde_tpu_torch.train.loop", "--device", "cpu", *flags,
         "--checkpoint_dir", port_dir, "--resume"],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 2" in proc.stdout, proc.stdout
    assert want["step"] == 4 and "checkpoint (step 4) written" in proc.stdout, proc.stdout
    _, meta = tckpt.load_meta(port_dir)
    assert meta["step"] == 4
    got = tckpt.read_npz(os.path.join(port_dir, "params.npz"))
    flat = interop.flatten(jax.device_get(want["state"].params), "params")
    _hold({k: got[k] for k in flat}, flat, False, "the CLI's params at step 4", 3e-4)


def test_lora_without_its_base_is_refused(runs, tmp_path):
    src = runs["lora"][0]
    with pytest.raises(ValueError, match="--lora_base"):
        orbax_to_npz.convert_train_state(src, str(tmp_path / "out"))
    with pytest.raises(ValueError, match="not one"):
        orbax_to_npz.convert_train_state(runs["lm"][0], str(tmp_path / "out"),
                                         lora_base=runs["lm"][1])
    with pytest.raises(SystemExit):
        orbax_to_npz.main(["--lora_base", runs["lm"][1], src, str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_schedule_count_other_than_adams_is_refused(runs, tmp_path):
    """A checkpoint whose ScaleByScheduleState count is not Adam's count:
    the port keeps one count and reads the LR at it, so it is refused."""
    src = str(tmp_path / "skewed")
    _, meta, state = orbax_to_npz.read_train_state(runs["lm"][0])

    def skew(x):
        if isinstance(x, optax.ScaleByScheduleState):
            return x._replace(count=x.count + 1)
        return x

    opt_state = jax.tree_util.tree_map(
        skew, state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
    assert jax.tree_util.tree_structure(opt_state) == jax.tree_util.tree_structure(
        state.opt_state)
    jckpt.save_checkpoint(src, state.replace(opt_state=opt_state), int(state.step))
    shutil.copy(os.path.join(runs["lm"][0], "model_config.json"), src)
    with pytest.raises(ValueError, match="schedule's count 3 is not Adam's 2"):
        orbax_to_npz.convert_train_state(src, str(tmp_path / "out"))
    with open(os.path.join(src, "model_config.json")) as f:
        assert json.load(f)["train"]["lr_schedule"] == "cosine"
