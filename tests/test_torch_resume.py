"""The port's train-state checkpoint and resume
(forde_tpu_torch.train.checkpoint.save_train_state / restore_train_state),
the LoRA + EMA serving merge, and preemption:

* a decoder-LM state (EMA on; fp32 and bf16 Adam moments) and a
  dual-encoder state (gradient statistics included) restored into fresh
  states equal the saved ones bit for bit, every tensor, the Adam count
  and the host step; a restored state's next step equals the next step of
  the state that was never saved, bit for bit (the CPU runs the kernels'
  plain versions, which are deterministic);
* refusals: another moment dtype, warmup or LR schedule than the
  checkpoint's (the JAX package's ``_optimizer_meta``), a key missing or
  extra, files of different steps;
* a LoRA checkpoint with EMA adapters (the JAX package's adapter tree,
  its ``lora_b`` made non-zero, as numpy under its Flax keys) over a base
  written from JAX weights (both written by scripts/orbax_to_npz.py's
  ``write_checkpoint``, the layout's one definition): ``load_lm_params`` merges it as the JAX
  package's ``load_lm_state`` does (``merge_lora`` of the base and the
  adapters or, with ``use_ema``, the EMA adapters), and the logits equal
  the JAX model's on the JAX-merged weights within atol = rtol = 1e-5
  (fp32 through two layers; ``lora_base_dir`` overrides a moved base);
* ``python -m forde_tpu_torch.train.loop --device cpu`` in a subprocess:
  SIGTERM after its first logged step gives exit 0 and a checkpoint, and
  ``--resume`` goes on from that step (the test's own timeout: 120 s).
"""

import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.train import lora as jlora
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
from forde_tpu_torch.train import checkpoint as tckpt
from forde_tpu_torch.train import clip_step, loop
from forde_tpu_torch.train import ema as tema
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train.step import train_step

from test_torch_decoder_lm import jax_variables, tiny_config, token_ids

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import orbax_to_npz  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _lm_state(seed, moment_dtype=None, warmup=0):
    cfg = tiny_config(tcfg, attention_impl="auto")
    model = FORDEDecoderLM(cfg, generator=torch.Generator().manual_seed(seed))
    state = tstate.create_train_state(cfg, None, 1e-3, 0.01, warmup_steps=warmup,
                                      moment_dtype=moment_dtype, model=model)
    return tema.init_ema(state)


def _clip_state(seed):
    tower = tcfg.TowerConfig(d_model=64, num_layers=1, num_heads=1, head_dim=64,
                             mlp_hidden_dim=128)
    cfg = tcfg.DualEncoderConfig(image_size=32, patch_size=16, vision=tower, text=tower,
                                 vocab_size=512, max_text_len=16, embed_dim=64)
    model = FORDEDualEncoder(cfg, generator=torch.Generator().manual_seed(seed))
    return tema.init_ema(clip_step.create_clip_train_state(cfg, None, 1e-3, 0.01, model=model))


def _lm_step(state, seed):
    batch = {"input_ids": torch.from_numpy(token_ids(2, 32, seed=seed))}
    return tema.with_ema(lambda s, b: train_step(s, b, aux_loss_weight=0.01), 0.9)(state, batch)


def _clip_step(state, seed):
    rng = np.random.RandomState(seed)
    batch = {"image": torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32)),
             "input_ids": torch.from_numpy(rng.randint(1, 512, (2, 16)).astype(np.int32)),
             "attention_mask": torch.ones(2, 16, dtype=torch.int32)}
    return tema.with_ema(clip_step.clip_train_step, 0.9)(state, batch)


KINDS = {
    "lm_fp32_moments": (lambda seed: _lm_state(seed), _lm_step),
    "lm_bf16_moments": (lambda seed: _lm_state(seed, "bfloat16"), _lm_step),
    "clip": (_clip_state, _clip_step),
}


def _all_tensors(state):
    params, extra = tckpt._state_tensors(state)
    return {k: t for k, (t, _) in {**params, **extra}.items()}


def _assert_same(a, b):
    ta, tb = _all_tensors(a), _all_tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_round_trip_and_next_step_bit_exact(tmp_path, kind):
    make, step = KINDS[kind]
    a = make(0)
    for seed in (1, 2):
        a, _ = step(a, seed)
    tckpt.save_train_state(str(tmp_path), a, a.step, {"moment_dtype": "bfloat16"
                                                     if kind == "lm_bf16_moments" else None})
    b = make(7)
    ptrs = [t.data_ptr() for t in _all_tensors(b).values()]
    tckpt.restore_train_state(str(tmp_path), b)
    assert [t.data_ptr() for t in _all_tensors(b).values()] == ptrs  # written in place
    assert b.step == 2
    _assert_same(a, b)
    a, ma = step(a, 3)
    b, mb = step(b, 3)
    _assert_same(a, b)
    for key in ma:
        assert torch.equal(ma[key], mb[key]), key


def test_restore_refusals(tmp_path):
    a, _ = _lm_step(_lm_state(0, "bfloat16"), 1)
    d = str(tmp_path)
    tckpt.save_train_state(d, a, a.step, {"moment_dtype": "bfloat16"})
    with pytest.raises(ValueError, match="optimizer"):
        tckpt.restore_train_state(d, _lm_state(1))  # fp32 moments
    with pytest.raises(ValueError, match="optimizer"):
        tckpt.restore_train_state(d, _lm_state(1, "bfloat16", warmup=10))
    no_ema = _lm_state(1, "bfloat16")
    no_ema.ema = None
    with pytest.raises(KeyError, match="unused.*ema_params"):
        tckpt.restore_train_state(d, no_ema)
    path = os.path.join(d, tckpt.PARAMS_FILENAME)
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if not k.endswith("final_norm/scale")}
    np.savez(path, **kept)
    with pytest.raises(KeyError, match="missing.*final_norm/scale"):
        tckpt.restore_train_state(d, _lm_state(1, "bfloat16"))
    tckpt.save_train_state(d, a, a.step, {"moment_dtype": "bfloat16"})
    opt = os.path.join(d, tckpt.OPT_STATE_FILENAME)
    with np.load(opt) as z:
        torn = {k: z[k] for k in z.files}
    torn["step"] = np.asarray(5)
    np.savez(opt, **torn)
    with pytest.raises(ValueError, match="of step 5"):
        tckpt.restore_train_state(d, _lm_state(1, "bfloat16"))


@pytest.mark.parametrize("use_ema", [False, True])
def test_lora_ema_checkpoint_merges_as_jax(tmp_path, use_ema):
    cfg = tiny_config()
    model, variables = jax_variables(cfg)
    base_dir = str(tmp_path / "base")
    orbax_to_npz.write_checkpoint(base_dir, cfg, variables, {})
    rng = np.random.RandomState(3)

    def noisy(tree):
        return jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.05).astype(np.float32), tree)

    adapters = jax.device_get(jlora.init_lora(variables["params"], 4, jax.random.PRNGKey(1)))
    adapters = noisy(adapters)  # lora_b non-zero: the merge moves the weights
    ema_adapters = noisy(adapters)
    rank, alpha = 4, 8.0
    lora_dir = str(tmp_path / "lora")
    stats = jax.tree.map(lambda a: np.asarray(a) + 1, variables["stats_buffer"])
    orbax_to_npz.write_checkpoint(
        lora_dir, cfg, {"params": adapters, "ema_params": ema_adapters, "stats_buffer": stats},
        {"step": 3, "ema_decay": 0.9,
         "lora": {"rank": rank, "alpha": alpha, "targets": list(jlora.DEFAULT_TARGETS),
                  "base": base_dir}})
    used = ema_adapters if use_ema else adapters
    merged = jlora.merge_lora(variables["params"], used, jlora.lora_scale(rank, alpha))
    ids = token_ids(2, 40, seed=4)
    (want, _), _ = model.apply({"params": merged, "stats_buffer": variables["stats_buffer"]},
                               jnp.asarray(ids), mutable=["stats_buffer"])
    moved = str(tmp_path / "moved")
    shutil.move(base_dir, moved)
    with pytest.raises(FileNotFoundError):
        tckpt.load_lm_params(lora_dir, "cpu", use_ema=use_ema)
    _, port = tckpt.load_lm_params(lora_dir, "cpu", use_ema=use_ema, lora_base_dir=moved)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for layer, j in zip(port.layers, range(cfg.num_layers)):
        np.testing.assert_array_equal(layer.moe.expert_usage.numpy(),
                                      stats[f"layer_{j}"]["moe"]["expert_usage"])
    if not use_ema:
        return
    with pytest.raises(ValueError, match="no EMA"):
        bare = str(tmp_path / "bare")
        orbax_to_npz.write_checkpoint(bare, cfg, variables, {})
        tckpt.load_lm_params(bare, "cpu", use_ema=True)


def _reader(stream, lines):
    for line in stream:
        lines.put(line)
    lines.put(None)


def test_sigterm_saves_and_resume_continues(tmp_path, monkeypatch, capsys):
    """Preemption: SIGTERM after the first logged step -> the step in
    flight finishes, a checkpoint is written, exit 0; --resume goes on."""
    deadline = time.monotonic() + 120
    ckpt = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--d_model", "32", "--num_layers", "1", "--num_heads", "2",
            "--num_experts", "2", "--window_size", "8", "--seq_len", "16", "--batch_size",
            "2", "--use_dummy_data", "--slow_loop_interval", "0", "--log_interval", "2",
            "--ema_decay", "0.99", "--checkpoint_dir", ckpt]
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "forde_tpu_torch.train.loop", *argv, "--steps_per_epoch",
         "100000"], cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=_reader, args=(proc.stdout, lines), daemon=True).start()
    out = []
    try:
        while True:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
            assert line is not None, "".join(out)
            out.append(line)
            if " step " in line and "loss" in line:
                break
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=max(deadline - time.monotonic(), 1)) == 0, "".join(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    while (line := lines.get(timeout=10)) is not None:
        out.append(line)
    text = "".join(out)
    assert "saving checkpoint" in text and "written to" in text, text
    assert tckpt.has_train_state(ckpt)
    saved = int(tckpt.load_meta(ckpt)[1]["step"])
    assert saved >= 2
    monkeypatch.chdir(tmp_path)
    res = loop.main(argv + ["--steps_per_epoch", str(saved + 2), "--resume"])
    assert f"resumed from step {saved}" in capsys.readouterr().out
    assert res["step"] == saved + 2 and res["state"].step == saved + 2
    assert int(res["state"].optimizer.count) == saved + 2


def test_resume_without_checkpoint_starts_fresh(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = loop.main(["--device", "cpu", "--d_model", "32", "--num_layers", "1", "--num_heads",
                     "2", "--num_experts", "2", "--window_size", "8", "--seq_len", "16",
                     "--batch_size", "2", "--use_dummy_data", "--slow_loop_interval", "0",
                     "--steps_per_epoch", "1", "--checkpoint_dir", str(tmp_path / "c"),
                     "--resume"])
    assert "no checkpoint" in capsys.readouterr().out and out["step"] == 1
