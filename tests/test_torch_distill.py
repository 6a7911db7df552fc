"""Distillation in the port (forde_tpu_torch.train.distill), mirroring
tests/test_distill.py:

* one ``make_distill_step`` against the JAX package's: the teacher and the
  student carried across (the teacher 2 layers, the student 1, both with
  NSA and MoE), the same batch: the metrics (``loss/kl`` included) within
  1e-5 relative, Adam's first moment (0.1 x the clipped gradient) within
  1e-5 relative with a floor of 1e-6 of the largest one (fp32 sums in
  other orders), the teacher's stat buffers untouched, the student's
  advanced;
* pure-KL distillation (alpha 0, T 1) halves the KL toward the teacher in
  40 steps;
* the CLI: a teacher trained by the LM loop, a 1-layer student distilled
  from it with ``--distill_from``; a vocabulary mismatch raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.train import distill as jdistill
from forde_tpu.train import state as jstate
from forde_tpu_torch import interop
from forde_tpu_torch.train import distill as tdistill
from forde_tpu_torch.train import loop
from forde_tpu_torch.train import state as tstate

from test_torch_clip_step import _adam_moments
from test_torch_decoder_lm import jax_variables, port_model, tiny_config, token_ids
from test_torch_lm_train import _port_tree

torch.set_num_threads(1)

ALPHA, T, AUX = 0.3, 2.0, 0.01


def _rel(got, want, what, rtol=1e-5, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > rtol * np.abs(want) + floor
    assert not bad.any(), f"{what}: max |d| {np.abs(got - want).max():.3g}"


def test_distill_step_matches_jax():
    t_cfg = tiny_config()
    teacher_jax, t_vars = jax_variables(t_cfg, seed=7)
    s_cfg = tiny_config(num_layers=1)
    js = jstate.create_train_state(s_cfg, jax.random.PRNGKey(0), 1e-3, 0.01,
                                   init_batch_shape=(1, 16))
    init = jax.device_get({"params": js.params, "stats_buffer": js.stats_buffer})
    ids = token_ids(2, 40, seed=3)
    step = jdistill.make_distill_step(teacher_jax, t_vars, aux_loss_weight=AUX, alpha=ALPHA,
                                      temperature=T)
    js, jm = step(js, {"input_ids": jnp.asarray(ids)})

    teacher = port_model(t_cfg, t_vars).requires_grad_(False)
    stats0 = {k: v.clone() for k, v in teacher.named_buffers()}
    student = port_model(s_cfg, init).train()
    ts = tstate.create_train_state(student.config, None, 1e-3, 0.01, model=student)
    ts, tm = tdistill.make_distill_step(teacher, aux_loss_weight=AUX, alpha=ALPHA,
                                        temperature=T)(ts, {"input_ids": torch.from_numpy(ids)})
    for key in ("loss/total", "loss/lm", "loss/kl", "loss/aux", "training/grad_norm"):
        _rel(float(tm[key]), float(jm[key]), key)
    j_mu = interop.flatten(jax.device_get(_adam_moments(js.opt_state)[0]))
    got = _port_tree(ts.model, ts.optimizer.mu)
    assert sorted(got) == sorted(j_mu)
    top = max(np.abs(v).max() for v in j_mu.values())
    for k in j_mu:
        _rel(got[k], j_mu[k], k, floor=1e-6 * top)
    for k, v in teacher.named_buffers():
        assert torch.equal(v, stats0[k]), k
    assert all(int(layer.moe.step_count) == 1 for layer in ts.model.layers)


def test_pure_kl_distillation_converges_toward_teacher():
    t_cfg = tiny_config(use_moe=False, use_sparse_attention=False)
    _, t_vars = jax_variables(t_cfg, seed=7)
    teacher = port_model(t_cfg, t_vars).requires_grad_(False)
    s_cfg = tiny_config(use_moe=False, use_sparse_attention=False, num_layers=1)
    _, s_vars = jax_variables(s_cfg, seed=0)
    student = port_model(s_cfg, s_vars).train()
    state = tstate.create_train_state(student.config, None, 5e-3, 0.0, model=student)
    step = tdistill.make_distill_step(teacher, alpha=0.0, temperature=1.0)
    batch = {"input_ids": torch.from_numpy(token_ids(4, 16, seed=0))}
    kls = []
    for _ in range(40):
        state, metrics = step(state, batch)
        kls.append(float(metrics["loss/kl"]))
    assert np.isfinite(kls).all()
    assert kls[-1] < 0.5 * kls[0], (kls[0], kls[-1])


def test_distill_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--use_dummy_data", "--batch_size", "2", "--seq_len", "32",
            "--no_nsa", "--d_model", "32", "--num_heads", "2", "--num_experts", "2",
            "--window_size", "8", "--slow_loop_interval", "0", "--log_interval", "1"]
    teacher_dir = str(tmp_path / "teacher")
    loop.main(base + ["--steps_per_epoch", "2", "--num_layers", "2",
                      "--checkpoint_dir", teacher_dir])
    out = loop.main(base + ["--steps_per_epoch", "3", "--num_layers", "1",
                            "--distill_from", teacher_dir])
    assert out["step"] == 3
    assert np.isfinite(out["final_metrics"]["loss/kl"])
    teacher = tdistill.load_teacher(teacher_dir, "cpu")
    assert not any(p.requires_grad for p in teacher.parameters())
    monkeypatch.setattr(loop, "config_from_args",
                        lambda args, f=loop.config_from_args: f(args).replace(vocab_size=512))
    with pytest.raises(ValueError, match="vocab mismatch"):
        loop.main(base + ["--steps_per_epoch", "1", "--num_layers", "1",
                          "--distill_from", teacher_dir])
