"""Gradient accumulation in the port (forde_tpu_torch.train.step.
make_accum_train_step), mirroring tests/test_train_loop.py's accumulation
cases:

* without MoE the accumulated gradients and losses equal the full batch's
  (the gradients the optimizer receives are captured; 1e-5 relative with a
  floor of 1e-6 of the largest gradient anywhere: fp32 sums in another
  order, and some gradients, a key bias's, are rounding noise only);
* with MoE the stat buffers advance once per microbatch: ``step_count``
  is ``accum_steps`` and ``expert_usage`` the sum of the microbatches'
  mean router probabilities (1e-6);
* one accumulated step against the JAX package's ``make_accum_train_step``
  on carried weights (the small config and tolerances of
  tests/test_torch_lm_train.py: the metrics, both Adam moments, the
  parameters and the stat buffers);
* the CLI with ``--grad_accum 2``, and its refusal of an uneven split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.train import step as jstep
from forde_tpu_torch import interop
from forde_tpu_torch.train import loop
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train import step as tstep

from test_torch_clip_step import _adam_moments, _close
from test_torch_decoder_lm import jax_variables, port_model, tiny_config
from test_torch_lm_train import AUX, LR, _port_tree, both_states, small_config

torch.set_num_threads(1)


def _state(cfg):
    _, variables = jax_variables(cfg)
    model = port_model(cfg, variables).train()
    return tstate.create_train_state(model.config, None, 1e-2, 0.0, model=model)


def _capture_grads(state):
    """Replace the optimizer's step with one that records its gradients."""
    seen = []
    step = state.optimizer.step

    def record(grads):
        seen.append([g.clone() for g in grads])
        return step(grads)

    state.optimizer.step = record
    return seen


def _ids(b, s, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, (b, s)).astype(np.int32))


def test_accumulation_equals_full_batch_without_moe():
    cfg = tiny_config(use_moe=False)
    full, acc = _state(cfg), _state(cfg)
    g_full, g_acc = _capture_grads(full), _capture_grads(acc)
    batch = {"input_ids": _ids(4, 32, 0)}
    _, m_full = tstep.train_step(full, batch, aux_loss_weight=0.0)
    _, m_acc = tstep.make_accum_train_step(2, aux_loss_weight=0.0)(acc, batch)
    for key in ("loss/total", "loss/lm", "training/grad_norm"):
        np.testing.assert_allclose(float(m_acc[key]), float(m_full[key]), rtol=1e-5, err_msg=key)
    top = max(float(b.abs().max()) for b in g_full[0])
    for a, b in zip(g_acc[0], g_full[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6 * top)
    assert full.step == acc.step == 1
    assert int(acc.optimizer.count) == 1


def test_moe_stats_advance_per_microbatch():
    cfg = tiny_config()
    state = _state(cfg)
    ids = _ids(4, 32, 1)
    probe = _state(cfg)
    for mb in ids.reshape(4, 1, 32):
        probe.model(mb, update_stats=True)
    want = [layer.moe.expert_usage.clone() for layer in probe.model.layers]
    _, metrics = tstep.make_accum_train_step(4, aux_loss_weight=0.01)(state, {"input_ids": ids})
    assert np.isfinite(float(metrics["loss/total"]))
    for layer, w in zip(state.model.layers, want):
        assert int(layer.moe.step_count) == 4
        np.testing.assert_allclose(layer.moe.expert_usage.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="not divisible by grad_accum 3"):
        tstep.make_accum_train_step(3)(state, {"input_ids": ids})


def test_accumulated_step_matches_jax():
    cfg = small_config()
    js, ts = both_states(cfg)
    ids = np.random.RandomState(5).randint(1, 512, (4, 32)).astype(np.int32)
    js, jm = jstep.make_accum_train_step(2, aux_loss_weight=AUX)(js, {"input_ids": jnp.asarray(ids)})
    ts, tm = tstep.make_accum_train_step(2, aux_loss_weight=AUX)(ts, {"input_ids": torch.from_numpy(ids)})
    for key in ("loss/total", "loss/lm", "loss/aux", "training/grad_norm"):
        _close(float(tm[key]), float(jm[key]), key)
    j_mu, j_nu = (interop.flatten(jax.device_get(t)) for t in _adam_moments(js.opt_state))
    got_mu, got_nu = (_port_tree(ts.model, m) for m in (ts.optimizer.mu, ts.optimizer.nu))
    assert sorted(got_mu) == sorted(j_mu)
    for moments, got, name in ((j_mu, got_mu, "mu"), (j_nu, got_nu, "nu")):
        top = max(np.abs(np.asarray(w)).max() for w in moments.values())
        for k in moments:
            _close(got[k], moments[k], f"adam {name} {k}", extra=1e-6 * top)

    def update(mu, nu):  # Adam's first step: bias corrections 1 - 0.9, 1 - 0.999
        mu, nu = np.asarray(mu, np.float64) / 0.1, np.asarray(nu, np.float64) / 0.001
        return mu / (np.sqrt(nu) + 1e-8)

    port = interop.flatten(interop.state_dict_to_flax(ts.model.state_dict()))
    want = interop.flatten({"params": jax.device_get(js.params),
                            "stats_buffer": jax.device_get(js.stats_buffer)})
    assert sorted(port) == sorted(want)
    for k in want:
        if k.endswith("step_count"):
            assert int(port[k]) == int(want[k]) == 2, k
        elif k.startswith("params/"):
            name = k[len("params/"):]
            du = np.abs(update(got_mu[name], got_nu[name]) - update(j_mu[name], j_nu[name]))
            _close(port[k], want[k], k, extra=LR * du)
        else:
            _close(port[k], want[k], k)


TINY = ["--d_model", "32", "--num_layers", "1", "--num_heads", "2", "--num_experts", "2",
        "--window_size", "8", "--seq_len", "16", "--device", "cpu", "--use_dummy_data",
        "--slow_loop_interval", "0", "--log_interval", "1"]


@pytest.mark.parametrize("batch,accum,ok", [(4, 2, True), (4, 3, False)])
def test_grad_accum_cli(tmp_path, monkeypatch, batch, accum, ok):
    monkeypatch.chdir(tmp_path)
    argv = TINY + ["--batch_size", str(batch), "--grad_accum", str(accum),
                   "--steps_per_epoch", "2"]
    if not ok:
        with pytest.raises(ValueError, match="must divide --batch_size"):
            loop.main(argv)
        return
    out = loop.main(argv)
    assert out["step"] == 2 and np.isfinite(out["final_metrics"]["loss/total"])
    assert all(int(layer.moe.step_count) == 2 * accum for layer in out["state"].model.layers)
