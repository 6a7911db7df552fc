"""The port's decoder-LM training step (forde_tpu_torch.train.step,
train.state, nn.moe's capacity dispatch) against the JAX package's.

* ``capacity_route`` / ``capacity_gather`` / ``capacity_combine`` exactly,
  overflow drops included, on seeded routing choices.
* One ``train_step`` from the same weights, dense and capacity dispatch
  (capacity factor 0.5: a quarter of the routed choices overflow), on a
  small config (2 layers, d 64, 2 heads of 32, window 16, seq 64 so that
  every NSA branch runs, 4 experts top-2, 2 streams), fp32: the metrics,
  both Adam moments (Adam's first moment is 0.1 x the clipped gradient),
  the parameters after AdamW and the MoE stat buffers. The JAX side runs
  its Pallas attention kernels in interpret mode (``attention_impl=
  "interpret"``); the port runs its kernels' plain versions.
* ``eval_step``.

Tolerance: 1e-4 relative with an absolute floor of 1e-4 of each tensor's
largest value (fp32 sums in other orders through two layers and a
backward), and for the Adam moments a second floor of 1e-6 of the largest
gradient anywhere: some gradients are zero but for rounding (a key bias
shifts every score of a row alike, and the softmax cancels it), and there
the two sides' rounding noise is all there is. Adam's first step is
m^ / (sqrt(v^) + 1e-8), about sign(g) whatever the gradient's size, so it
turns such noise into whole steps: each parameter may also differ by lr
times the difference of the two updates that the compared moments give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.ops import moe_dispatch as jmd
from forde_tpu.train import state as jstate
from forde_tpu.train import step as jstep
from forde_tpu_torch import interop
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.ops import moe_dispatch as tmd
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train import step as tstep

from test_torch_clip_step import _adam_moments, _close

torch.set_num_threads(1)

B, S, LR, WD, AUX = 2, 64, 1e-3, 0.01, 0.01


# ---------------------------------------------------------------------------
# capacity dispatch
# ---------------------------------------------------------------------------


def _routing(t, k, e, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(t, e).astype(np.float32)
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :k].astype(np.int32)
    probs = rng.rand(t, k).astype(np.float32)
    return idx, probs / probs.sum(-1, keepdims=True)


@pytest.mark.parametrize("t,k,e,capacity", [(40, 2, 4, 20), (40, 2, 4, 8), (33, 1, 8, 3),
                                            (64, 2, 8, 2)])
def test_capacity_plan_gather_combine_exact(t, k, e, capacity):
    idx, probs = _routing(t, k, e, seed=t + capacity)
    want = jmd.capacity_route(jnp.asarray(idx), jnp.asarray(probs), e, capacity)
    got = tmd.capacity_route(torch.from_numpy(idx), torch.from_numpy(probs), e, capacity)
    for key in ("slot_token", "slot_valid", "position", "keep", "weight"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    if capacity < t * k / e:
        assert not got["keep"].all()  # some choices overflowed
    x = np.random.RandomState(1).randn(t, 16).astype(np.float32)
    gathered = tmd.capacity_gather(torch.from_numpy(x), got)
    want_g = jmd.capacity_gather(jnp.asarray(x), want)
    np.testing.assert_array_equal(gathered.numpy(), np.asarray(want_g))
    expert_out = np.random.RandomState(2).randn(e, capacity, 16).astype(np.float32)
    np.testing.assert_allclose(
        tmd.capacity_combine(torch.from_numpy(expert_out), got).numpy(),
        np.asarray(jmd.capacity_combine(jnp.asarray(expert_out), want)), atol=1e-6, rtol=1e-6,
    )


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------


def small_config(**kw):
    base = dict(
        vocab_size=512, d_model=64, num_layers=2, num_heads=2, head_dim=32, max_seq_len=S,
        num_experts=4, top_k_experts=2, expert_hidden_dim=128, window_size=16,
        compression_ratio=4, top_k_global=8, num_streams=2, sinkhorn_iterations=3,
        dropout_rate=0.0, attention_impl="interpret",
    )
    base.update(kw)
    return jcfg.LLMConfig(**base)


def both_states(cfg):
    js = jstate.create_train_state(cfg, jax.random.PRNGKey(0), LR, WD, init_batch_shape=(1, S))
    t_cfg = tcfg.config_from_dict(jcfg.config_to_dict(cfg)).replace(attention_impl="auto")
    model = FORDEDecoderLM(t_cfg)
    model.load_state_dict(interop.flax_to_state_dict(
        interop.split_scan_layers(jax.device_get(js.params)), {}, expected=model.state_dict(),
        stats_buffer=jax.device_get(js.stats_buffer),
    ))
    return js, tstate.create_train_state(t_cfg, None, LR, WD, model=model)


def tokens(seed):
    return np.random.RandomState(seed).randint(1, 512, (B, S)).astype(np.int32)


def _port_tree(model, tensors):
    names = [n for n, _ in model.named_parameters()]
    return interop.flatten(interop.state_dict_to_flax(dict(zip(names, tensors)))["params"])


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_train_step_matches_jax(dispatch):
    cfg = small_config(moe_dispatch=dispatch, moe_capacity_factor=0.5)
    js, ts = both_states(cfg)
    ids = tokens(1)
    js, jm = jstep.train_step(js, {"input_ids": jnp.asarray(ids)}, aux_loss_weight=AUX)
    ts, tm = tstep.train_step(ts, {"input_ids": torch.from_numpy(ids)}, aux_loss_weight=AUX)

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
            assert int(port[k]) == int(want[k]) == 1, k
        elif k.startswith("params/"):
            name = k[len("params/"):]
            du = np.abs(update(got_mu[name], got_nu[name]) - update(j_mu[name], j_nu[name]))
            _close(port[k], want[k], k, extra=LR * du)
        else:
            _close(port[k], want[k], k)
    assert ts.step == 1


def test_train_step_capacity_drops_tokens():
    """At capacity factor 0.5 the capacity step's loss differs from the
    dense step's on the same weights: the drops are real."""
    cfg = small_config(moe_dispatch="capacity", moe_capacity_factor=0.5)
    _, ts = both_states(cfg)
    ids = torch.from_numpy(tokens(2))
    capacity = float(tstep.eval_step(ts, {"input_ids": ids})["loss/lm"])
    for layer in ts.model.layers:
        layer.moe.moe_layer.dispatch = "dense"
    dense = float(tstep.eval_step(ts, {"input_ids": ids})["loss/lm"])
    assert abs(capacity - dense) > 1e-4


def test_eval_step_matches_jax_and_leaves_stats():
    cfg = small_config()
    js, ts = both_states(cfg)
    ids = tokens(3)
    want = jstep.eval_step(js, {"input_ids": jnp.asarray(ids)})
    got = tstep.eval_step(ts, {"input_ids": torch.from_numpy(ids)})
    for key in ("loss/lm", "loss/aux"):
        _close(float(got[key]), float(want[key]), key)
    assert all(int(layer.moe.step_count) == 0 for layer in ts.model.layers)


def test_lm_loss_is_shifted_cross_entropy():
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(2, 7, 11).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 11, (2, 7)))
    want = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 11), ids[:, 1:].reshape(-1))
    torch.testing.assert_close(tstep.lm_loss(logits, ids), want)
