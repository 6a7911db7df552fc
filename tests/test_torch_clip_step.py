"""The port's training step against the JAX package's: one sensed step
(``clip_train_step``) and one unsensed step (``make_nosense_step``) from
one state, and the optimizer and LR schedule on their own.

A small config (2 + 2 layers, d 128, image 32, patch 16, text 16, fp32;
head_dim 64 and 128): the JAX train state is created, its neuron
assignments set to a seeded mix of 0/1/2, and ``interop`` carries params,
brain, stat buffers and the gradient-stat tree into the port. The JAX
side runs its Pallas kernels in interpret mode (``attention_kernel_impl=
"interpret"``, ``FORDE_MOMENT_IMPL=interpret``); the port runs its
kernels' plain versions. Batches come from numpy with a seed.

Tolerance 1e-4 relative (fp32 sums in other orders through two towers
and a backward), with an absolute floor of 1e-4 of each tensor's largest
value for elements near 0: metrics, stat buffers, gradient stats, both
Adam moments, and the parameters after AdamW, with and without bf16
moments. Adam's step is lr * m / (sqrt(v) + 1e-8), at most ~2 lr in size
whatever the gradient's, so its error is the gradient's relative error:
a gradient known to within 1e-5 of its tensor's largest value gives a
step known to within lr * min(2, 2e-5 * max sqrt(v) / sqrt(v)). Each
parameter also gets that much per step (bf16 moments: see ``compare``).
The optimizer alone (``AdamW`` vs optax's chain) and the LR schedule (vs
optax's schedules) are compared at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.train import clip_step as jstep
from forde_tpu.train import state as jstate
from forde_tpu_torch import interop
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
from forde_tpu_torch.train import clip_step as tstep
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train.optim import AdamW

torch.set_num_threads(1)

B, S_TEXT, LR, WD = 4, 16, 1e-3, 0.01


@pytest.fixture(autouse=True)
def _interpret_moments(monkeypatch):
    monkeypatch.setenv("FORDE_MOMENT_IMPL", "interpret")


def small_config(head_dim):
    heads = 128 // head_dim
    tower = jcfg.TowerConfig(
        d_model=128, num_layers=2, num_heads=heads, head_dim=head_dim, mlp_hidden_dim=256
    )
    return jcfg.DualEncoderConfig(
        image_size=32, patch_size=16, vision=tower, text=tower, vocab_size=1024,
        max_text_len=S_TEXT, embed_dim=128, attention_kernel_impl="interpret",
        dtypes=jcfg.DTypePolicy(),
    )


def batch(seed):
    rng = np.random.RandomState(seed)
    lens = np.array([S_TEXT, 5, 1, 11])
    mask = (np.arange(S_TEXT)[None, :] < lens[:, None]).astype(np.int32)
    return {
        "image": rng.rand(B, 32, 32, 3).astype(np.float32),
        "input_ids": rng.randint(1, 1024, (B, S_TEXT)).astype(np.int32) * mask,
        "attention_mask": mask,
    }


def both_states(head_dim, moment_dtype):
    cfg = small_config(head_dim)
    js = jstep.create_clip_train_state(
        cfg, jax.random.PRNGKey(0), LR, WD, batch_size=B, text_len=S_TEXT,
        moment_dtype=moment_dtype,
    )
    rng = np.random.RandomState(100)
    brain = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randint(0, 3, a.shape), jnp.int32), js.brain
    )
    js = js.replace(brain=brain)
    t_cfg = tcfg.config_from_dict(jcfg.config_to_dict(cfg)).replace(attention_kernel_impl="auto")
    model = FORDEDualEncoder(t_cfg)
    model.load_state_dict(interop.flax_to_state_dict(
        jax.device_get(js.params), jax.device_get(js.brain), expected=model.state_dict(),
        stats_buffer=jax.device_get(js.stats_buffer),
    ))
    ts = tstep.create_clip_train_state(
        t_cfg, None, LR, WD, moment_dtype=moment_dtype, model=model
    )
    ts.grad_stats = interop.grad_stats_from_flax(jax.device_get(js.grad_stats))
    return cfg, js, ts


def _close(got, want, what, extra=0.0, rtol=1e-4, floor=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    atol = floor * max(np.abs(want).max(), 1e-30)
    bad = np.abs(got - want) > rtol * np.abs(want) + atol + extra
    assert not bad.any(), (
        f"{what}: {bad.sum()} of {bad.size} differ, max |d| {np.abs(got - want).max():.3g}"
    )


def _adam_moments(opt_state):
    """(mu, nu) of the ScaleByAdamState inside optax's nested chain state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam_moments(sub)
            if found is not None:
                return found
    return None


def compare(js, ts, jm, tm, slack):
    """``slack``: {param key: the error Adam's steps so far may carry per
    element (module docstring)}, carried from step to step."""
    for key in ("loss/contrastive", "training/grad_norm", "contrastive/acc_img",
                "contrastive/acc_txt", "contrastive/logit_scale"):
        _close(float(tm[key]), float(jm[key]), key)
    names = [n for n, _ in ts.model.named_parameters()]
    j_mu, j_nu = (interop.flatten(jax.device_get(t)) for t in _adam_moments(js.opt_state))
    # bf16 moments: the two sides round fp32 values that differ in their
    # last bits, so a stored moment may sit one bf16 ulp of itself, or of
    # the value it came from, away; the update u = m / (sqrt(v) + eps), at
    # most ~2 in size, then moves by up to 2^-7 of itself: 2^-6 lr a step.
    lowp = ts.optimizer.moment_dtype == torch.bfloat16
    tol = dict(rtol=2.0 ** -7, floor=2.0 ** -8) if lowp else {}
    port_moments = []
    for moments, want in ((ts.optimizer.mu, j_mu), (ts.optimizer.nu, j_nu)):
        got = interop.flatten(interop.state_dict_to_flax(dict(zip(names, moments)))["params"])
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], f"adam moment {k}", **tol)
        port_moments.append(got)
    port = interop.state_dict_to_flax(ts.model.state_dict())
    want = interop.flatten({
        "params": jax.device_get(js.params), "brain": jax.device_get(js.brain),
        "stats_buffer": jax.device_get(js.stats_buffer),
    })
    got = interop.flatten(port)
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith(("neuron_assignments", "step_count")):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        elif k.startswith("params/"):
            name = k.removeprefix("params/")
            root_v = np.sqrt(np.maximum(
                np.asarray(j_nu[name], np.float64), port_moments[1][name]
            ))
            with np.errstate(divide="ignore"):
                step_err = np.minimum(2.0, 2e-5 * root_v.max() / root_v)
            slack[k] = slack.get(k, 0.0) + LR * (np.where(root_v > 0, step_err, 0.0) + 2.0 ** -6 * lowp)
            _close(got[k], want[k], k, extra=slack[k])
        else:
            _close(got[k], want[k], k)
    grad_want = interop.flatten(jax.device_get(js.grad_stats))
    grad_got = interop.flatten(interop.grad_stats_to_flax(ts.grad_stats))
    assert sorted(grad_got) == sorted(grad_want)
    for k in grad_want:
        _close(grad_got[k], grad_want[k], k)
    assert int(ts.grad_step_count) == int(js.grad_step_count)


@pytest.mark.parametrize("head_dim,moment_dtype", [
    (64, None), (64, "bfloat16"), (128, None),
])
def test_sensed_then_unsensed_step_match_jax(head_dim, moment_dtype):
    cfg, js, ts = both_states(head_dim, moment_dtype)
    b1, b2 = batch(1), batch(2)
    slack = {}

    js, jm = jstep.clip_train_step(js, {k: jnp.asarray(v) for k, v in b1.items()})
    ts, tm = tstep.clip_train_step(ts, {k: torch.from_numpy(v) for k, v in b1.items()})
    compare(js, ts, jm, tm, slack)
    assert int(ts.grad_step_count) == 1
    assert all(float(g.abs().sum()) > 0 for g in ts.grad_stats.values())

    js, jm = jstep.make_nosense_step(cfg)(js, {k: jnp.asarray(v) for k, v in b2.items()})
    ts, tm = tstep.make_nosense_step(ts.model.config)(
        ts, {k: torch.from_numpy(v) for k, v in b2.items()}
    )
    compare(js, ts, jm, tm, slack)
    assert int(ts.grad_step_count) == 1 and ts.step == 2


def _optax_chain(moment_dtype, lr):
    return jstate.make_optimizer(lr, WD, 1.0, moment_dtype=moment_dtype)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_matches_optax_chain(moment_dtype):
    """Three steps on random tensors: the first two with gradients whose
    global norm is below 1 (no clipping), the last above (clipped)."""
    rng = np.random.RandomState(7)
    shapes = [(5, 3), (7,), ()]
    params = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    tx = _optax_chain(moment_dtype, LR)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = tstate.make_optimizer(tp, LR, WD, 1.0, moment_dtype=moment_dtype)
    for scale in (0.05, 0.1, 5.0):
        grads = [np.asarray(rng.randn(*s) * scale, np.float32) for s in shapes]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step([torch.from_numpy(g) for g in grads])
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6
        )
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    if moment_dtype:
        assert all(m.dtype == torch.bfloat16 for m in opt.mu + opt.nu)


def test_weight_decay_reaches_every_parameter():
    p = torch.ones(3)
    opt = AdamW([p], learning_rate=0.1, weight_decay=0.5, grad_clip_norm=None)
    opt.step([torch.zeros(3)])
    torch.testing.assert_close(p, torch.full((3,), 1.0 - 0.1 * 0.5))


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=4),
    dict(warmup_steps=3, lr_schedule="cosine", decay_steps=6, min_lr_ratio=0.1),
    dict(lr_schedule="cosine", decay_steps=5),
    dict(),
])
def test_lr_schedule_matches_optax(kw):
    want = jstate.make_lr_schedule(LR, **kw)
    got = tstate.make_lr_schedule(LR, **kw)
    for step in range(12):
        w = float(want(step)) if callable(want) else want
        g = got(step) if callable(got) else got
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)


def test_first_step_lr_is_zero_with_warmup():
    p = torch.ones(2)
    opt = tstate.make_optimizer([p], 1.0, 0.0, warmup_steps=2)
    opt.step([torch.ones(2)])
    torch.testing.assert_close(p, torch.ones(2))
    opt.step([torch.ones(2)])
    assert float(p[0]) < 1.0


def test_taps_and_buffers_are_not_parameters():
    cfg, _, ts = both_states(64, None)
    names = {n for n, _ in ts.model.named_parameters()}
    assert not any(n.endswith(("act_stats", "step_count", "z_tap")) for n in names)
    assert len(ts.optimizer.params) == len(names)
    assert dataclasses.is_dataclass(ts)
