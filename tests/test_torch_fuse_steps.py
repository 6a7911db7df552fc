"""Fused multi-step training in the port (forde_tpu_torch.train.clip_step.
make_fused_step), mirroring tests/test_fuse_steps.py:

* a fused call of k steps equals k eager port steps in the unfused loop's
  order (sensed at offsets 0, s, 2s, ...) bit for bit: params, stat
  buffers, Adam moments and count, gradient stats, step counts, metrics;
* against the JAX package's ``make_fused_step`` on the same numpy weights
  and batches: the change of the weights within bars that a call missing
  half of its steps fails, the loss, step counts exactly;
* the misaligned stride's ValueError, ``stack_batches`` dropping a partial
  tail;
* the device-side Adam count, bias corrections and LR against optax's
  schedules and numpy's bias corrections for counts 1 to 1,000
  (constant, warmup, cosine);
* the clip_loop CLI with ``--fuse_steps 2`` on the CPU, its cadences
  rounded up to fuse boundaries.

The small config of test_torch_clip_step.py (2 + 2 layers, d 128, head_dim
64, image 32, text 16, fp32); the JAX side runs its kernels in interpret
mode, the port its kernels' plain versions.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.train import clip_step as jstep
from forde_tpu.train import state as jstate
from forde_tpu_torch import interop
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.models.dual_encoder import FORDEDualEncoder
from forde_tpu_torch.train import clip_loop
from forde_tpu_torch.train import clip_step as tstep
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train.optim import AdamW

from test_torch_clip_step import B, LR, S_TEXT, WD, batch, both_states, small_config

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_moments(monkeypatch):
    monkeypatch.setenv("FORDE_MOMENT_IMPL", "interpret")


def _batches(k, seed=10):
    return [batch(seed + i) for i in range(k)]


def _torch_stack(batches):
    (stacked,) = list(tstep.stack_batches(
        iter([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]), len(batches)))
    return stacked


def _eager(ts, batches, stride):
    nosense = tstep.make_nosense_step(ts.model.config)
    metrics = None
    for i, b in enumerate(batches):
        step = tstep.clip_train_step if i % stride == 0 else nosense
        ts, metrics = step(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    return metrics


def _port_tree(ts):
    """Every tensor the steps write, by name."""
    opt = ts.optimizer
    names = [n for n, _ in ts.model.named_parameters()]
    out = {f"state/{k}": v for k, v in ts.model.state_dict().items()}
    out.update({f"mu/{n}": m for n, m in zip(names, opt.mu)})
    out.update({f"nu/{n}": v for n, v in zip(names, opt.nu)})
    out.update({f"grad_stats/{k}": v for k, v in ts.grad_stats.items()})
    out["count"], out["grad_step_count"] = opt.count, ts.grad_step_count
    return out


@pytest.mark.parametrize("k,stride", [(2, 1), (2, 2), (4, 2)])
def test_fused_equals_eager_port_steps_bit_for_bit(k, stride):
    _, _, ref = both_states(64, None)
    _, _, fus = both_states(64, None)
    batches = _batches(k)
    ref_m = _eager(ref, batches, stride)
    fused = tstep.make_fused_step(fus.model.config, k, stride)
    fus, m = fused(fus, fused.prepare(_torch_stack(batches)))
    assert fus.step == ref.step == k
    got, want = _port_tree(fus), _port_tree(ref)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert int(fus.grad_step_count) == k // stride and int(fus.optimizer.count) == k
    assert sorted(m) == sorted(ref_m)
    for key in ref_m:
        assert torch.equal(m[key], ref_m[key]), key


def _fresh_states():
    """A fresh JAX train state (every neuron of type 0, as
    tests/test_fuse_steps.py makes it) and the port's state holding it."""
    cfg = small_config(64)
    js = jstep.create_clip_train_state(
        cfg, jax.random.PRNGKey(0), LR, WD, batch_size=B, text_len=S_TEXT)
    t_cfg = tcfg.config_from_dict(jcfg.config_to_dict(cfg)).replace(attention_kernel_impl="auto")
    model = FORDEDualEncoder(t_cfg)
    model.load_state_dict(interop.flax_to_state_dict(
        jax.device_get(js.params), jax.device_get(js.brain), expected=model.state_dict(),
        stats_buffer=jax.device_get(js.stats_buffer),
    ))
    ts = tstep.create_clip_train_state(t_cfg, None, LR, WD, model=model)
    ts.grad_stats = interop.grad_stats_from_flax(jax.device_get(js.grad_stats))
    return cfg, js, ts


# Bars on the change of the weights, port against JAX: the largest
# difference of one weight's change, and the relative L2 of the difference
# over every weight. Measured 1.1e-4 / 3.2e-4 at k = 2 and 1.5e-4 / 3.9e-4
# at k = 4. One Adam step moves a weight by about LR = 1e-3, so a call that
# skipped a step is ~LR off on most weights and ~1/k off in relative L2.
UPDATE_ATOL, UPDATE_REL_L2 = 5e-4, 2e-3


def _update_gaps(p0, got, want):
    """The largest |Δgot - Δwant| over every weight and the relative L2 of
    Δgot - Δwant over all of them, Δ being the change from ``p0``."""
    worst = num = den = 0.0
    for name, w in want.items():
        d_want = np.asarray(w, np.float64) - p0[name]
        d_got = np.asarray(got[name], np.float64) - p0[name]
        worst = max(worst, float(np.abs(d_got - d_want).max()))
        num += float(np.sum((d_got - d_want) ** 2))
        den += float(np.sum(d_want ** 2))
    return worst, (num / den) ** 0.5


def _port_params(ts):
    flat = interop.flatten(interop.state_dict_to_flax(ts.model.state_dict()))
    return {n[len("params/"):]: v for n, v in flat.items() if n.startswith("params/")}


@pytest.mark.parametrize("k,stride", [(2, 1), (2, 2), (4, 2)])
def test_fused_matches_jax_make_fused_step(k, stride):
    """The JAX test's one-group bar on params (2e-6) holds its fused call
    to its own unfused steps, whose float ops are the same; the port holds
    its fused call to its eager steps bit for bit (above). Across the two
    packages each step differs by rounding (~1e-7 relative in the
    gradients), which Adam turns into up to ~LR on weights whose gradient
    is rounding noise (the key part of the qkv bias, to which softmax is
    blind: relative L2 of its change up to 1.4e-2). So the port's change of
    the weights is held to JAX's by UPDATE_ATOL and UPDATE_REL_L2, which
    the untouched state and the state after k/2 of the steps both fail
    (checked here); the loss to 1e-5 at k = 2 (the JAX test's one-group
    bar; measured 2.1e-6) and 1e-4 at k = 4 (measured 1.9e-5; that test's
    several-group bar is 1e-3); the stat buffers' counts, the
    gradient-stat count and the step exactly."""
    cfg, js, ts = _fresh_states()
    p0 = {n: np.asarray(v, np.float64) for n, v in interop.flatten(jax.device_get(js.params)).items()}
    half = copy.deepcopy(ts)
    batches = _batches(k, seed=20)
    nosense = jstep.make_nosense_step(cfg) if stride > 1 else None
    jfused = jstep.make_fused_step(cfg, k, stride, nosense_step=nosense)
    (jstacked,) = list(jstep.stack_batches(
        iter([{kk: jnp.asarray(v) for kk, v in b.items()} for b in batches]), k))
    js, jm = jfused(js, jfused.prepare(jstacked))
    tfused = tstep.make_fused_step(ts.model.config, k, stride)
    ts, tm = tfused(ts, tfused.prepare(_torch_stack(batches)))

    port = _port_params(ts)
    want = interop.flatten(jax.device_get(js.params))
    assert sorted(port) == sorted(want)
    worst, rel = _update_gaps(p0, port, want)
    assert worst <= UPDATE_ATOL and rel <= UPDATE_REL_L2, (worst, rel)
    _eager(half, batches[: k // 2], stride)
    assert half.step == k // 2
    for wrong in (p0, _port_params(half)):
        worst, rel = _update_gaps(p0, wrong, want)
        assert worst > UPDATE_ATOL and rel > UPDATE_REL_L2, (worst, rel)

    flat = interop.flatten(interop.state_dict_to_flax(ts.model.state_dict()))
    counts = interop.flatten(jax.device_get(js.stats_buffer))
    for name, c in counts.items():
        if name.endswith("step_count"):
            np.testing.assert_array_equal(flat[f"stats_buffer/{name}"], np.asarray(c), name)
    assert int(ts.grad_step_count) == int(js.grad_step_count) == k // stride
    assert ts.step == int(js.step) == k
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(float(tm["loss/contrastive"]), float(jm["loss/contrastive"]),
                               atol=1e-5 if k == 2 else 1e-4, rtol=0)


def test_fused_rejects_misaligned_stride():
    cfg, _, _ = both_states(64, None)
    with pytest.raises(ValueError, match="multiple of"):
        tstep.make_fused_step(cfg, 3, 2)
    with pytest.raises(ValueError, match="positive"):
        tstep.make_fused_step(cfg, 0, 1)


def test_stack_batches_drops_partial_tail():
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches(5)]
    stacked = list(tstep.stack_batches(iter(batches), 2))
    assert len(stacked) == 2
    assert stacked[0]["image"].shape[0] == 2
    assert torch.equal(stacked[1]["input_ids"][1], batches[3]["input_ids"])
    with pytest.raises(NotImplementedError, match="multi-device"):
        next(tstep.stack_batches(iter(batches), 2, sharding="data"))


SCHEDULES = {
    "constant": dict(),
    "warmup": dict(warmup_steps=100),
    "cosine": dict(lr_schedule="cosine", decay_steps=700, min_lr_ratio=0.1),
    "warmup_cosine": dict(warmup_steps=50, lr_schedule="cosine", decay_steps=600),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_device_count_bias_corrections_and_lr_match_host_formulas(name):
    """The optimizer's int32 count after n steps is n, and the LR it reads
    is the schedule's ``at`` of the count before the step. The fp32 LR at
    counts 0 to 1,000 is within 1 fp32 ulp of the peak LR of optax's fp32
    schedule (its cos; the warmup is equal exactly), and the schedule
    called with an int gives the same value. The fp32 bias corrections 1 - b^n, n = 1 to 1,000,
    equal numpy's float32 formula within 2 ulps of b^n: torch's and
    numpy's pow differ by at most 1 ulp of b^n at a few counts, and the
    subtraction's rounding can double that."""
    kw = SCHEDULES[name]
    lr = tstate.make_lr_schedule(LR, **kw)
    counts = torch.arange(0, 1001, dtype=torch.int32)
    peak_ulp = float(np.spacing(np.float32(LR)))
    if isinstance(lr, float):
        assert lr == LR
    else:
        got = lr.at(counts).numpy()
        assert got.dtype == np.float32
        assert [lr(int(c)) for c in counts[::37]] == got[::37].tolist()
        optax_lr = np.asarray(jstate.make_lr_schedule(LR, **kw)(jnp.asarray(counts.numpy())))
        assert np.abs(got.astype(np.float64) - optax_lr).max() <= peak_ulp

    p = torch.zeros(3)
    opt = AdamW([p], lr, weight_decay=0.0, grad_clip_norm=None)
    for n in range(1, 1001):
        opt.count.fill_(n - 1)
        p.zero_()
        opt.step([torch.ones(3)])
        assert opt.count.dtype == torch.int32 and int(opt.count) == n
        if n in (1, 2, 500, 1000):
            # A constant gradient: m_hat = v_hat = 1, so the step is lr / (1 + eps),
            # up to the fp32 bias correction 1 - 0.999^n, which cancellation
            # leaves ~3e-5 relative at n = 2.
            want = LR if isinstance(lr, float) else float(lr.at(torch.tensor(n - 1, dtype=torch.int32)))
            np.testing.assert_allclose(-p.numpy(), want / (1 + 1e-8), rtol=1e-4, atol=1e-12)
    t = torch.arange(1, 1001, dtype=torch.float32)
    for b in (AdamW.b1, AdamW.b2):
        dev = (1.0 - torch.pow(b, t)).numpy()
        power = np.float32(b) ** np.arange(1, 1001, dtype=np.float32)
        host = np.float32(1.0) - power
        assert (np.abs(dev - host) <= 2 * np.spacing(power)).all()


def test_clip_loop_fuse_steps_rounds_cadences(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = clip_loop.main([
        "--device", "cpu", "--preset", "custom", "--tower_layers", "2", "--tower_dim", "128",
        "--image_size", "32", "--text_len", "16", "--use_dummy_data", "--dummy_pool", "3",
        "--batch_size", "4", "--num_steps", "6", "--fuse_steps", "2", "--sense_interval", "2",
        "--log_interval", "3", "--slow_loop_interval", "3", "--forde_lite",
    ])
    printed = capsys.readouterr().out
    assert "--log_interval 3 -> 4 (rounded to a --fuse_steps boundary)" in printed
    assert "--slow_loop_interval 3 -> 4 (rounded to a --fuse_steps boundary)" in printed
    assert out["step"] == 6 and np.isfinite(out["final_metrics"]["loss/contrastive"])
    assert [u["step"] for u in out["brain_updates"]] == [4]
    # two sensed steps (offsets 0 and 2) of the 4 before the update
    n_layers = 2 + 2
    assert out["brain_updates"][0]["sensed_steps_before"] == 2 * n_layers
    assert int(out["state"].optimizer.count) == 6


def test_clip_loop_fuse_steps_must_be_a_multiple_of_the_stride(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="multiple of --sense_interval"):
        clip_loop.main(["--device", "cpu", "--use_dummy_data", "--num_steps", "4",
                        "--fuse_steps", "3", "--sense_interval", "2"])
