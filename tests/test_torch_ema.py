"""The port's EMA of the parameters (forde_tpu_torch.train.ema), mirroring
tests/test_ema.py:

* ``with_ema`` against the JAX package's on carried weights: both wrap a
  step that sets the parameters to the same numpy values, from the same
  EMA; the new EMA within 1e-6 relative (the same fp32 formula,
  ``e * decay + p * (1 - decay)``; the port adds ``(1 - decay) * p`` in one
  ``_foreach_add_``). Around the real ``train_step`` the EMA equals the
  formula on the parameters before and after the step (1e-6, as the JAX
  test holds it), and covers the parameters only (no stat buffer);
* ``swap_in_ema`` gives the EMA weights inside its block and the live
  ones, bit for bit and in the same storage, after it;
* the LM loop with ``--ema_decay``: its checkpoint's ``ema_params`` are
  the run's EMA exactly, ``serve --use_ema`` and ``eval_lm --use_ema``
  load them; the clip loop with ``--ema_decay``: the EMA moved, stays
  near the params, and ``embed --use_ema`` embeds with it;
* the fused k-step graph path with EMA rehearsed on the CPU
  (``graphs.on_card`` and ``graphs.StepGraph`` patched, as
  tests/test_torch_decode_pool.py does): the EMA tensors keep their
  storage across calls, fused equals eager bit for bit, and a state whose
  EMA moved to new storage is captured anew.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from forde_tpu.train import ema as jema
from forde_tpu.train import state as jstate
from forde_tpu_torch import embed, interop, serve
from forde_tpu_torch.core import graphs
from forde_tpu_torch.train import checkpoint as tckpt
from forde_tpu_torch.train import clip_loop, clip_step, loop
from forde_tpu_torch.train import ema as tema
from forde_tpu_torch.train import state as tstate
from forde_tpu_torch.train.step import train_step

from test_torch_clip_step import both_states
from test_torch_decoder_lm import port_model, tiny_config

torch.set_num_threads(1)

DECAY = 0.9
TINY_LM = ["--d_model", "32", "--num_layers", "1", "--num_heads", "2", "--num_experts", "2",
           "--window_size", "8", "--seq_len", "32", "--batch_size", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _interpret_moments(monkeypatch):
    monkeypatch.setenv("FORDE_MOMENT_IMPL", "interpret")


def _lm_states():
    """A JAX LM train state (dense, no MoE) and the port's holding its
    weights, each with an EMA seeded from the params."""
    cfg = tiny_config(use_moe=False, use_sparse_attention=False)
    js = jema.init_ema(jstate.create_train_state(
        cfg, jax.random.PRNGKey(0), 1e-2, 0.0, init_batch_shape=(1, 16)))
    model = port_model(cfg, jax.device_get({"params": js.params}))
    ts = tema.init_ema(tstate.create_train_state(model.config, None, 1e-2, 0.0, model=model))
    return js, ts


def _port_flat(ts, tensors):
    names = [n for n, _ in ts.model.named_parameters()]
    return interop.flatten(interop.state_dict_to_flax(dict(zip(names, tensors)))["params"])


def test_with_ema_matches_jax_on_carried_weights():
    js, ts = _lm_states()
    rng = np.random.RandomState(1)
    p1 = jax.tree.map(lambda a: (np.asarray(a) + rng.randn(*a.shape) * 0.1).astype(np.float32),
                      jax.device_get(js.params))
    want = jema.with_ema(lambda s, b: (s.replace(params=p1), {}), DECAY)(js, {})[0]
    flat1 = interop.flatten(p1)

    def set_params(state, batch):
        keys = interop.flax_keys(n for n, _ in state.model.named_parameters())
        with torch.no_grad():
            for (key, transposed), p in zip(keys.values(), state.optimizer.params):
                value = torch.from_numpy(flat1[key[len("params/"):]])
                p.copy_(value.T if transposed else value)
        return state, {}

    ts, _ = tema.with_ema(set_params, DECAY)(ts, {})
    got = _port_flat(ts, ts.ema)
    ref = interop.flatten(jax.device_get(want.ema_params))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_with_ema_one_step_math_and_swap():
    _, ts = _lm_states()
    p0 = [p.detach().clone() for p in ts.optimizer.params]
    ptrs = [e.data_ptr() for e in ts.ema]
    batch = {"input_ids": torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int32))}
    step = tema.with_ema(lambda s, b: train_step(s, b, aux_loss_weight=0.0), DECAY)
    ts, _ = step(ts, batch)
    assert [e.data_ptr() for e in ts.ema] == ptrs
    assert len(ts.ema) == len(list(ts.model.parameters()))
    for a, e, p in zip(p0, ts.ema, ts.optimizer.params):
        np.testing.assert_allclose(e.numpy(), DECAY * a.numpy() + (1 - DECAY) * p.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    live = [p.detach().clone() for p in ts.optimizer.params]
    storage = [p.data_ptr() for p in ts.optimizer.params]
    with tema.swap_in_ema(ts):
        assert all(torch.equal(p, e) for p, e in zip(ts.optimizer.params, ts.ema))
    assert all(torch.equal(p, q) for p, q in zip(ts.optimizer.params, live))
    assert [p.data_ptr() for p in ts.optimizer.params] == storage
    ts.ema = None
    with pytest.raises(ValueError, match="EMA not enabled"):
        with tema.swap_in_ema(ts):
            pass


def test_lm_loop_ema_checkpoint_serve_and_eval(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    out = loop.main(TINY_LM + ["--use_dummy_data", "--steps_per_epoch", "2", "--log_interval",
                               "1", "--slow_loop_interval", "0", "--ema_decay", "0.99",
                               "--checkpoint_dir", ckpt])
    state = out["state"]
    _, ema_model = tckpt.load_lm_params(ckpt, "cpu", use_ema=True)
    for (name, p), e in zip(ema_model.named_parameters(), state.ema):
        assert torch.equal(p, e), name
    assert any(not torch.equal(e, p) for e, p in zip(state.ema, state.optimizer.params))
    rows = serve.main(["--checkpoint_dir", ckpt, "--use_ema", "--prompt_ids", "5,17,20",
                       "--max_new_tokens", "3", "--temperature", "0", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "serving EMA weights" in printed
    assert rows[0][:3] == [5, 17, 20] and len(rows[0]) == 6

    from forde_tpu_torch import eval_lm

    argv = ["--checkpoint_dir", ckpt, "--use_dummy_data", "--seq_len", "32", "--batch_size",
            "2", "--num_batches", "2", "--device", "cpu"]
    live, ema = eval_lm.main(argv), eval_lm.main(argv + ["--use_ema"])
    assert "evaluating EMA weights" in capsys.readouterr().out
    assert live["lm_loss"] != ema["lm_loss"]


def test_clip_loop_ema_and_embed_use_ema(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    out = clip_loop.main([
        "--device", "cpu", "--preset", "tiny", "--use_dummy_data", "--batch_size", "2",
        "--num_steps", "3", "--log_interval", "1", "--slow_loop_interval", "0",
        "--ema_decay", "0.9", "--sense_interval", "2", "--checkpoint_dir", ckpt,
    ])
    state = out["state"]
    assert out["step"] == 3 and state.ema is not None
    d = [float((e - p.detach()).abs().max()) for e, p in zip(state.ema, state.optimizer.params)]
    assert max(d) > 0 and max(d) < 0.1
    _, ema_model = tckpt.load_clip_params(ckpt, "cpu", use_ema=True)
    for (name, p), e in zip(ema_model.named_parameters(), state.ema):
        assert torch.equal(p, e), name
    texts = "12,99,407;7,5"
    embed.main(["--checkpoint_dir", ckpt, "--text_ids", texts, "--device", "cpu",
                "--out", str(tmp_path / "live")])
    embed.main(["--checkpoint_dir", ckpt, "--text_ids", texts, "--device", "cpu", "--use_ema",
                "--out", str(tmp_path / "ema")])
    assert "using EMA weights" in capsys.readouterr().out
    ids, mask = embed._load_texts(texts, ema_model.config.max_text_len)
    with torch.no_grad():
        want = ema_model.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "ema_text.npy"), want)
    assert not np.array_equal(np.load(tmp_path / "live_text.npy"), want)


class _FakeStepGraph:
    """StepGraph without CUDA: the warm-up runs the step, the capture runs
    nothing, each replay runs the step again."""

    made = []

    def __init__(self, step, generators=()):
        _FakeStepGraph.made.append(self)
        self.step = step
        self.warmup_outputs = step()

    def replay(self):
        return self.step()


def _batches(n, seed):
    from test_torch_clip_step import batch

    return [{k: torch.from_numpy(v) for k, v in batch(seed + i).items()} for i in range(n)]


def test_fused_steps_with_ema_rehearsed_graph(monkeypatch):
    _FakeStepGraph.made = []
    monkeypatch.setattr(graphs, "on_card", lambda t: True)
    monkeypatch.setattr(graphs, "StepGraph", _FakeStepGraph)
    k, stride = 2, 2
    _, _, fus = both_states(64, None)
    ref = copy.deepcopy(fus)
    for s in (fus, ref):
        tema.init_ema(s)
    sensed = tema.with_ema(clip_step.clip_train_step, DECAY)
    nosense = tema.with_ema(clip_step.make_nosense_step(fus.model.config), DECAY)
    fused = clip_step.make_fused_step(fus.model.config, k, stride, sensed_step=sensed,
                                      nosense_step=nosense)
    ptrs = [e.data_ptr() for e in fus.ema]
    calls = [_batches(k, 10), _batches(k, 20)]
    for batches in calls:
        stacked = next(clip_step.stack_batches(iter(batches), k))
        fus, m = fused(fus, fused.prepare(stacked))
        assert [e.data_ptr() for e in fus.ema] == ptrs
        for i, b in enumerate(batches):
            ref, want = (sensed if i % stride == 0 else nosense)(ref, b)
    assert len(_FakeStepGraph.made) == 1  # captured once, replayed once
    assert fus.step == ref.step == 2 * k
    for e, w in zip(fus.ema, ref.ema):
        assert torch.equal(e, w)
    for p, w in zip(fus.optimizer.params, ref.optimizer.params):
        assert torch.equal(p, w)
    for key in want:
        assert torch.equal(m[key], want[key]), key
    # an EMA in new storage is another graph key: the next call captures anew
    fus.ema = [e.clone() for e in fus.ema]
    fused(fus, fused.prepare(next(clip_step.stack_batches(iter(_batches(k, 30)), k))))
    assert len(_FakeStepGraph.made) == 2
