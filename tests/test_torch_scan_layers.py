"""The ``scan_layers`` layout in the port, mirroring tests/test_scan_layers.py:
the port's model stays unrolled, and every tree it writes or reads can be
in the JAX package's scanned layout (``layers/block/...`` leaves with a
leading (L,) axis).

* ``interop.stack_scan_layers`` inverts ``split_scan_layers`` on a JAX
  scanned model's variables exactly (leaf dtypes kept: fp32 params, an
  (L,) int32 ``step_count``), and ``state_dict_to_flax(scan_layers=True)``
  of the port's model holding them gives them back bit for bit;
* the port's scanned train state (EMA on) saved by ``save_train_state``:
  ``params.npz`` (``params``, ``ema_params``, ``stats_buffer``) and
  ``opt_state.npz`` (Adam's ``mu``/``nu``) hold the keys, shapes and dtypes
  of the JAX package's scanned state; ``restore_train_state`` reads it
  back bit for bit, and reads either layout into a state of the other;
* the LM loop with ``--scan_layers`` trains, saves a scanned checkpoint
  (``model_config.json`` says so), ``--resume``s from it (the restored
  state equal to the saved one bit for bit) and ``serve`` gives the same
  tokens as from an unrolled save of the same weights;
* ``--init_from`` a scanned base keeps the scanned layout (``--remat``
  still taken from the command line); ``--lora_rank`` over it trains
  adapters kept per layer, which its checkpoint writes keyed and shaped as
  the JAX package's over its scanned tree (``layers/block/.../lora_a`` of
  shape (L, in, r); ``checkpoint.relayout`` stacks any checkpoint's flat
  arrays), and ``serve`` merges them as the in-memory merge does;
* the LoRA repair: a JAX LoRA run (``forde_tpu.train.loop --init_from
  --lora_rank``) over a JAX ``--scan_layers`` base, the base converted by
  scripts/orbax_to_npz.py and the adapters written as the run saved them
  (stacked), loads in the port with logits within 1e-5 of JAX's
  ``load_lm_state`` (atol = rtol; fp32 through two layers); the whole
  LoRA run converted (merged) too.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.models.decoder_lm import FORDEDecoderLM as JaxLM
from forde_tpu.train import checkpoint as jckpt
from forde_tpu.train import ema as jema
from forde_tpu.train import lora as jlora
from forde_tpu.train import loop as jloop
from forde_tpu.train import state as jstate
from forde_tpu_torch import interop, serve
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.train import checkpoint as tckpt
from forde_tpu_torch.train import ema as tema
from forde_tpu_torch.train import loop
from forde_tpu_torch.train import state as tstate

from test_torch_clip_step import _adam_moments
from test_torch_decoder_lm import tiny_config, token_ids

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import orbax_to_npz  # noqa: E402

torch.set_num_threads(1)

LOOP = ["--device", "cpu", "--d_model", "32", "--num_layers", "2", "--num_heads", "2",
        "--num_experts", "2", "--window_size", "8", "--seq_len", "32", "--batch_size", "2",
        "--use_markov_data", "--slow_loop_interval", "0", "--log_interval", "1"]


def _jax_state(cfg, ema=True):
    js = jstate.create_train_state(cfg, jax.random.PRNGKey(0), 1e-3, 0.01, init_batch_shape=(1, 16))
    return jema.init_ema(js) if ema else js


def _port_state(jax_cfg, js, **kw):
    t_cfg = tcfg.config_from_dict(jcfg.config_to_dict(jax_cfg)).replace(**kw)
    model = FORDEDecoderLM(t_cfg)
    model.load_state_dict(interop.flax_to_state_dict(
        interop.split_scan_layers(jax.device_get(js.params)), {}, expected=model.state_dict(),
        stats_buffer=interop.split_scan_layers(jax.device_get(js.stats_buffer))))
    state = tstate.create_train_state(t_cfg, None, 1e-3, 0.01, model=model)
    tema.init_ema(state)
    return state


def _tensors(state):
    params, extra = tckpt._state_tensors(state)
    return {k: t for k, (t, _) in {**params, **extra}.items()}


def test_stack_inverts_split_on_jax_variables():
    cfg = tiny_config(scan_layers=True)
    variables = jax.device_get(JaxLM(config=cfg).init(jax.random.PRNGKey(0),
                                                      jnp.ones((1, 8), jnp.int32)))
    for collection in ("params", "stats_buffer"):
        tree = variables[collection]
        back = interop.flatten(interop.stack_scan_layers(interop.split_scan_layers(tree)))
        want = interop.flatten(tree)
        assert sorted(back) == sorted(want)
        for k, v in want.items():
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    assert interop.flatten(variables["stats_buffer"])[
        "layers/block/moe/step_count"].shape == (cfg.num_layers,)
    model = FORDEDecoderLM(tcfg.config_from_dict(jcfg.config_to_dict(cfg)))
    model.load_state_dict(interop.flax_to_state_dict(
        interop.split_scan_layers(variables["params"]), {}, expected=model.state_dict(),
        stats_buffer=interop.split_scan_layers(variables["stats_buffer"])))
    trees = interop.state_dict_to_flax(model.state_dict(), scan_layers=True)
    for collection in ("params", "stats_buffer"):
        got, want = interop.flatten(trees[collection]), interop.flatten(variables[collection])
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # a checkpoint's flat arrays, every collection at once
    unrolled = interop.flatten({c: interop.split_scan_layers(variables[c])
                                for c in ("params", "stats_buffer")})
    scanned = tckpt.relayout({**unrolled, "count": np.int32(3)}, True)
    want = interop.flatten({c: variables[c] for c in ("params", "stats_buffer")})
    assert sorted(scanned) == sorted([*want, "count"])
    for k, v in want.items():
        assert scanned[k].dtype == v.dtype and np.array_equal(scanned[k], v), k
    back = tckpt.relayout(scanned, False)
    assert sorted(back) == sorted([*unrolled, "count"])
    for k, v in unrolled.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_scanned_train_state_files_match_jax(tmp_path):
    cfg = tiny_config(scan_layers=True)
    js = _jax_state(cfg)
    state = _port_state(cfg, js)
    d = str(tmp_path / "ck")
    tckpt.save_train_state(d, state, 3, {})
    want = interop.flatten(jax.device_get({"params": js.params, "ema_params": js.ema_params,
                                           "stats_buffer": js.stats_buffer}))
    mu, nu = _adam_moments(js.opt_state)
    want_opt = interop.flatten(jax.device_get({"mu": mu, "nu": nu}))
    for name, expected in (("params.npz", want), ("opt_state.npz", want_opt)):
        with np.load(os.path.join(d, name)) as z:
            got = {k: z[k] for k in z.files if k not in ("count", "step")}
        assert sorted(got) == sorted(expected), name
        for k, v in expected.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, (k, got[k].shape, v.shape)
    with np.load(os.path.join(d, "params.npz")) as z:
        for k in ("params", "stats_buffer"):
            for path, v in interop.flatten({k: jax.device_get(getattr(js, k))}).items():
                assert np.array_equal(z[path], v), path
    with open(os.path.join(d, "model_config.json")) as f:
        assert json.load(f)["model"]["scan_layers"] is True

    fresh = _port_state(cfg, _jax_state(cfg.replace(), ema=True))
    for t in fresh.optimizer.params + fresh.ema:
        t.data.add_(1.0)
    tckpt.restore_train_state(d, fresh)
    a, b = _tensors(state), _tensors(fresh)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert fresh.step == 3
    # either layout into a state of the other
    unrolled = _port_state(cfg, js, scan_layers=False)
    tckpt.restore_train_state(d, unrolled)
    c = _tensors(unrolled)
    for k in a:
        assert torch.equal(a[k], c[k]), k
    flat = str(tmp_path / "flat")
    tckpt.save_train_state(flat, unrolled, 3, {})
    with np.load(os.path.join(flat, "params.npz")) as z:
        assert "params/layer_1/attn_norm/scale" in z.files
    tckpt.restore_train_state(flat, fresh)
    for k, t in _tensors(fresh).items():
        assert torch.equal(a[k], t), k


def test_scan_layers_cli_trains_resumes_and_serves(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck")
    out = loop.main(LOOP + ["--scan_layers", "--ema_decay", "0.9", "--steps_per_epoch", "2",
                            "--checkpoint_dir", ck])
    assert out["step"] == 2 and np.isfinite(out["final_metrics"]["loss/total"])
    cfg, meta = tckpt.load_meta(ck)
    assert cfg.scan_layers and meta["step"] == 2
    with np.load(os.path.join(ck, "opt_state.npz")) as z:
        assert any(k.startswith("mu/layers/block/") for k in z.files)
        assert not any("layer_0" in k for k in z.files)
    trained = _tensors(out["state"])
    fresh = loop.main(LOOP + ["--scan_layers", "--ema_decay", "0.9", "--steps_per_epoch", "0"])
    tckpt.restore_train_state(ck, fresh["state"])
    for k, t in _tensors(fresh["state"]).items():
        assert torch.equal(trained[k], t), k
    resumed = loop.main(LOOP + ["--scan_layers", "--ema_decay", "0.9", "--steps_per_epoch", "3",
                                "--checkpoint_dir", ck, "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["step"] == 3 and tckpt.load_meta(ck)[1]["step"] == 3

    unrolled = str(tmp_path / "unrolled")
    model = resumed["state"].model
    tckpt.save_params(unrolled, model.config.replace(scan_layers=False),
                      interop.flatten(interop.state_dict_to_flax(model.state_dict())),
                      {"step": 3})
    with np.load(os.path.join(unrolled, "params.npz")) as z:
        assert "params/layer_0/attn_norm/scale" in z.files
    rows = {}
    for name, d in (("scanned", ck), ("unrolled", unrolled)):
        rows[name] = serve.main(["--device", "cpu", "--checkpoint_dir", d, "--prompt_ids",
                                 "5,17,200,9,31", "--max_new_tokens", "6", "--temperature", "0"])
    assert rows["scanned"] == rows["unrolled"]
    for name, d in (("scanned", ck), ("unrolled", unrolled)):
        _, m = tckpt.load_lm_params(d, "cpu")
        with torch.no_grad():
            rows[name] = m(torch.from_numpy(token_ids(2, 24)))[0]
    assert torch.equal(rows["scanned"], rows["unrolled"])


def test_init_from_scanned_base_keeps_layout_and_lora(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = str(tmp_path / "base")
    loop.main(LOOP + ["--scan_layers", "--steps_per_epoch", "1", "--checkpoint_dir", base])
    warm = str(tmp_path / "warm")
    out = loop.main(LOOP + ["--init_from", base, "--remat", "--steps_per_epoch", "1",
                            "--checkpoint_dir", warm])
    assert out["state"].model.config.remat and out["state"].model.config.scan_layers
    cfg, _ = tckpt.load_meta(warm)
    assert cfg.scan_layers and cfg.remat
    with np.load(os.path.join(warm, "params.npz")) as z:
        assert "params/layers/block/attn_norm/scale" in z.files

    lora_dir = str(tmp_path / "lora")
    out = loop.main(LOOP + ["--init_from", base, "--lora_rank", "4", "--steps_per_epoch", "2",
                            "--checkpoint_dir", lora_dir])
    _, base_model = tckpt.load_lm_params(base, "cpu")
    variables = {"params": interop.state_dict_to_flax(base_model.state_dict(),
                                                      scan_layers=True)["params"]}
    want = {k: v.shape for k, v in interop.flatten(jlora.init_lora(
        variables["params"], 4, jax.random.PRNGKey(0))).items()}
    # kept per layer, as the model's parameters are; stacked as JAX's on save
    lora_tensors = out["state"].lora.tensors
    assert all(k.startswith("layer_") for k in lora_tensors)
    got = {k[len("params/"):]: v.shape for k, v in tckpt.relayout(
        {f"params/{k}": t.detach().numpy() for k, t in lora_tensors.items()}, True).items()}
    assert got == want and all(k.startswith("layers/block/") for k in got)
    with np.load(os.path.join(lora_dir, "params.npz")) as z:
        saved = {k[len("params/"):]: z[k].shape for k in z.files if k.startswith("params/")}
    assert saved == want
    assert any(float(t.detach().abs().sum()) > 0 for k, t in out["state"].lora.tensors.items()
               if k.endswith("lora_b"))
    from forde_tpu_torch.train import lora as tlora

    state = out["state"]
    merged = tlora.merge_lora(state.model, state.lora, tlora.lora_scale(4, 16.0))
    ids = torch.from_numpy(token_ids(2, 24))
    with torch.no_grad():
        want_logits, _ = torch.func.functional_call(state.model, merged, (ids,), strict=False)
        _, served = tckpt.load_lm_params(lora_dir, "cpu")
        got_logits, _ = served(ids)
    torch.testing.assert_close(got_logits, want_logits, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_lora_over_scanned(tmp_path_factory):
    """A JAX --scan_layers run and a JAX LoRA run over it (Orbax)."""
    tmp = tmp_path_factory.mktemp("scanned_lora")
    flags = ["--use_dummy_data", "--steps_per_epoch", "2", "--num_epochs", "1",
             "--batch_size", "2", "--seq_len", "32", "--d_model", "32", "--num_layers", "2",
             "--num_heads", "2", "--num_experts", "2", "--window_size", "8",
             "--slow_loop_interval", "0", "--log_interval", "1", "--plots_dir", ""]
    base, lora_dir = str(tmp / "base"), str(tmp / "lora")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        jloop.train(jloop.build_parser().parse_args(
            flags + ["--scan_layers", "--checkpoint_dir", base]))
        jloop.train(jloop.build_parser().parse_args(
            flags + ["--init_from", base, "--lora_rank", "4", "--learning_rate", "1e-2",
                     "--checkpoint_dir", lora_dir]))
    return tmp, base, lora_dir


def _jax_adapters(base, lora_dir):
    """The LoRA run's adapters and stat buffers as it saved them (the
    restore of ``load_lm_state``'s LoRA branch, without its merge)."""
    meta = jckpt.load_train_meta(lora_dir)
    config, base_params, base_stats = jckpt.load_lm_params(base)
    lora = meta["lora"]
    adapters = jlora.init_lora(base_params, int(lora["rank"]), jax.random.PRNGKey(0),
                               targets=tuple(lora["targets"]))
    state = jstate.TrainState.create(
        apply_fn=JaxLM(config=config).apply, params=adapters,
        tx=jstate.make_optimizer(1e-4, 0.0, **jckpt._optimizer_meta(meta)),
        stats_buffer=base_stats)
    state = jckpt.restore_checkpoint(lora_dir, state)
    return config, meta, jax.device_get(state.params), jax.device_get(state.stats_buffer)


@pytest.mark.parametrize("how", ["adapters", "merged"])
def test_lora_over_a_scanned_jax_base_loads(jax_lora_over_scanned, how):
    tmp, base, lora_dir = jax_lora_over_scanned
    config, state = jckpt.load_lm_state(lora_dir)
    ids = token_ids(2, 24, vocab=50257, seed=3)
    (want, _), _ = JaxLM(config=config).apply(
        {"params": state.params, "stats_buffer": state.stats_buffer}, jnp.asarray(ids),
        mutable=["stats_buffer"])
    dst = str(tmp / f"port_{how}")
    if how == "merged":
        orbax_to_npz.convert(lora_dir, dst)
    else:
        port_base = str(tmp / "port_base")
        orbax_to_npz.convert(base, port_base)
        config, meta, adapters, stats = _jax_adapters(base, lora_dir)
        assert adapters["layers"]["block"]["sparse_attention"]["local_attention"]["qkv_proj"][
            "kernel"]["lora_a"].shape[0] == config.num_layers
        meta["lora"]["base"] = port_base
        orbax_to_npz.write_checkpoint(dst, config, {"params": adapters, "stats_buffer": stats},
                                      meta)
    cfg, _ = tckpt.load_meta(dst)
    assert cfg.scan_layers
    _, model = tckpt.load_lm_params(dst, "cpu")
    with torch.no_grad():
        got, _ = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    sd = interop.state_dict_to_flax(model.state_dict(), scan_layers=True)
    for path, v in interop.flatten(jax.device_get(state.stats_buffer)).items():
        assert np.array_equal(interop.flatten(sd["stats_buffer"])[path], v), path
