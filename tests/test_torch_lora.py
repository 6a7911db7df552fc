"""LoRA in the port (forde_tpu_torch.train.lora), mirroring tests/test_lora.py
and held to the JAX package's train/lora.py:

* the merge is the identity at init (B = 0): the merged model's logits
  equal the base's exactly;
* the targets cover the same leaves as the JAX package's ``init_lora`` on
  the same weights, with the same adapter shapes: the default attention
  projections (the fused ``qkv_proj`` and ``out_proj``, the NSA branches'
  ``compressed_*``/``topk_*`` projections by the end of their names) and
  the stacked expert banks (E, in, r); an unknown target raises;
* one ``make_lora_train_step`` against the JAX package's with its adapters
  carried across as numpy (``lora_b`` made non-zero, so both factors get
  gradients): metrics and both Adam moments within the tolerances of
  tests/test_torch_lm_train.py, and the adapters after the step within
  1e-5 relative plus Adam's per-element slack (lr times the difference of
  the two updates the compared moments give, as there); the base
  bit-identical after the step; the stat buffers advance;
* the adapter count equals the JAX package's and is a small share of the
  base;
* the CLI: a base trained by the LM loop, ``--init_from --lora_rank``
  over it (with EMA), the checkpoint's params are the adapters, and
  ``serve`` from it decodes as the in-memory merged model does; the
  refusals (``--init_from`` required, the slow loop, ``--grad_accum``,
  ``--distill_from``); a warm start without LoRA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.train import lora as jlora
from forde_tpu_torch import interop, serve
from forde_tpu_torch.models import generate
from forde_tpu_torch.train import checkpoint as tckpt
from forde_tpu_torch.train import lora as tlora
from forde_tpu_torch.train import loop

from test_torch_clip_step import _adam_moments, _close
from test_torch_decoder_lm import jax_variables, port_model, tiny_config, token_ids
from test_torch_lm_train import both_states, small_config

torch.set_num_threads(1)

LR, AUX, RANK, ALPHA = 1e-3, 0.01, 4, 8.0


def _adapter_flat(adapters):
    return {k: np.asarray(v) for k, v in interop.flatten(jax.device_get(adapters)).items()}


@pytest.mark.parametrize("targets", [jlora.DEFAULT_TARGETS, ("w_up", "w_down")])
def test_targets_match_jax(targets):
    cfg = tiny_config()
    _, variables = jax_variables(cfg)
    want = _adapter_flat(jlora.init_lora(variables["params"], 2, jax.random.PRNGKey(1),
                                         targets=targets))
    model = port_model(cfg, variables)
    got = tlora.init_lora(model, 2, torch.Generator().manual_seed(0), targets)
    assert sorted(got.tensors) == sorted(want)
    for k, v in want.items():
        assert tuple(got.tensors[k].shape) == v.shape, k
        assert got.tensors[k].requires_grad
    mods = {k.split("/")[-3] for k in want}
    if targets == jlora.DEFAULT_TARGETS:
        assert {"qkv_proj", "out_proj", "compressed_k_proj", "topk_v_proj",
                "compressed_out_proj", "topk_out_proj"} <= mods
    else:
        assert got.tensors["layer_0/moe/moe_layer/experts/w_up/lora_a"].shape == (4, 32, 2)
    n_base = sum(p.numel() for p in model.parameters())
    assert tlora.adapter_param_count(got) == jlora.adapter_param_count(
        jlora.init_lora(variables["params"], 2, jax.random.PRNGKey(1), targets=targets))
    assert tlora.adapter_param_count(got) < 0.25 * n_base
    with pytest.raises(ValueError, match="matched no kernel"):
        tlora.init_lora(model, 2, None, ("definitely_not_a_module",))


def test_merge_is_identity_at_init():
    cfg = tiny_config()
    _, variables = jax_variables(cfg)
    model = port_model(cfg, variables)
    adapters = tlora.init_lora(model, 4, torch.Generator().manual_seed(1), ("qkv_proj", "w_up"))
    ids = torch.from_numpy(token_ids(1, 40, seed=2))
    with torch.no_grad():
        ref, _ = model(ids)
        merged = tlora.merge_lora(model, adapters, scale=2.0)
        got, _ = torch.func.functional_call(model, merged, (ids,), strict=False)
    assert torch.equal(got, ref)


def test_lora_step_matches_jax():
    cfg = small_config()
    js, ts = both_states(cfg)
    base = jax.device_get(js.params)
    rng = np.random.RandomState(6)
    adapters = jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.05).astype(np.float32),
                            jax.device_get(jlora.init_lora(base, RANK, jax.random.PRNGKey(1))))
    jl = jlora.create_lora_train_state(js, base, RANK, jax.random.PRNGKey(1), js.tx)
    jl = jl.replace(params=jax.tree.map(jnp.asarray, adapters))
    ids = np.random.RandomState(7).randint(1, 512, (2, 64)).astype(np.int32)
    scale = tlora.lora_scale(RANK, ALPHA)
    jl, jm = jlora.make_lora_train_step(scale, aux_loss_weight=AUX)(
        jl, base, {"input_ids": jnp.asarray(ids)})

    tl = tlora.create_lora_train_state(ts, RANK, None)
    flat = _adapter_flat(adapters)
    assert sorted(tl.lora.tensors) == sorted(flat)
    with torch.no_grad():
        for k, t in tl.lora.tensors.items():
            t.copy_(torch.from_numpy(flat[k]))
    base_before = {k: v.clone() for k, v in tl.model.named_parameters()}
    tl, tm = tlora.make_lora_train_step(scale, aux_loss_weight=AUX)(
        tl, {"input_ids": torch.from_numpy(ids)})

    for key in ("loss/total", "loss/lm", "loss/aux", "training/grad_norm"):
        _close(float(tm[key]), float(jm[key]), key)
    j_mu, j_nu = (_adapter_flat(t) for t in _adam_moments(jl.opt_state))
    keys = list(tl.lora.tensors)
    got_mu = {k: m.numpy() for k, m in zip(keys, tl.optimizer.mu)}
    got_nu = {k: v.numpy() for k, v in zip(keys, tl.optimizer.nu)}
    for moments, got, name in ((j_mu, got_mu, "mu"), (j_nu, got_nu, "nu")):
        top = max(np.abs(w).max() for w in moments.values())
        for k in moments:
            _close(got[k], moments[k], f"adam {name} {k}", extra=1e-6 * top)

    def update(mu, nu):  # Adam's first step: bias corrections 1 - 0.9, 1 - 0.999
        mu, nu = np.asarray(mu, np.float64) / 0.1, np.asarray(nu, np.float64) / 0.001
        return mu / (np.sqrt(nu) + 1e-8)

    after = _adapter_flat(jl.params)
    for k, t in tl.lora.tensors.items():
        du = np.abs(update(got_mu[k], got_nu[k]) - update(j_mu[k], j_nu[k]))
        _close(t.detach().numpy(), after[k], k, rtol=1e-5, floor=0.0, extra=LR * du + 1e-7)
        assert not np.array_equal(t.detach().numpy(), flat[k]), k  # every adapter moved
    for k, v in tl.model.named_parameters():
        assert torch.equal(v, base_before[k]), k
    assert all(int(layer.moe.step_count) == 1 for layer in tl.model.layers)
    assert tl.step == 1 and int(tl.optimizer.count) == 1


TINY = ["--device", "cpu", "--use_dummy_data", "--batch_size", "2", "--seq_len", "16",
        "--slow_loop_interval", "0", "--log_interval", "1"]
BASE = ["--d_model", "32", "--num_layers", "1", "--num_heads", "2", "--num_experts", "2",
        "--window_size", "8"]


@pytest.fixture
def base_ckpt(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "base")
    loop.main(TINY + BASE + ["--steps_per_epoch", "2", "--checkpoint_dir", ckpt])
    return ckpt


def test_lora_cli_round_trip_and_serve_merge(tmp_path, base_ckpt, capsys):
    lora_ckpt = str(tmp_path / "lora")
    out = loop.main(TINY + ["--steps_per_epoch", "3", "--init_from", base_ckpt,
                            "--lora_rank", "2", "--ema_decay", "0.9",
                            "--checkpoint_dir", lora_ckpt])
    assert out["step"] == 3 and "LoRA rank 2" in capsys.readouterr().out
    state = out["state"]
    _, base_model = tckpt.load_lm_params(base_ckpt, "cpu")
    for (name, p), (_, q) in zip(state.model.named_parameters(), base_model.named_parameters()):
        assert torch.equal(p, q), name  # the base never moved
    with np.load(f"{lora_ckpt}/params.npz") as z:
        params = [k for k in z.files if k.startswith("params/")]
    assert params and all(k.endswith(("/lora_a", "/lora_b")) for k in params)
    _, served = tckpt.load_lm_params(lora_ckpt, "cpu")
    merged = tlora.merge_lora(state.model, state.lora, tlora.lora_scale(2, 16.0))
    for name, p in served.named_parameters():
        want = merged.get(name, dict(state.model.named_parameters())[name])
        assert torch.equal(p, want), name
    rows = serve.main(["--checkpoint_dir", lora_ckpt, "--prompt_ids", "5,17,20",
                       "--max_new_tokens", "4", "--temperature", "0", "--device", "cpu"])
    assert "adapters merged into the base weights" in capsys.readouterr().out
    want_row = generate.generate_cached(served, torch.tensor([[5, 17, 20]]), None,
                                        max_new_tokens=4, temperature=0.0)
    assert rows[0] == want_row[0].tolist()


@pytest.mark.parametrize("extra,match", [
    ([], "requires --init_from"),
    (["--init_from", "BASE", "--slow_loop_interval", "5"], "slow_loop_interval 0"),
    (["--init_from", "BASE", "--grad_accum", "2"], "does not compose with --grad_accum"),
    (["--init_from", "BASE", "--distill_from", "BASE"], "does not compose with --distill_from"),
])
def test_lora_refusals(base_ckpt, extra, match):
    extra = [base_ckpt if a == "BASE" else a for a in extra]
    with pytest.raises(ValueError, match=match):
        loop.main(TINY + ["--lora_rank", "2"] + extra)


def test_warm_start_without_lora(base_ckpt, capsys):
    out = loop.main(TINY + ["--steps_per_epoch", "1", "--init_from", base_ckpt])
    assert "warm-started params" in capsys.readouterr().out
    _, base_model = tckpt.load_lm_params(base_ckpt, "cpu")
    emb0 = base_model.token_embed.weight.detach()
    emb1 = out["state"].model.token_embed.weight.detach()
    assert float((emb1 - emb0).abs().max()) < 0.1 and not torch.equal(emb1, emb0)
    assert all(int(layer.moe.step_count) == 1 for layer in out["state"].model.layers)
