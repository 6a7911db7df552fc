"""The port's dual encoder (forde_tpu_torch.models.dual_encoder) against
the JAX package's, with the same weights.

A small config (2 + 2 layers, d=128, H=2, D=64, image 32, text 16, the
shape of ``__graft_entry__.entry()``): the JAX model is initialised, its
neuron assignments are set to a seeded mix of 0/1/2 (every multiplex
branch and the 0.1 gate run), and ``interop.flax_to_state_dict`` carries
params and assignments into the port. Inputs come from numpy with a seed.

Tolerances: fp32 embeddings and loss within atol = rtol = 1e-4 (two
towers of fp32 matmuls summed in different orders; observed ~1e-6).
bf16 compares the relative L2 error of each embedding matrix, within 1e-2:
bf16 rounds at other places in the two frameworks, and a pre-activation
that rounds to the other side of 0 flips a binary-step neuron.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.core import config as jcfg
from forde_tpu.models import dual_encoder as jde
from forde_tpu_torch import interop
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.models import dual_encoder as tde

torch.set_num_threads(1)

B, S_TEXT = 4, 16


def small_config(cfg_mod, dtypes):
    tower = cfg_mod.TowerConfig(
        d_model=128, num_layers=2, num_heads=2, head_dim=64, mlp_hidden_dim=256
    )
    return cfg_mod.DualEncoderConfig(
        image_size=32, patch_size=16, vision=tower, text=tower,
        vocab_size=1024, max_text_len=S_TEXT, embed_dim=128, sense=False,
        dtypes=dtypes,
    )


def jax_model_and_vars(dtype_name, seed=0):
    dtypes = jcfg.DTypePolicy.bf16() if dtype_name == "bfloat16" else jcfg.DTypePolicy()
    cfg = small_config(jcfg, dtypes)
    model = jde.FORDEDualEncoder(config=cfg)
    images, ids, mask = inputs(seed)
    variables = jax.device_get(
        model.init(jax.random.PRNGKey(seed), images, ids, mask)
    )
    rng = np.random.RandomState(seed + 100)
    brain = jax.tree_util.tree_map(
        lambda a: rng.randint(0, 3, a.shape).astype(np.int32), variables["brain"]
    )
    return cfg, model, {"params": variables["params"], "brain": brain}


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(B, 32, 32, 3).astype(np.float32)
    ids = rng.randint(1, 1024, (B, S_TEXT)).astype(np.int32)
    lens = np.array([S_TEXT, 5, 1, 11])
    mask = (np.arange(S_TEXT)[None, :] < lens[:, None]).astype(np.int32)
    return images, ids * mask, mask


def port_model(jax_cfg, variables):
    cfg = tcfg.config_from_dict(jcfg.config_to_dict(jax_cfg))
    model = tde.FORDEDualEncoder(cfg)
    state = interop.flax_to_state_dict(
        variables["params"], variables["brain"], expected=model.state_dict()
    )
    model.load_state_dict(state)
    return model.eval()


def both(dtype_name):
    jax_cfg, jmodel, variables = jax_model_and_vars(dtype_name)
    images, ids, mask = inputs()
    j_img, j_txt, j_scale = jmodel.apply(variables, images, ids, mask)
    tmodel = port_model(jax_cfg, variables)
    with torch.no_grad():
        t_img, t_txt, t_scale = tmodel(
            torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask)
        )
    return (j_img, j_txt, j_scale), (t_img, t_txt, t_scale)


def test_assignments_cover_every_branch():
    _, _, variables = jax_model_and_vars("float32")
    leaves = np.concatenate(
        [np.ravel(a) for a in jax.tree_util.tree_leaves(variables["brain"])]
    )
    assert set(np.unique(leaves)) == {0, 1, 2}


@pytest.mark.parametrize("what", ["image", "text"])
def test_encoders_match_jax_fp32(what):
    (j_img, j_txt, _), (t_img, t_txt, _) = both("float32")
    want, got = (j_img, t_img) if what == "image" else (j_txt, t_txt)
    assert got.dtype == torch.float32 and got.shape == (B, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_contrastive_loss_matches_jax_fp32():
    (j_img, j_txt, j_scale), (t_img, t_txt, t_scale) = both("float32")
    j_loss, j_metrics = jde.clip_contrastive_loss(j_img, j_txt, j_scale)
    t_loss, t_metrics = tde.clip_contrastive_loss(t_img, t_txt, t_scale)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), atol=1e-4, rtol=1e-4)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(t_metrics[k]), float(v), atol=1e-4, rtol=1e-4)


def test_contrastive_loss_clamps_scale():
    rng = np.random.RandomState(5)
    img, txt = rng.randn(6, 8).astype(np.float32), rng.randn(6, 8).astype(np.float32)
    j_loss, _ = jde.clip_contrastive_loss(img, txt, jnp.float32(7.0))
    t_loss, m = tde.clip_contrastive_loss(
        torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(7.0)
    )
    assert float(m["contrastive/logit_scale"]) == 100.0
    np.testing.assert_allclose(float(t_loss), float(j_loss), atol=1e-4, rtol=1e-4)


def test_encoders_match_jax_bf16():
    (j_img, j_txt, _), (t_img, t_txt, _) = both("bfloat16")
    for want, got in ((j_img, t_img), (j_txt, t_txt)):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        assert np.isfinite(got).all()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-2, rel


def test_register_tokens_pad_to_eight():
    """224/16 -> 196 patches + CLS + 3 registers = 200 positions."""
    cfg = tcfg.vit_b16_hd128_config().replace(
        vision=tcfg.TowerConfig(d_model=8, num_layers=0, num_heads=1, head_dim=64),
        text=tcfg.TowerConfig(d_model=8, num_layers=0, num_heads=1, head_dim=64),
        vocab_size=16,
    )
    model = tde.FORDEDualEncoder(cfg, generator=torch.Generator().manual_seed(0))
    assert model.vision.register_tokens.shape == (1, 3, 8)
    assert model.vision.pos_embed.shape == (1, 200, 8)


@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_config_json_matches_jax(preset):
    jax_presets = {
        "vit_b16": jcfg.vit_b16_config,
        "vit_tiny": jcfg.vit_tiny_config,
        "vit_tiny_hd128": jcfg.vit_tiny_hd128_config,
        "vit_b16_hd128": jcfg.vit_b16_hd128_config,
    }
    for j, t in (
        (jax_presets[preset](), tcfg.PRESETS[preset]()),
        (
            jax_presets[preset]().replace(dtypes=jcfg.DTypePolicy.bf16()),
            tcfg.PRESETS[preset]().replace(dtypes=tcfg.DTypePolicy.bf16()),
        ),
    ):
        j_json = json.dumps(jcfg.config_to_dict(j))
        assert json.dumps(tcfg.config_to_dict(t)) == j_json
        assert tcfg.config_from_dict(json.loads(j_json)) == t


def test_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tcfg.DualEncoderConfig)] == [
        f.name for f in dataclasses.fields(jcfg.DualEncoderConfig)
    ]


def test_llm_config_not_ported():
    """The decoder-LM config is ported now: the JAX package's JSON loads
    into the port's ``LLMConfig`` and writes back the same; an unknown
    kind still raises."""
    d = jcfg.config_to_dict(jcfg.create_default_config())
    t = tcfg.config_from_dict(json.loads(json.dumps(d)))
    assert t == tcfg.create_default_config()
    assert json.dumps(tcfg.config_to_dict(t)) == json.dumps(d)
    with pytest.raises(ValueError, match="unknown config kind"):
        tcfg.config_from_dict(dict(d, kind="vae"))


def test_interop_raises_on_unused_and_missing_keys():
    jax_cfg, _, variables = jax_model_and_vars("float32")
    model = tde.FORDEDualEncoder(tcfg.config_from_dict(jcfg.config_to_dict(jax_cfg)))
    expected = model.state_dict()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    extra = dict(params, extra_param=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra_param"):
        interop.flax_to_state_dict(extra, variables["brain"], expected=expected)
    missing = {k: v for k, v in params.items() if k != "logit_scale"}
    with pytest.raises(KeyError, match="logit_scale"):
        interop.flax_to_state_dict(missing, variables["brain"], expected=expected)
    with pytest.raises(KeyError, match="no mapping"):
        interop.flax_to_state_dict(
            dict(params, odd={"gamma": np.zeros(2)}), variables["brain"]
        )


def test_interop_round_trip():
    jax_cfg, _, variables = jax_model_and_vars("float32")
    state = interop.flax_to_state_dict(variables["params"], variables["brain"])
    back = interop.state_dict_to_flax(state)
    want = interop.flatten({"params": variables["params"], "brain": variables["brain"]})
    got = interop.flatten(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_sense_true_not_ported():
    """Sensing is ported: a config with ``sense=True`` builds the fast-loop
    buffers, and what stays unsupported is a sensed call on a model built
    without them."""
    cfg = tcfg.config_from_dict(
        jcfg.config_to_dict(small_config(jcfg, jcfg.DTypePolicy()).replace(sense=True))
    )
    keys = tde.FORDEDualEncoder(cfg).state_dict()
    assert "vision.blocks.0.stateful.act_stats" in keys
    assert "text.blocks.1.stateful.step_count" in keys
    plain = tde.FORDEDualEncoder(cfg.replace(sense=False))
    images, ids, mask = (torch.from_numpy(a) for a in inputs())
    with pytest.raises(ValueError, match="sense=True"):
        plain(images, ids, mask, sense=True)
