"""scripts/orbax_to_npz.py: JAX training runs (Orbax checkpoints) converted
into the port's ``model_config.json`` + ``params.npz``, then read by the
port's loaders:

* the JAX LM loop on the CPU, unrolled (1 layer); scanned
  (``--scan_layers``, 2 layers) with an EMA; and a LoRA run over the
  unrolled one (``--init_from
  --lora_rank``); the JAX clip loop with an EMA (a custom 1 + 1 layer
  preset at 32 px);
* ``load_lm_params`` (what ``serve`` and ``eval_lm`` load) gives logits
  within 1e-5 of the JAX package's ``load_lm_state`` + ``apply`` on the
  same ids, ``--use_ema``'s weights too; ``load_clip_params`` (``embed``'s
  loader) gives embeddings within 1e-5 of JAX's ``load_clip_state``;
* a scanned run stays scanned (``layers/block/...`` leaves with a leading
  (L,) axis); the LoRA run comes out merged, its meta without ``lora``;
* a directory that is not a checkpoint is refused.

Tolerance 1e-5 (atol and rtol): the same fp32 weights through each
framework's sums in other orders (one or two layers).

The whole train state (``--train_state``: Adam's state, the step, the
gradient statistics, LoRA adapters unmerged) and the port's ``--resume``
of it: ``tests/test_torch_resume_jax.py``.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models.decoder_lm import FORDEDecoderLM as JaxLM
from forde_tpu.models.dual_encoder import FORDEDualEncoder as JaxDE
from forde_tpu.train import checkpoint as jckpt
from forde_tpu.train import clip_loop as jclip
from forde_tpu.train import loop as jloop
from forde_tpu_torch.train import checkpoint as tckpt

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import orbax_to_npz  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
LM_FLAGS = ["--use_dummy_data", "--steps_per_epoch", "2", "--num_epochs", "1",
            "--batch_size", "2", "--seq_len", "32", "--d_model", "32", "--num_heads", "2",
            "--num_experts", "2", "--window_size", "8", "--slow_loop_interval", "0",
            "--log_interval", "1", "--plots_dir", ""]
CLIP_FLAGS = ["--preset", "custom", "--image_size", "32", "--patch_size", "16",
              "--tower_layers", "1", "--tower_dim", "128", "--embed_dim", "32",
              "--text_len", "16", "--batch_size", "2", "--num_steps", "2",
              "--use_dummy_data", "--slow_loop_interval", "0", "--log_interval", "1",
              "--plots_dir", "", "--ema_decay", "0.5"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (JAX checkpoint dir, converted dir, the trees JAX's loader
    restored)} of four JAX runs: the clip run converted by the script's
    command line, the others by its two steps (``read_checkpoint``, whose
    trees are JAX's ``load_lm_state``'s, then ``write_checkpoint``)."""
    tmp = tmp_path_factory.mktemp("orbax")
    dirs = {name: str(tmp / name) for name in ("lm", "scanned", "lora", "clip")}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)  # the loops' metrics go to ./runs
        jloop.train(jloop.build_parser().parse_args(
            LM_FLAGS + ["--num_layers", "1", "--checkpoint_dir", dirs["lm"]]))
        jloop.train(jloop.build_parser().parse_args(
            LM_FLAGS + ["--num_layers", "2", "--scan_layers", "--ema_decay", "0.5",
                        "--checkpoint_dir", dirs["scanned"]]))
        jloop.train(jloop.build_parser().parse_args(
            LM_FLAGS + ["--init_from", dirs["lm"], "--lora_rank", "4", "--checkpoint_dir",
                        dirs["lora"]]))
        jclip.train(jclip.build_parser().parse_args(CLIP_FLAGS + ["--checkpoint_dir",
                                                                  dirs["clip"]]))
    out = {}
    for name, src in dirs.items():
        dst = str(tmp / f"{name}_port")
        if name == "clip":
            assert orbax_to_npz.main([src, dst]) == 0
            out[name] = (src, dst, None)
            continue
        config, trees, meta = orbax_to_npz.read_checkpoint(src)
        orbax_to_npz.write_checkpoint(dst, config, trees, meta)
        out[name] = (src, dst, (config, trees))
    return out


def _ids():
    return np.random.RandomState(0).randint(1, 50257, (2, 24)).astype(np.int32)


def _jax_logits(restored, use_ema):
    config, trees = restored
    params = trees["ema_params"] if use_ema else trees["params"]
    (logits, _), _ = JaxLM(config=config).apply(
        {"params": params, "stats_buffer": trees["stats_buffer"]}, jnp.asarray(_ids()),
        mutable=["stats_buffer"])
    return np.asarray(logits)


@pytest.mark.parametrize("name,use_ema", [("lm", False), ("scanned", False),
                                          ("scanned", True), ("lora", False)])
def test_converted_lm_logits_match_jax(runs, name, use_ema):
    _, dst, restored = runs[name]
    _, model = tckpt.load_lm_params(dst, "cpu", use_ema=use_ema)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(_ids()))
    np.testing.assert_allclose(got.numpy(), _jax_logits(restored, use_ema), **TOL)
    cfg, meta = tckpt.load_meta(dst)
    assert meta["step"] == 2 and "lora" not in meta
    assert cfg.scan_layers == (name == "scanned")


def test_layouts_of_the_converted_trees(runs):
    with np.load(os.path.join(runs["scanned"][1], "params.npz")) as z:
        shapes = {k: z[k].shape for k in z.files}
        dtypes = {k: z[k].dtype for k in z.files}
    assert not any("layer_0" in k for k in shapes)
    for prefix in ("params", "ema_params"):
        assert shapes[f"{prefix}/layers/block/attn_norm/scale"] == (2, 32)
    assert shapes["stats_buffer/layers/block/moe/step_count"] == (2,)
    assert dtypes["stats_buffer/layers/block/moe/step_count"] == np.int32
    assert {k.split("/")[0] for k in shapes} == {"params", "ema_params", "stats_buffer"}
    with np.load(os.path.join(runs["lora"][1], "params.npz")) as z:
        lora_keys = set(z.files)
    with np.load(os.path.join(runs["lm"][1], "params.npz")) as z:
        assert lora_keys == set(z.files)  # merged: the base's dense tree, no adapter
    with open(os.path.join(runs["lora"][1], "model_config.json")) as f:
        assert "lora" not in json.load(f)["train"]


@pytest.mark.parametrize("use_ema", [False, True])
def test_converted_clip_embeddings_match_jax(runs, use_ema):
    src, dst, _ = runs["clip"]
    config, state = jckpt.load_clip_state(src)
    rng = np.random.RandomState(1)
    images = rng.rand(2, 32, 32, 3).astype(np.float32)
    ids = rng.randint(1, config.vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    variables = {"params": state.ema_params if use_ema else state.params, "brain": state.brain}
    model = JaxDE(config=config.replace(sense=False))
    want_img = model.apply(variables, jnp.asarray(images), method="encode_image")
    want_txt = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask), method="encode_text")
    _, port = tckpt.load_clip_params(dst, "cpu", use_ema=use_ema)
    with torch.no_grad():
        img = port.encode_image(torch.from_numpy(images))
        txt = port.encode_text(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), **TOL)
    np.testing.assert_allclose(txt.numpy(), np.asarray(want_txt), **TOL)
    with np.load(os.path.join(dst, "params.npz")) as z:
        assert {k.split("/")[0] for k in z.files} == {"params", "ema_params", "brain",
                                                     "stats_buffer"}


def test_not_a_checkpoint_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="model_config.json"):
        orbax_to_npz.convert(str(tmp_path), str(tmp_path / "out"))
    (tmp_path / "model_config.json").write_text(json.dumps({"model": {"kind": "llm"}}))
    with pytest.raises(FileNotFoundError, match="no Orbax step"):
        orbax_to_npz.convert(str(tmp_path), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
