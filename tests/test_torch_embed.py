"""The port's embedding CLI (forde_tpu_torch.embed) against the JAX
package's model on the same checkpoint and inputs.

A JAX model is initialised (the small config of
test_torch_dual_encoder.py), its ``params`` and ``brain`` trees are
written as ``params.npz`` beside a ``model_config.json`` written by either
package, and ``embed.main([... "--device", "cpu"])`` embeds .npy images
(two of them at another size, to exercise the resize) and token-id lists.
The JAX side loads the same images with ``forde_tpu.embed._load_images``
(``jax.image.resize``) and runs ``encode_image`` / ``encode_text``.

Tolerances (fp32): embeddings and similarities within atol = rtol =
1e-4, as in test_torch_dual_encoder.py; the resize within 5e-5 of
``jax.image.resize`` (torch's antialiased bilinear and JAX's triangle
kernel sum their weights in different orders; observed <= 1.4e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu import embed as jax_embed
from forde_tpu_torch import embed, interop, resolve_device
from forde_tpu_torch.core import config as tcfg
from forde_tpu_torch.train import checkpoint as tckpt

from test_torch_dual_encoder import jax_model_and_vars

torch.set_num_threads(1)

TEXTS = "12,99,407;7,5;1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18"


def _write_checkpoint(directory, writer):
    jax_cfg, model, variables = jax_model_and_vars("float32", seed=3)
    npz = interop.flatten(variables)
    if writer == "jax":
        from forde_tpu.train.checkpoint import save_model_config

        save_model_config(directory, jax_cfg, {"step": 7})
        np.savez(f"{directory}/params.npz", **npz)
    else:
        from forde_tpu.core.config import config_to_dict

        cfg = tcfg.config_from_dict(config_to_dict(jax_cfg))
        tckpt.save_clip_params(directory, cfg, npz, {"step": 7})
    return jax_cfg, model, variables


def _write_images(tmp_path):
    rng = np.random.RandomState(0)
    arrays = [
        (rng.rand(40, 40, 3) * 255).astype(np.uint8),  # shrinks: antialiased
        rng.rand(32, 32, 3).astype(np.float32),
        rng.rand(20, 24, 3).astype(np.float32),  # grows
    ]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f"img{i}.npy"))
        np.save(paths[-1], a)
    return ",".join(paths)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_embed_cli_matches_jax(tmp_path, capsys, writer):
    ckpt = str(tmp_path / "ckpt")
    jax_cfg, model, variables = _write_checkpoint(ckpt, writer)
    images = _write_images(tmp_path)
    prefix = str(tmp_path / "emb")
    embed.main([
        "--checkpoint_dir", ckpt, "--image_npy", images, "--text_ids", TEXTS,
        "--out", prefix, "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "restored step 7" in out
    assert "3 image embeddings, dim 128" in out
    assert "3 text embeddings, dim 128" in out
    assert "cosine similarity" in out and "best text per image" in out

    j_images = jax_embed._load_images(images, jax_cfg.image_size)
    ids, mask = jax_embed._load_texts(TEXTS, jax_cfg.max_text_len)
    j_img = np.asarray(model.apply(variables, j_images, method=model.encode_image))
    j_txt = np.asarray(
        model.apply(variables, ids, mask, method=model.encode_text)
    )
    got_img = np.load(prefix + "_image.npy")
    got_txt = np.load(prefix + "_text.npy")
    np.testing.assert_allclose(got_img, j_img, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_txt, j_txt, atol=1e-4, rtol=1e-4)

    from forde_tpu.models.dual_encoder import l2_normalize

    j_sim = np.asarray(l2_normalize(jnp.asarray(j_img)) @ l2_normalize(jnp.asarray(j_txt)).T)
    sim_rows = [
        [float(v) for v in line.split()]
        for line in out.split("cosine similarity:\n")[1].splitlines()[:3]
    ]
    np.testing.assert_allclose(np.asarray(sim_rows), j_sim, atol=1e-4)


@pytest.mark.parametrize("hw", [(40, 40), (20, 24), (224, 300), (64, 33)])
def test_resize_matches_jax(hw):
    x = np.random.RandomState(1).rand(*hw, 3).astype(np.float32)
    for size in (32, 224):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (size, size, 3), "bilinear"))
        got = embed.resize_bilinear(x, size)
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_embed_without_gpu_raises(tmp_path, monkeypatch):
    """Without --device cpu the CLI runs on CUDA, and with no GPU it raises
    instead of falling back to the CPU."""
    ckpt = str(tmp_path / "ckpt")
    _write_checkpoint(ckpt, "port")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        embed.main(["--checkpoint_dir", ckpt, "--text_ids", "1,2"])
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_embed_use_ema_not_ported(tmp_path):
    """--use_ema is ported (tests/test_torch_ema.py); a checkpoint trained
    without an EMA has none to embed with, and says so."""
    ckpt = str(tmp_path / "ckpt")
    _write_checkpoint(ckpt, "port")
    with pytest.raises(ValueError, match="no EMA weights"):
        embed.main(["--checkpoint_dir", ckpt, "--text_ids", "1,2", "--use_ema",
                    "--device", "cpu"])


def test_load_clip_params_rejects_incomplete_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _write_checkpoint(ckpt, "port")
    with np.load(f"{ckpt}/params.npz") as z:
        kept = {k: z[k] for k in z.files if not k.endswith("final_norm/scale")}
    np.savez(f"{ckpt}/params.npz", **kept)
    with pytest.raises(KeyError, match="final_norm.weight"):
        tckpt.load_clip_params(ckpt, "cpu")
