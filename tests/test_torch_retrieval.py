"""The dual encoder's retrieval eval and aligned data in the port
(forde_tpu_torch.obs.retrieval, data.vl, train.clip_step.
clip_eval_embeddings, train.clip_loop), mirroring tests/test_obs.py's and
tests/test_data_synthetic.py's cases and held to the JAX package:

* ``retrieval_metrics`` equals the JAX package's, ties included (one-hot
  embeddings with repeated rows: the scores are exact, and a tie is not
  "strictly higher"), and on random embeddings;
* ``evaluate_retrieval`` end to end on a dual encoder carried across
  (the small config of tests/test_torch_clip_step.py, seeded batches):
  the same metrics as the JAX package's, ranks being integers;
* ``AlignedSyntheticVLDataset`` equals the JAX package's bit for bit
  (compositional and random captions, a class range, distinct sampling, a
  sample seed), and refuses a vocabulary too small for its captions;
* ``AlignedDeviceRenderer``: ids and masks equal the dataset's exactly;
  with noise 0 the images equal the dataset's within 1e-6 (its float64
  render against the fp32 ``tanh(latents @ basis)``); with noise the
  residual's mean is within 4 standard errors of 0 and its std within 2%
  of the noise level, as the numpy dataset's is (pixels far from the
  clip);
* ``hold_out_eval``;
* ``clip_loop --use_aligned_data --eval_interval`` with and without EMA:
  the ``seen_``/``unseen_`` (and ``ema_``) metrics present, recalls in
  [0, 1], ranks >= 1; ``--resume`` goes on from the saved step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.data import vl as jvl
from forde_tpu.obs import retrieval as jret
from forde_tpu_torch.data import vl as tvl
from forde_tpu_torch.obs import retrieval as tret
from forde_tpu_torch.train import clip_loop

from test_torch_clip_step import batch, both_states

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_moments(monkeypatch):
    monkeypatch.setenv("FORDE_MOMENT_IMPL", "interpret")


def _embeddings(kind):
    rng = np.random.RandomState(0)
    if kind == "random":
        return rng.randn(16, 8).astype(np.float32), rng.randn(16, 8).astype(np.float32)
    img = np.eye(8, dtype=np.float32)[rng.randint(0, 4, 16)]  # repeated rows: ties
    txt = np.eye(8, dtype=np.float32)[rng.randint(0, 4, 16)]
    return img, txt


@pytest.mark.parametrize("kind", ["ties", "random", "perfect", "shuffled"])
def test_retrieval_metrics_match_jax(kind):
    if kind in ("perfect", "shuffled"):
        img = np.random.RandomState(0).randn(16, 8).astype(np.float32)
        txt = img if kind == "perfect" else np.roll(img, 5, axis=0)
    else:
        img, txt = _embeddings(kind)
    want = jret.retrieval_metrics(jnp.asarray(img), jnp.asarray(txt), ks=(1, 2, 5))
    got = tret.retrieval_metrics(torch.from_numpy(img), torch.from_numpy(txt), ks=(1, 2, 5))
    assert got == want
    if kind == "perfect":
        assert got["retrieval/i2t_recall@1"] == 1.0 and got["retrieval/t2i_mean_rank"] == 1.0
    if kind == "shuffled":
        assert got["retrieval/i2t_recall@1"] < 0.5


def test_evaluate_retrieval_matches_jax():
    _, js, ts = both_states(64, None)
    batches = [batch(seed) for seed in (1, 2, 3)]
    want = jret.evaluate_retrieval(js, batches, ks=(1, 5), prefix="seen_")
    got = tret.evaluate_retrieval(ts, batches, ks=(1, 5), prefix="seen_")
    assert set(got) == set(want) >= {"retrieval/seen_i2t_recall@1", "retrieval/seen_t2i_recall@5",
                                     "retrieval/seen_i2t_mean_rank"}
    assert got == want
    assert all(int(layer.step_count) == 0 for name, layer in ts.model.named_modules()
               if name.endswith("stateful"))


ALIGNED = {
    "compositional": dict(),
    "random_captions": dict(compositional=False),
    "class_range_distinct": dict(class_range=(16, 64), distinct=True, sample_seed=9),
    "noise_free": dict(noise=0.0, num_batches=3),
}


def _aligned(mod, **kw):
    base = dict(batch_size=8, num_batches=2, image_size=32, text_len=16, vocab_size=512,
                num_classes=64, seed=3)
    base.update(kw)
    return mod.AlignedSyntheticVLDataset(**base)


@pytest.mark.parametrize("name", sorted(ALIGNED))
def test_aligned_dataset_equals_jax(name):
    got, want = list(_aligned(tvl, **ALIGNED[name])), list(_aligned(jvl, **ALIGNED[name]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    with pytest.raises(ValueError, match="vocab_size"):
        _aligned(tvl, vocab_size=100)


def test_renderer_against_the_dataset():
    clean = _aligned(tvl, noise=0.0, num_batches=3)
    rendered = list(tvl.AlignedDeviceRenderer(clean, "cpu").batches())
    for r, w in zip(rendered, clean):
        for k in ("input_ids", "attention_mask"):
            assert r[k].dtype == torch.int32 and np.array_equal(r[k].numpy(), w[k]), k
        assert r["image"].dtype == torch.float32
        np.testing.assert_allclose(r["image"].numpy(), w["image"], atol=1e-6, rtol=0)
    noisy = _aligned(tvl, noise=0.05, num_batches=4)
    for source in ("device", "numpy"):
        res = []
        batches = (tvl.AlignedDeviceRenderer(noisy, "cpu").batches() if source == "device"
                   else iter(noisy))
        for b, c in zip(batches, _aligned(tvl, noise=0.0, num_batches=4)):
            img = np.asarray(b["image"])
            keep = (c["image"] > 0.25) & (c["image"] < 0.75)
            res.append((img - c["image"])[keep])
        res = np.concatenate(res)
        assert abs(res.mean()) < 4 * 0.05 / np.sqrt(res.size), source
        assert abs(res.std() / 0.05 - 1) < 0.02, (source, res.std())


def test_hold_out_eval_split():
    items = [{"i": i} for i in range(10)]
    held, rest = tvl.hold_out_eval(iter(items), 3)
    assert [h["i"] for h in held] == [0, 1, 2]
    assert [r["i"] for r in rest] == list(range(3, 10))
    held2, rest2 = tvl.hold_out_eval(iter(items[:2]), 5)
    assert len(held2) == 2 and list(rest2) == []


@pytest.mark.parametrize("ema", [False, True])
def test_clip_loop_aligned_data_with_retrieval_eval(tmp_path, monkeypatch, capsys, ema):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--preset", "custom", "--tower_layers", "1", "--tower_dim",
            "128", "--image_size", "32", "--text_len", "16", "--embed_dim", "64",
            "--use_aligned_data", "--aligned_classes", "64", "--batch_size", "4",
            "--eval_interval", "2", "--eval_batches", "2", "--slow_loop_interval", "2",
            "--log_interval", "2", "--checkpoint_dir", ckpt] + (
                ["--ema_decay", "0.9"] if ema else [])
    out = clip_loop.main(argv + ["--num_steps", "4"])
    assert out["step"] == 4 and [r["step"] for r in out["retrieval"]] == [2, 4]
    prefixes = ["seen_", "unseen_"] + (["ema_seen_", "ema_unseen_"] if ema else [])
    for record in out["retrieval"]:
        m = record["metrics"]
        assert len(m) == 10 * len(prefixes)
        for p in prefixes:
            for d in ("i2t", "t2i"):
                for k in (1, 5, 10):
                    assert 0.0 <= m[f"retrieval/{p}{d}_recall@{k}"] <= 1.0
                assert m[f"retrieval/{p}{d}_mean_rank"] >= 1.0
    assert "[retrieval/unseen_ @ 4]" in capsys.readouterr().out
    resumed = clip_loop.main(argv + ["--num_steps", "6", "--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed["step"] == 6 and [r["step"] for r in resumed["retrieval"]] == [6]
