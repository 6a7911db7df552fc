"""Per-request sampling in the port's decode pool (cases of
tests/test_pool_sampling.py), with the JAX package's greedy tokens on the
same weights as the reference where the settings are deterministic.

``sample_rows`` takes temperature, top-k and top-p as per-row tensors, so
mixed settings share one pooled step. With one setting on every row it
draws exactly what ``_sample`` draws from the same generator state (the
same masks, the same exponential race); each row follows its own
settings. ``jax.random`` draws cannot be reproduced, so sampled tokens are
held to themselves: the same seed gives the same tokens, another seed
others, and the deterministic settings (greedy, top_k 1, a nucleus of one
token) give the JAX greedy tokens through the whole pool.
"""

import json
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu_torch.models import decode_pool as tpool
from forde_tpu_torch.models import generate as tgen
from forde_tpu_torch.models.decode_pool import DecodePool

from test_torch_decode_pool import drain, setup_variant, want
from test_torch_serve_http import checkpoint, post, start_server, stop_server

torch.set_num_threads(1)

_RNG = np.random.RandomState(2)
PROMPTS = [_RNG.randint(1, 256, n).tolist() for n in (3, 19, 2, 24)]


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, None, None),
    (0.7, 5, None),
    (1.3, None, 0.8),
    (0.5, 7, 0.6),
    (0.0, 3, 0.9),  # greedy rows ignore the filters
])
def test_sample_rows_matches_static_sampler(temp, top_k, top_p):
    """One setting on every row: sample_rows draws what _sample draws from
    a generator in the same state."""
    logits = torch.from_numpy(np.random.RandomState(0).randn(4, 64).astype(np.float32))
    for seed in range(5):
        want_ = tgen._sample(logits, torch.Generator().manual_seed(seed), temp, top_k, top_p)
        got = tgen.sample_rows(
            logits, torch.Generator().manual_seed(seed), torch.full((4,), temp),
            None if top_k is None else torch.full((4,), top_k),
            None if top_p is None else torch.full((4,), top_p),
        )
        assert torch.equal(got, want_), seed


def test_sample_rows_mixed_rows_independent():
    """Each row obeys its own settings: a greedy row, a top_k 1 row and a
    nucleus of one token all give the argmax, JAX's sample_rows' tokens;
    an unfiltered sampled row draws across the vocabulary."""
    logits = np.random.RandomState(1).randn(4, 32).astype(np.float32)
    temps, ks, ps = [0.0, 1.0, 1.0, 1.0], [0, 1, 0, 0], [1.0, 1.0, 1e-9, 1.0]
    want_ = np.asarray(jgen.sample_rows(
        jnp.asarray(logits), jax.random.PRNGKey(3), jnp.asarray(temps, jnp.float32),
        jnp.asarray(ks, jnp.int32), jnp.asarray(ps, jnp.float32)))
    gen = torch.Generator().manual_seed(3)
    drawn = set()
    for _ in range(40):
        got = tgen.sample_rows(torch.from_numpy(logits), gen, torch.tensor(temps),
                               torch.tensor(ks), torch.tensor(ps)).numpy()
        np.testing.assert_array_equal(got[:3], logits[:3].argmax(-1))
        np.testing.assert_array_equal(got[:3], want_[:3])
        drawn.add(int(got[3]))
    assert len(drawn) > 5


@pytest.fixture(scope="module", params=["dense", "nsa"])
def variant(request):
    return setup_variant(request.param, PROMPTS, new=4)


def test_pool_per_request_sampling_deterministic_configs(variant):
    """Mixed per-request settings in one sampled pool: every deterministic
    one (greedy, top_k 1, a nucleus of one token, greedy with filters)
    equals the JAX greedy tokens."""
    settings = [
        dict(temperature=0.0),
        dict(temperature=1.0, top_k=1),
        dict(temperature=0.7, top_p=1e-9),
        dict(temperature=0.0, top_k=9, top_p=0.5),
    ]
    pool = DecodePool(variant.port, rows=2, temperature=1.0)
    rids = [pool.submit(p, max_new_tokens=4, **s) for p, s in zip(PROMPTS, settings)]
    results = drain(pool)
    for rid, p in zip(rids, PROMPTS):
        assert results[rid] == want(variant, p, 4), rid


def test_pool_sampling_deterministic_per_seed(variant):
    """Sampled requests (temperature alone, with top-k, with top-p): two
    pools of one seed give the same tokens, a pool of another seed other
    tokens."""
    settings = [dict(temperature=0.9), dict(temperature=1.2, top_k=20),
                dict(temperature=1.0, top_p=0.9), dict(temperature=1.5)]

    def run(seed):
        pool = DecodePool(variant.port, rows=2, temperature=0.0, seed=seed)
        rids = [pool.submit(p, max_new_tokens=4, **s) for p, s in zip(PROMPTS, settings)]
        results = drain(pool)
        return [results[r] for r in rids]

    first = run(11)
    assert run(11) == first
    assert run(12) != first
    assert all(len(r) == len(p) + 4 and all(0 <= t < 256 for t in r)
               for r, p in zip(first, PROMPTS))


def test_pool_default_sampling_unchanged(variant, monkeypatch):
    """A request without settings takes the pool's default (a greedy pool:
    greedy tokens); every step is the unfiltered one, and a finished
    slot's settings are reset."""
    calls = []
    step = tpool._step_pool_k

    def spy(model, st, generator, filtered, k):
        calls.append(filtered)
        step(model, st, generator, filtered, k)

    monkeypatch.setattr(tpool, "_step_pool_k", spy)
    pool = DecodePool(variant.port, rows=2, temperature=0.0)
    rid = pool.submit(PROMPTS[0], max_new_tokens=3)
    assert drain(pool)[rid] == want(variant, PROMPTS[0], 3)
    assert calls and not any(calls)
    pool.submit(PROMPTS[1], max_new_tokens=3, temperature=1.0, top_k=5, top_p=0.5)
    drain(pool)
    assert calls[-1] is True
    assert (pool.topks == 0).all() and (pool.topps == 1.0).all()
    assert (pool.static.topks == 0).all() and (pool.static.topps == 1.0).all()
    assert (pool.static.temps == 0).all()


def test_http_per_request_sampling(tmp_path_factory):
    """A sampled continuous server honours a per-request greedy setting;
    batch mode refuses per-request sampling with 400."""
    v = checkpoint(tmp_path_factory, "dense", [PROMPTS[0]], 4)
    srv, batcher, url = start_server(v.ckpt, "--continuous", "--temperature", "1", max_new=4)
    try:
        res = post(url, {"prompt_ids": PROMPTS[0], "temperature": 0})
        assert res["output_ids"] == want(v, PROMPTS[0], 4)
    finally:
        stop_server(srv, batcher)
    srv, batcher, url = start_server(v.ckpt)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(url, {"prompt_ids": [5, 17], "temperature": 0.5})
        assert e.value.code == 400
        assert "continuous" in json.loads(e.value.read())["error"]
    finally:
        stop_server(srv, batcher)
