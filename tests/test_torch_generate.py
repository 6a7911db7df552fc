"""The port's cached generation (forde_tpu_torch.models.generate) against
the JAX package's, with the same weights (the small config of
test_torch_decoder_lm.py: window 16, compression ratio 4, top-k 8,
max_seq_len 64).

* ``nsa_prefill`` caches, with and without ``lengths``: every leaf of the
  JAX cache tree, integer leaves (top-k indices, position counters)
  exactly, float leaves within 1e-5 (fp32 products summed in other
  orders; observed ~1e-7).
* Greedy tokens (temperature 0) of ``generate_cached`` and
  ``generate_ragged`` (NSA and dense configs), prompts longer than the window
  so that every NSA branch runs, exactly equal. ``jax.random`` draws
  cannot be reproduced, so sampling is checked by its masks:
  ``_filter_logits`` and ``sample_rows`` on the same logits as JAX's, the
  -inf pattern exactly.
* Full-recompute ``generate`` (one forward over the whole buffer per new
  token), greedy, dense and NSA, past the window: exactly JAX's
  ``generate``'s tokens; the MoE stat buffers stay as loaded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu_torch import interop
from forde_tpu_torch.models import generate as tgen

from test_torch_decoder_lm import jax_variables, port_model, tiny_config

torch.set_num_threads(1)

LENS = [5, 18, 26, 32]  # below the window, past it, past window + ratio
PMAX = 32
NEW = 8


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 256, (n,)).tolist() for n in LENS]
    padded = np.zeros((len(LENS), PMAX), np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
    return prompts, padded


def _flat_cache(cache):
    return {k: np.asarray(v) for k, v in interop.flatten(
        jax.tree_util.tree_map(lambda a: np.asarray(a), cache)).items()}


def _flatten_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten_torch(v, path))
        else:
            out[path] = v.detach().float().numpy() if v.is_floating_point() else v.numpy()
    return out


def _assert_caches_equal(got, want):
    got, want = _flatten_torch(got), _flat_cache(want)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w.astype(np.float32), atol=1e-5, rtol=1e-5,
                                       err_msg=k)


@pytest.fixture(scope="module")
def nsa_setup():
    cfg = tiny_config()
    model, variables = jax_variables(cfg)
    return cfg, model, variables, port_model(cfg, variables)


def test_nsa_prefill_caches_match_jax(nsa_setup):
    cfg, model, variables, port = nsa_setup
    prompts, _ = _prompts()
    ids = np.asarray([prompts[3]], np.int32)  # 32 tokens: every branch live
    mv = {"params": variables["params"], "stats_buffer": {}}
    want_cache, want_last = jax.jit(jgen.nsa_prefill, static_argnums=0)(model, mv, jnp.asarray(ids))
    got_cache, got_last = tgen.nsa_prefill(port, torch.from_numpy(ids).long())
    _assert_caches_equal(got_cache, want_cache)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=1e-4, rtol=1e-4)


def test_nsa_prefill_ragged_caches_match_jax(nsa_setup):
    cfg, model, variables, port = nsa_setup
    _, padded = _prompts(seed=1)
    mv = {"params": variables["params"], "stats_buffer": {}}
    want_cache, want_last = jax.jit(jgen.nsa_prefill, static_argnums=0)(
        model, mv, jnp.asarray(padded), jnp.asarray(LENS, jnp.int32))
    got_cache, got_last = tgen.nsa_prefill(
        port, torch.from_numpy(padded).long(), torch.tensor(LENS))
    _assert_caches_equal(got_cache, want_cache)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=1e-4, rtol=1e-4)


def _setup(nsa_setup, variant):
    if variant == "nsa":
        return nsa_setup
    cfg = tiny_config(use_sparse_attention=False)
    model, variables = jax_variables(cfg)
    return cfg, model, variables, port_model(cfg, variables)


@pytest.mark.parametrize("variant", ["nsa", "dense"])
def test_generate_ragged_greedy_matches_jax(nsa_setup, variant):
    cfg, model, variables, port = _setup(nsa_setup, variant)
    _, padded = _prompts(seed=2)
    want = jgen.generate_ragged(
        model, variables, jnp.asarray(padded), jnp.asarray(LENS, jnp.int32),
        jax.random.PRNGKey(0), max_new_tokens=NEW, temperature=0.0,
    )
    got = tgen.generate_ragged(
        port, torch.from_numpy(padded).long(), torch.tensor(LENS), None,
        max_new_tokens=NEW, temperature=0.0,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", ["nsa", "dense"])
def test_generate_cached_greedy_matches_jax(nsa_setup, variant):
    cfg, model, variables, port = _setup(nsa_setup, variant)
    prompts, _ = _prompts(seed=3)
    ids = np.asarray([prompts[2]], np.int32)  # 26 tokens, past the window
    want = jgen.generate_cached(
        model, variables, jnp.asarray(ids), jax.random.PRNGKey(0),
        max_new_tokens=NEW, temperature=0.0,
    )
    got = tgen.generate_cached(port, torch.from_numpy(ids).long(), None,
                               max_new_tokens=NEW, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eos_pads_the_tail(nsa_setup):
    """A row that emits ``eos_id`` continues with ``pad_id``: with the
    first greedy token as the EOS, every later token is the pad."""
    _, _, _, port = nsa_setup
    prompts, _ = _prompts(seed=4)
    ids = torch.tensor([prompts[3]])
    first = tgen.generate_cached(port, ids, None, max_new_tokens=1, temperature=0.0)[0, -1]
    out = tgen.generate_cached(port, ids, None, max_new_tokens=5, temperature=0.0,
                               eos_id=int(first), pad_id=7)
    assert out[0, len(prompts[3])] == first
    assert out[0, len(prompts[3]) + 1:].tolist() == [7] * 4


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9), (20, 0.5), (1, None)])
def test_filter_logits_masks_match_jax(top_k, top_p):
    logits = np.random.RandomState(5).randn(3, 64).astype(np.float32) * 2.0
    logits[1, :4] = logits[1, 4]  # ties at the k-th value
    want = np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k, top_p))
    got = tgen._filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sample_rows_masks_and_greedy():
    """sample_rows: greedy rows are the argmax; a sampled row never draws a
    token that ``_filter_logits`` masks for its settings."""
    logits = torch.from_numpy(np.random.RandomState(6).randn(4, 50).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.7, 1.3])
    top_ks = torch.tensor([0, 3, 0, 5])
    top_ps = torch.tensor([1.0, 1.0, 0.5, 0.8])
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        out = tgen.sample_rows(logits, gen, temps, top_ks, top_ps)
        assert out[0] == logits[0].argmax()
        for i in (1, 2, 3):
            k = int(top_ks[i]) or None
            p = float(top_ps[i]) if float(top_ps[i]) < 1.0 else None
            allowed = tgen._filter_logits(logits[i:i + 1] / temps[i], k, p)[0]
            assert torch.isfinite(allowed[out[i]])


@pytest.mark.parametrize("variant", ["nsa", "dense"])
def test_generate_full_recompute_greedy_matches_jax(nsa_setup, variant):
    cfg, model, variables, port = _setup(nsa_setup, variant)
    _, padded = _prompts(seed=7)
    ids = padded[:2, :20]  # 20 + 8 positions: past the window and window + ratio
    want = jgen.generate(model, variables, jnp.asarray(ids), jax.random.PRNGKey(0),
                         max_new_tokens=NEW, temperature=0.0)
    usage = port.layers[0].moe.expert_usage.clone()
    got = tgen.generate(port, torch.from_numpy(ids).long(), None, max_new_tokens=NEW,
                        temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(port.layers[0].moe.expert_usage, usage)
