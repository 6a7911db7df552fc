"""The port's prefix caching (forde_tpu_torch.models.generate
``prefill_prefix``, ``tile_prefix_cache``, ``prefix_cache=``) against the
JAX package's, with the same weights (test_torch_decoder_lm.py's small
config, dense-causal, max_seq_len 64).

Greedy tokens (temperature 0) are held exactly: ``generate_cached`` and
``generate_ragged`` continuing from a prefix cache equal the JAX
package's on the same prefix and the port's own decode of the
concatenated prompt. The prefix cache is left exactly as it was after two
calls (the decode writes its cache in place, so the tiling must copy).
NSA configs are refused, as in the reference. ``serve --prefix_ids``
gives the JAX package's tokens, and refuses beam search, speculative
decoding and NSA configs with it. The decode pool's registered prefixes
(slots reused, tokens streamed, the budget guard) and the daemon's system
prefix (batch and continuous mode) and SSE stream give the JAX package's
greedy tokens of the concatenated prompt, the prefix cache left as it was.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu_torch import serve
from forde_tpu_torch.models import generate as tgen
from forde_tpu_torch.models.decode_pool import DecodePool

from test_torch_decode_pool import add_refs, drain, want
from test_torch_decoder_lm import jax_variables, port_model, tiny_config
from test_torch_serve_http import checkpoint, post, start_server, stop_server

torch.set_num_threads(1)

NEW = 6


def _dense(scan_layers=False):
    cfg = tiny_config(use_sparse_attention=False, scan_layers=scan_layers)
    model, variables = jax_variables(cfg)
    return cfg, model, variables, port_model(cfg, variables)


def _flat(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("scan_layers", [False, True])
def test_generate_cached_prefix_matches_jax_and_concatenation(scan_layers):
    _, model, variables, port = _dense(scan_layers)
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 256, (1, 7)).astype(np.int32)
    sufs = rng.randint(1, 256, (2, 5)).astype(np.int32)
    pc = jgen.prefill_prefix(model, variables, jnp.asarray(prefix))
    want = jgen.generate_cached(model, variables, jnp.asarray(sufs), jax.random.PRNGKey(0),
                                max_new_tokens=NEW, temperature=0.0, prefix_cache=pc)
    tpc = tgen.prefill_prefix(port, torch.from_numpy(prefix).long())
    got = tgen.generate_cached(port, torch.from_numpy(sufs).long(), None, max_new_tokens=NEW,
                               temperature=0.0, prefix_cache=tpc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    whole = np.concatenate([np.repeat(prefix, 2, 0), sufs], axis=1)
    concat = tgen.generate_cached(port, torch.from_numpy(whole).long(), None,
                                  max_new_tokens=NEW, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), concat[:, prefix.shape[1]:].numpy())


def test_generate_ragged_prefix_matches_jax_and_concatenation():
    _, model, variables, port = _dense()
    rng = np.random.RandomState(1)
    prefix = rng.randint(1, 256, (1, 9)).astype(np.int32)
    sufs = [rng.randint(1, 256, (n,)).tolist() for n in (3, 6, 1)]
    lens = np.array([len(s) for s in sufs], np.int32)
    padded = np.zeros((3, lens.max()), np.int32)
    for i, s in enumerate(sufs):
        padded[i, : len(s)] = s
    pc = jgen.prefill_prefix(model, variables, jnp.asarray(prefix))
    want = jgen.generate_ragged(model, variables, jnp.asarray(padded), jnp.asarray(lens),
                                jax.random.PRNGKey(0), max_new_tokens=NEW, temperature=0.0,
                                prefix_cache=pc)
    tpc = tgen.prefill_prefix(port, torch.from_numpy(prefix).long())
    got = tgen.generate_ragged(port, torch.from_numpy(padded).long(), torch.from_numpy(lens),
                               None, max_new_tokens=NEW, temperature=0.0, prefix_cache=tpc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, s in enumerate(sufs):
        whole = torch.tensor([prefix[0].tolist() + s])
        concat = tgen.generate_cached(port, whole, None, max_new_tokens=NEW, temperature=0.0)
        assert got[i, : len(s) + NEW].tolist() == concat[0, prefix.shape[1]:].tolist(), i


def test_prefix_cache_unchanged_after_two_calls():
    """Two calls from one prefix cache (batch 1, then a ragged batch of 2)
    leave every leaf of it as it was, counters included; the tiled cache
    is new storage."""
    _, _, _, port = _dense()
    tpc = tgen.prefill_prefix(port, torch.tensor([[5, 17, 200, 9]]))
    before = {k: v.clone() for k, v in _flat(tpc).items()}
    first = tgen.generate_cached(port, torch.tensor([[3, 4]]), None, max_new_tokens=NEW,
                                 temperature=0.0, prefix_cache=tpc)
    tgen.generate_ragged(port, torch.tensor([[3, 4], [8, 0]]), torch.tensor([2, 1]), None,
                         max_new_tokens=NEW, temperature=0.0, prefix_cache=tpc)
    again = tgen.generate_cached(port, torch.tensor([[3, 4]]), None, max_new_tokens=NEW,
                                 temperature=0.0, prefix_cache=tpc)
    assert torch.equal(first, again)
    after = _flat(tpc)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert int(tgen.prefix_length(tpc)) == 4
    tiled = _flat(tgen.tile_prefix_cache(tpc, 1))
    assert all(tiled[k].data_ptr() != t.data_ptr() for k, t in after.items())


def test_prefix_caching_refuses_nsa():
    nsa_cfg = tiny_config()
    _, nsa_vars = jax_variables(nsa_cfg)
    nsa = port_model(nsa_cfg, nsa_vars)
    with pytest.raises(ValueError, match="dense-causal"):
        tgen.prefill_prefix(nsa, torch.tensor([[1, 2, 3]]))
    _, _, _, dense = _dense()
    tpc = tgen.prefill_prefix(dense, torch.tensor([[1, 2, 3]]))
    with pytest.raises(ValueError, match="dense-causal"):
        tgen.generate_cached(nsa, torch.tensor([[4, 5]]), None, max_new_tokens=2,
                             temperature=0.0, prefix_cache=tpc)
    with pytest.raises(ValueError, match="dense-causal"):
        tgen.generate_ragged(nsa, torch.tensor([[4, 5]]), torch.tensor([2]), None,
                             max_new_tokens=2, temperature=0.0, prefix_cache=tpc)
    with pytest.raises(ValueError, match="one sequence"):
        tgen.prefill_prefix(dense, torch.tensor([[1, 2], [3, 4]]))


SHAPE = ["--d_model", "32", "--num_layers", "1", "--num_heads", "2", "--num_experts", "2",
         "--window_size", "8", "--seq_len", "64", "--max_new_tokens", "3",
         "--temperature", "0", "--device", "cpu"]


def test_serve_prefix_ids(tmp_path, capsys):
    """--prefix_ids: the single-prompt and the ragged batch paths reuse the
    prefix and print prompt + continuation only, and a row of the batch
    equals the single prompt's; the tokens equal the port's decode of the
    concatenated prompt."""
    rows = serve.main([*SHAPE, "--no_nsa", "--prompt_ids", "5,17,20", "--prefix_ids", "8,1,9"])
    assert "shared prefix prefilled once (3 tokens)" in capsys.readouterr().out
    assert rows[0][:3] == [5, 17, 20] and len(rows[0]) == 6
    whole = serve.main([*SHAPE, "--no_nsa", "--prompt_ids", "8,1,9,5,17,20"])
    assert whole[0][3:] == rows[0]
    pf = tmp_path / "prompts.txt"
    pf.write_text("5,17,20\n9,9\n")
    batch = serve.main([*SHAPE, "--no_nsa", "--prompts_file", str(pf), "--prefix_ids", "8,1,9"])
    assert batch[0] == rows[0] and batch[1][:2] == [9, 9] and len(batch[1]) == 5


@pytest.mark.parametrize("flags,match", [
    ([], "dense-causal"),  # NSA, the flags' default
    (["--no_nsa", "--beam_size", "2"], "greedy/sampled"),
    (["--no_nsa", "--draft_checkpoint_dir", "x"], "greedy/sampled"),
])
def test_serve_prefix_ids_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        serve.main([*SHAPE, *flags, "--prompt_ids", "5,17", "--prefix_ids", "8,1"])


# The decode pool and the daemon (the pool and HTTP cases of
# tests/test_prefix.py): held to the JAX package's greedy tokens of the
# concatenated prompt.
_RNG = np.random.RandomState(2)
POOL_PREFIX = _RNG.randint(1, 256, 6).tolist()
POOL_SUFFIXES = [_RNG.randint(1, 256, n).tolist() for n in (3, 5, 2, 4, 7)]
POOL_BUDGETS = [4, 2, 5, 3, 4]
LONG_PREFIX = list(range(1, 40))  # 39 tokens of 64
SYSTEM = [8, 1, 9]


@pytest.fixture(scope="module")
def pool_dense(tmp_path_factory):
    v = checkpoint(tmp_path_factory, "dense",
                   [POOL_PREFIX + s for s in POOL_SUFFIXES] + [SYSTEM + [5, 17, 20], [5, 17, 20]],
                   5)
    return add_refs(v, [LONG_PREFIX + [1] * 20], 5)


def test_decode_pool_prefix_and_streaming_exact(pool_dense):
    """Requests from a registered prefix through a 2-slot pool (slots
    reused) equal the concatenated prompt's tokens; on_token streams the
    continuation in order; the prefix cache is left exactly as it was."""
    pool = DecodePool(pool_dense.port, rows=2, temperature=0.0)
    pid = pool.register_prefix(POOL_PREFIX)
    before = {k: v.clone() for k, v in _flat(pool._prefixes[pid][0]).items()}
    streamed = {}
    rids = [pool.submit(s, max_new_tokens=b, prefix_id=pid,
                        on_token=lambda r, t: streamed.setdefault(r, []).append(t))
            for s, b in zip(POOL_SUFFIXES, POOL_BUDGETS)]
    results = drain(pool)
    n = len(POOL_PREFIX)
    for rid, s, b in zip(rids, POOL_SUFFIXES, POOL_BUDGETS):
        w = want(pool_dense, POOL_PREFIX + s, b)[n:]
        assert results[rid] == w, rid
        assert streamed[rid] == w[len(s):], rid
    after = _flat(pool._prefixes[pid][0])
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_decode_pool_prefix_budget_guard(pool_dense):
    """prefix + prompt + budget past max_seq_len is refused; a suffix that
    ends at the cache's last rows decodes exactly."""
    pool = DecodePool(pool_dense.port, rows=1, temperature=0.0)
    pid = pool.register_prefix(LONG_PREFIX)
    with pytest.raises(ValueError, match="max_seq_len"):
        pool.submit([1] * 20, max_new_tokens=10, prefix_id=pid)
    with pytest.raises(IndexError):
        pool.submit([1], max_new_tokens=1, prefix_id=pid + 1)
    rid = pool.submit([1] * 20, max_new_tokens=5, prefix_id=pid)
    assert drain(pool)[rid] == want(pool_dense, LONG_PREFIX + [1] * 20, 5)[39:]


def test_http_system_prefix_both_modes(pool_dense):
    """--prefix_ids on the daemon: the ragged batch and the pool give the
    same tokens, the JAX greedy tokens of the concatenated prompt."""
    outs = {}
    for extra in ([], ["--continuous"]):
        srv, batcher, url = start_server(pool_dense.ckpt, "--prefix_ids", "8,1,9", *extra,
                                         max_new=4)
        try:
            assert batcher.prefix_len == 3
            outs[bool(extra)] = post(url, {"prompt_ids": [5, 17, 20]})["output_ids"]
        finally:
            stop_server(srv, batcher)
    assert outs[False] == outs[True] == want(pool_dense, SYSTEM + [5, 17, 20], 4)[3:]


def test_http_sse_streaming(pool_dense):
    """{"stream": true}: SSE events whose tokens reassemble the final
    output, the greedy tokens; batch mode refuses streaming."""
    srv, batcher, url = start_server(pool_dense.ckpt, "--continuous", max_new=4)
    try:
        req = urllib.request.Request(
            url + "/generate", json.dumps({"prompt_ids": [5, 17, 20], "stream": True}).encode(),
            {"Content-Type": "application/json"})
        events = []
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            for raw in r:
                line = raw.decode().strip()
                if line.startswith("data: "):
                    events.append(json.loads(line[len("data: "):]))
        assert events[-1]["done"] is True
        toks = [e["token"] for e in events[:-1]]
        assert events[-1]["output_ids"] == [5, 17, 20] + toks
        assert toks == want(pool_dense, [5, 17, 20], 4)[3:]
    finally:
        stop_server(srv, batcher)
    srv, batcher, url = start_server(pool_dense.ckpt)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(url, {"prompt_ids": [5, 17], "stream": True})
        assert e.value.code == 400
    finally:
        stop_server(srv, batcher)
