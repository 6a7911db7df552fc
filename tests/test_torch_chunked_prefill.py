"""Chunked prefill in the port's decode pool (``DecodePool(prefill_chunk=)``,
dense-causal configs) against the JAX package's greedy tokens, with the
same weights (test_torch_decoder_lm.py's small config, max_seq_len 64).

A prompt prefilled in chunks, one per tick, is the same math as one
prefill (each chunk's k/v land at the row's offset and its queries attend
back over everything written), so the pool stays exact: chunks that
divide, straddle and exceed the prompt, a chunk larger than the room left
in the cache (the last chunk is the length left), a shared prefix, a long
prompt filling while another slot decodes, and a cancel mid-fill (cases of
tests/test_chunked_prefill.py). The prefix's cache is left as it was.
"""

import numpy as np
import pytest
import torch

from forde_tpu_torch.models.decode_pool import DecodePool

from test_torch_decode_pool import add_refs, drain, setup_variant, want

torch.set_num_threads(1)

_RNG = np.random.RandomState(0)
PROMPTS = [_RNG.randint(1, 256, n).tolist() for n in (3, 8, 13, 5, 21)]
PREFIX = _RNG.randint(1, 256, 9).tolist()
SUFFIXES = [_RNG.randint(1, 256, n).tolist() for n in (6, 11, 2)]
LONG = _RNG.randint(1, 256, 32).tolist()  # 8 chunks of 4
SHORT = [5, 17, 20]
NEAR_END = _RNG.randint(1, 256, 58).tolist()  # a chunk of 60 spills past 64 with 4 new


@pytest.fixture(scope="module")
def dense():
    v = setup_variant("dense", PROMPTS + [PREFIX + s for s in SUFFIXES] + [LONG, SHORT], new=4)
    return add_refs(v, [NEAR_END], new=4)


@pytest.mark.parametrize("chunk", [4, 7, 64])
def test_chunked_prefill_token_exact(dense, chunk):
    pool = DecodePool(dense.port, rows=2, temperature=0.0, prefill_chunk=chunk)
    rids = [pool.submit(p, max_new_tokens=4) for p in PROMPTS]
    results = drain(pool)
    for rid, p in zip(rids, PROMPTS):
        assert results[rid] == want(dense, p, 4), (chunk, rid)


def test_chunked_prefill_near_the_cache_end(dense):
    """58 tokens in a chunk of 60 (the JAX pool falls back to a one-shot
    prefill there): the port's last chunk is the 58 tokens left."""
    pool = DecodePool(dense.port, rows=1, temperature=0.0, prefill_chunk=60)
    rid = pool.submit(NEAR_END, max_new_tokens=4)
    assert drain(pool)[rid] == want(dense, NEAR_END, 4)


def test_chunked_prefill_with_prefix(dense):
    """Chunked suffixes continue from a copy of the registered prefix's
    cache: exact against the concatenated prompt, the prefix cache left
    as it was."""
    pool = DecodePool(dense.port, rows=2, temperature=0.0, prefill_chunk=4)
    pid = pool.register_prefix(PREFIX)
    cache = pool._prefixes[pid][0]
    before = {k: v.clone() for k, v in cache["layer_0"]["causal_attention"].items()}
    rids = [pool.submit(s, max_new_tokens=3, prefix_id=pid) for s in SUFFIXES]
    results = drain(pool)
    for rid, s in zip(rids, SUFFIXES):
        assert results[rid] == want(dense, PREFIX + s, 3)[len(PREFIX):], rid
    assert all(torch.equal(cache["layer_0"]["causal_attention"][k], v)
               for k, v in before.items())
    assert int(cache["pos_index"]) == len(PREFIX)


def test_chunked_prefill_overlaps_decoding(dense):
    """While one slot prefills a long prompt a chunk a tick, the other
    keeps decoding: the short request finishes before the long one."""
    pool = DecodePool(dense.port, rows=2, temperature=0.0, prefill_chunk=4)
    rid_long = pool.submit(LONG, max_new_tokens=2)
    rid_short = pool.submit(SHORT, max_new_tokens=3)
    order, results = [], {}
    while pool.pending():
        for rid, out in pool.tick():
            order.append(rid)
            results[rid] = out
    assert order == [rid_short, rid_long]
    assert results[rid_long] == want(dense, LONG, 2)
    assert results[rid_short] == want(dense, SHORT, 3)


def test_cancel_mid_fill_frees_slot(dense):
    pool = DecodePool(dense.port, rows=1, temperature=0.0, prefill_chunk=4)
    rid = pool.submit(LONG, max_new_tokens=4)
    pool.tick()  # admission and the first chunk
    assert pool._filling[0] is not None
    assert pool.cancel(rid) is True
    rid2 = pool.submit(SHORT, max_new_tokens=2)
    results = drain(pool)
    assert set(results) == {rid2}
    assert results[rid2] == want(dense, SHORT, 2)
