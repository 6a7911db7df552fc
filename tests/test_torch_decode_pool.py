"""The port's continuous batching (forde_tpu_torch.models.decode_pool)
against the JAX package, with the same weights (test_torch_decoder_lm.py's
small config: window 16, compression ratio 4, top-k 8, max_seq_len 64), on
the dense-causal and the NSA variant.

Every request that flows through the pool must give exactly the greedy
tokens of the JAX package's ``generate_ragged`` (whose rows its own tests
hold to ``generate_cached``) on its prompt: the pool changes when work
happens, never the tokens. Cases of tests/test_decode_pool.py: more
requests than rows, a join mid-flight with an EOS, ``decode_fuse`` > 1
exact (an EOS and budgets inside a fused call) and streaming in order, NSA
refusing chunked prefill.

The pool's graph path rehearsed on the CPU (``graphs.on_card`` patched to
True, ``graphs.StepGraph`` replaced by a class whose warm-up runs the step
and whose replay runs it again): every tensor of the pool's state keeps
its storage across ticks, admissions, cancels and prefix suffixes, as a
replayed CUDA graph needs, the graphs are at most four over one state, and
the tokens equal the eager pool's.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu_torch.core import graphs
from forde_tpu_torch.models import decode_pool as tpool
from forde_tpu_torch.models import generate as tgen
from forde_tpu_torch.models.decode_pool import DecodePool

from test_torch_decoder_lm import jax_variables, port_model, tiny_config

torch.set_num_threads(1)

_RNG = np.random.RandomState(1)
# lengths below the window (16), past it and past window + ratio
PROMPTS = [_RNG.randint(1, 256, n).tolist() for n in (3, 18, 22, 7, 26)]
BUDGETS = [4, 6, 5, 3, 6]
P0, P1, P2, P3 = [5, 17, 20], [9, 9], [7, 3, 11, 8], [7, 3, 11]
NEW = 10  # the references' new tokens; every budget here is at most this


def jax_greedy(model, variables, prompts, new):
    """The JAX package's greedy tokens: one ``generate_ragged`` call over
    ``prompts``; each row is its prompt and ``new`` tokens."""
    lens = np.array([len(p) for p in prompts], np.int32)
    padded = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
    out = np.asarray(jgen.generate_ragged(
        model, variables, jnp.asarray(padded), jnp.asarray(lens), jax.random.PRNGKey(0),
        max_new_tokens=new, temperature=0.0,
    ))
    return [out[i, : n + new].tolist() for i, n in enumerate(lens)]


def drain(pool, limit=300):
    """tick() until the pool is empty: {request id: output ids}."""
    results, ticks = {}, 0
    while pool.pending():
        results.update(dict(pool.tick()))
        ticks += 1
        assert ticks < limit, "pool did not drain"
    return results


def add_refs(v, prompts, new=NEW):
    """Add the JAX greedy rows of ``prompts`` to ``v.refs``."""
    if prompts:
        v.refs.update(zip(map(tuple, prompts), jax_greedy(*v.jax, prompts, new)))
    return v


def setup_variant(name, prompts, new=NEW):
    """The dense or NSA config: its JAX model and variables (``jax``), the
    port's model holding them (``port``), and {prompt: JAX greedy row}
    (``refs``)."""
    cfg = tiny_config(**({} if name == "nsa" else dict(use_sparse_attention=False)))
    model, variables = jax_variables(cfg)
    v = SimpleNamespace(name=name, cfg=cfg, jax=(model, variables),
                        port=port_model(cfg, variables), refs={})
    return add_refs(v, prompts, new)


def want(v, prompt, budget, eos=None):
    """The JAX greedy row of ``prompt``: ``budget`` new tokens, cut after
    the first ``eos`` among them."""
    row = v.refs[tuple(prompt)][: len(prompt) + budget]
    new = row[len(prompt):]
    return row if eos not in new else row[: len(prompt) + new.index(eos) + 1]


@pytest.fixture(scope="module", params=["dense", "nsa"])
def variant(request):
    return setup_variant(request.param, PROMPTS + [P0, P1, P2, P3])


def test_pool_more_requests_than_rows_all_exact(variant):
    """5 mixed-length requests through a 2-slot pool: slots are reused and
    every output equals the JAX greedy tokens."""
    pool = DecodePool(variant.port, rows=2, temperature=0.0)
    rids = [pool.submit(p, max_new_tokens=b) for p, b in zip(PROMPTS, BUDGETS)]
    results = drain(pool)
    assert set(results) == set(rids)
    for rid, p, b in zip(rids, PROMPTS, BUDGETS):
        assert results[rid] == want(variant, p, b), rid
    assert pool.active_rows() == 0 and not pool.queue


def test_pool_mid_flight_join_and_eos(variant):
    """A request submitted while others decode joins a free slot without
    disturbing them; an EOS frees a slot early."""
    eos0 = want(variant, P0, 6)[len(P0) + 1]  # the second generated token (or the first)
    pool = DecodePool(variant.port, rows=2, temperature=0.0)
    r0 = pool.submit(P0, max_new_tokens=6, eos_id=eos0)
    r1 = pool.submit(P1, max_new_tokens=5)
    results, ticks, r2 = {}, 0, None
    while pool.pending() or r2 is None:
        if ticks == 2:
            r2 = pool.submit(P2, max_new_tokens=3)
        results.update(dict(pool.tick()))
        ticks += 1
        assert ticks < 100
    assert results[r0] == want(variant, P0, 6, eos0)
    assert results[r1] == want(variant, P1, 5)
    assert results[r2] == want(variant, P2, 3)


def test_pool_decode_fuse_token_exact(variant):
    """decode_fuse 4 gives the unfused greedy tokens, with an EOS and a
    budget inside a fused call (the surplus discarded) and a request that
    joins after the pool went fused."""
    eos0 = want(variant, P0, 10)[len(P0) + 2]  # the third generated token (or earlier)
    pool = DecodePool(variant.port, rows=2, temperature=0.0, decode_fuse=4)
    r0 = pool.submit(P0, max_new_tokens=10, eos_id=eos0)
    r1 = pool.submit(P1, max_new_tokens=9)  # not a multiple of 4
    results, ticks, r2 = {}, 0, None
    while pool.pending() or r2 is None:
        if ticks == 1:
            r2 = pool.submit(P3, max_new_tokens=5)
        results.update(dict(pool.tick()))
        ticks += 1
        assert ticks < 100
    assert results[r0] == want(variant, P0, 10, eos0)
    assert results[r1] == want(variant, P1, 9)
    assert results[r2] == want(variant, P3, 5)


def test_pool_decode_fuse_streams_in_order(variant):
    """Fused ticks fire on_token once per kept token, in order."""
    pool = DecodePool(variant.port, rows=2, temperature=0.0, decode_fuse=4)
    seen = []
    rid = pool.submit(P0, max_new_tokens=6, on_token=lambda r, tok: seen.append((r, tok)))
    drain(pool)
    assert seen == [(rid, t) for t in want(variant, P0, 6)[len(P0):]]


def test_pool_nsa_rejects_chunked_prefill():
    cfg = tiny_config()
    _, variables = jax_variables(cfg)
    with pytest.raises(ValueError, match="dense-causal"):
        DecodePool(port_model(cfg, variables), rows=2, prefill_chunk=8)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _state_leaves(pool):
    st = pool.static
    return _leaves({"cache": st.cache, "tokens": st.tokens, "positions": st.positions,
                    "temps": st.temps, "topks": st.topks, "topps": st.topps, "out": st.out})


def test_insert_row_copies_every_batched_leaf(variant):
    """_insert_row writes the slot of every leaf with a batch axis (the NSA
    ring, chunk sum, pools and top-k set included) and nothing else: the
    other slots and the 0-d counters stay."""
    port = variant.port
    pool_cache = port.init_cache(3)
    for leaf in _leaves(pool_cache).values():
        leaf.fill_(7)
    prompt = torch.tensor([PROMPTS[4]])
    if variant.name == "nsa":
        row, _ = tgen.nsa_prefill(port, prompt)
    else:
        row = port.init_cache(1)
        port(prompt, cache=row)
    tpool._insert_row(pool_cache, row, 1)
    rows = _leaves(row)
    for path, leaf in _leaves(pool_cache).items():
        if leaf.ndim == 0:
            assert int(leaf) == 7, path
            continue
        assert torch.equal(leaf[1], rows[path][0].to(leaf.dtype)), path
        assert (leaf[0] == 7).all() and (leaf[2] == 7).all(), path


class _FakeStepGraph:
    """StepGraph without CUDA: the warm-up runs the step, the capture runs
    nothing, each replay runs the step again."""

    made = []

    def __init__(self, step, generators=()):
        self.step, self.generators = step, tuple(generators)
        _FakeStepGraph.made.append(self)
        step()

    def replay(self):
        self.step()


@pytest.fixture
def fake_graphs(monkeypatch):
    _FakeStepGraph.made = []
    monkeypatch.setattr(graphs, "on_card", lambda t: True)
    monkeypatch.setattr(graphs, "StepGraph", _FakeStepGraph)
    return _FakeStepGraph.made


def _run_mixed(pool, check=None):
    """Requests with greedy, sampled and filtered settings, a cancel of an
    active and of a queued request, (dense) a prefix suffix, and last a
    greedy request alone; ``check()`` after every tick."""
    prefix = None
    if not pool._nsa:
        prefix = pool.register_prefix([8, 1, 9, 4])
    rids = [
        pool.submit(PROMPTS[0], 5),
        pool.submit(PROMPTS[1], 6, temperature=0.9, top_k=20),
        pool.submit(PROMPTS[2], 4, temperature=0.7),
        pool.submit(P0, 6, prefix_id=prefix),
        pool.submit(PROMPTS[3], 7, temperature=1.1, top_p=0.8),
        pool.submit(P1, 3),
    ]
    results, ticks = {}, 0
    while pool.pending():
        results.update(dict(pool.tick()))
        ticks += 1
        if ticks == 1:
            assert pool.cancel(rids[1]) and pool.cancel(rids[5])
        if check is not None:
            check()
        if not pool.pending() and len(results) == 4:
            pool.submit(P2, 4)  # alone: the unfiltered step
    return results


def test_pool_graph_path_keeps_its_storage_and_tokens(variant, fake_graphs):
    """On the graph path (rehearsed) every tensor of the pool's state keeps
    its object and storage through admissions, cancels, finishes and
    prefix suffixes; the graphs (at most four: filtered or not, 1 or
    decode_fuse steps) all draw from the pool's generator; the tokens,
    sampled ones included, equal the eager pool's with the same seed."""
    for fuse in (1, 3):
        graphed = DecodePool(variant.port, rows=3, temperature=0.0, seed=5, decode_fuse=fuse)
        before = {k: (t, t.data_ptr()) for k, t in _state_leaves(graphed).items()}
        assert any("/cache/" in k for k in before)

        def check():
            after = _state_leaves(graphed)
            assert sorted(after) == sorted(before)
            for k, (t, ptr) in before.items():
                assert after[k] is t and t.data_ptr() == ptr, k

        got = _run_mixed(graphed, check)
        eager = _run_mixed(DecodePool(variant.port, rows=3, temperature=0.0, seed=5,
                                      decode_fuse=fuse, cuda_graph=False))
        assert got == eager
        keys = set(graphed._graphs)
        assert keys <= {(False, 1), (True, 1), (False, fuse), (True, fuse)}
        assert (True, fuse) in keys and (False, fuse) in keys
        assert all(g.generators == (graphed._gen,) for g in graphed._graphs.values())
    assert len(fake_graphs) == 4  # two per pool
