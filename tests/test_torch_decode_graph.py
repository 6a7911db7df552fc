"""The port's decode step in the form a CUDA graph captures
(forde_tpu_torch.models.generate, forde_tpu_torch.core.graphs), on the
CPU with the small config of test_torch_decoder_lm.py:

* every tensor a decode step reads or writes (each cache leaf, the token,
  the EOS mask, the positions, the step counter, the token buffer) keeps
  its storage from step to step, which a replayed graph needs;
* the decode with its step counter on the device gives the greedy tokens
  of the earlier loop, whose counter was a Python int, and of the JAX
  package: exactly equal, as tests/test_torch_generate.py holds them;
* ``StepGraph`` with stub CUDA calls: the warm-up counts its kernel
  launches, the capture's are taken back, every replay adds them again;
  the warm-up runs under the "error" sync debug mode; the generators are
  registered with the graph.
"""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forde_tpu.models import generate as jgen
from forde_tpu_torch import kernels
from forde_tpu_torch.core import graphs
from forde_tpu_torch.models import generate as tgen

from test_torch_decoder_lm import jax_variables, port_model, tiny_config
from test_torch_generate import LENS, NEW, _prompts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setups():
    out = {}
    for name, kw in (("nsa", {}), ("dense", dict(use_sparse_attention=False))):
        cfg = tiny_config(**kw)
        model, variables = jax_variables(cfg)
        out[name] = (model, variables, port_model(cfg, variables))
    return out


@torch.no_grad()
def _first_state(port, ids, lens):
    sampling = (0.0, None, None, None, 0)
    if port.config.use_sparse_attention:
        cache, last = tgen.nsa_prefill(port, ids, lens)
    else:
        cache = port.init_cache(ids.shape[0])
        logits, _ = port(ids, cache=cache)
        last = logits[:, -1] if lens is None else logits[torch.arange(ids.shape[0]), lens - 1]
    return tgen._first_state(port, cache, last, None, sampling, lens), sampling


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {} if tree is None else {prefix: tree}


@pytest.mark.parametrize("variant", ["nsa", "dense"])
@pytest.mark.parametrize("ragged", [False, True])
def test_decode_state_keeps_its_storage(setups, variant, ragged):
    _, _, port = setups[variant]
    prompts, padded = _prompts(seed=5)
    if ragged:
        ids, lens = torch.from_numpy(padded).long(), torch.tensor(LENS)
    else:
        ids, lens = torch.tensor([prompts[3]]), None
    st, sampling = _first_state(port, ids, lens)
    fields = {"cache": st.cache, "token": st.token, "done": st.done,
              "positions": st.positions, "t": st.t, "out": st.out}
    before = {k: (v, v.data_ptr()) for k, v in _leaves(fields).items()}
    assert any("/cache/" in k for k in before) and "/t" in before
    with torch.no_grad():
        for step in range(4):
            tgen._decode_step(port, st, None, sampling)
            after = _leaves({"cache": st.cache, "token": st.token, "done": st.done,
                             "positions": st.positions, "t": st.t, "out": st.out})
            assert sorted(after) == sorted(before)
            for k, (tensor, ptr) in before.items():
                assert after[k] is tensor and tensor.data_ptr() == ptr, (step, k)
    assert int(st.t) == 4


@torch.no_grad()
def _old_generate_ragged(port, ids, lens, new):
    """The decode loop before the step counter moved onto the device: the
    step index a Python int in ``positions + t`` and the write column."""
    b, p = ids.shape
    bidx = torch.arange(b)
    if port.config.use_sparse_attention:
        cache, last = tgen.nsa_prefill(port, ids, lens)
    else:
        cache = port.init_cache(b)
        logits, _ = port(ids, cache=cache)
        last = logits[bidx, lens - 1]
    token = torch.argmax(last, dim=-1)
    out = torch.zeros(b, p + new, dtype=torch.int64)
    cols = torch.arange(p + new)
    out[:, :p] = torch.where(cols[None, :p] < lens[:, None], ids, out[:, :p])
    out[bidx, lens] = token
    for t in range(new - 1):
        logits, _ = port(token[:, None], cache=cache, positions=lens + t)
        token = torch.argmax(logits[:, 0], dim=-1)
        out[bidx, lens + 1 + t] = token
    return out


@pytest.mark.parametrize("variant", ["nsa", "dense"])
def test_device_counter_decode_matches_earlier_loop_and_jax(setups, variant):
    model, variables, port = setups[variant]
    _, padded = _prompts(seed=6)
    ids, lens = torch.from_numpy(padded).long(), torch.tensor(LENS)
    got = tgen.generate_ragged(port, ids, lens, None, max_new_tokens=NEW, temperature=0.0)
    old = _old_generate_ragged(port, ids, lens, NEW)
    want = jgen.generate_ragged(
        model, variables, jnp.asarray(padded), jnp.asarray(LENS, jnp.int32),
        jax.random.PRNGKey(0), max_new_tokens=NEW, temperature=0.0,
    )
    np.testing.assert_array_equal(got.numpy(), old.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_graph_keyword_changes_nothing_on_the_cpu(setups):
    _, _, port = setups["nsa"]
    prompts, _ = _prompts(seed=7)
    ids = torch.tensor([prompts[2]])
    a = tgen.generate_cached(port, ids, None, max_new_tokens=NEW, temperature=0.0)
    b = tgen.generate_cached(port, ids, None, max_new_tokens=NEW, temperature=0.0,
                             cuda_graph=False)
    assert torch.equal(a, b)
    assert not hasattr(port, "_decode_graphs") or not port._decode_graphs


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    def __init__(self):
        self.generators, self.replays = [], 0

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """Stub CUDA calls for StepGraph, a stub launch counter, and a log of
    what ran in which mode."""
    state = {"mode": "eager", "debug": 0, "log": []}
    monkeypatch.setattr(kernels, "launches", collections.Counter())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["debug"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda mode: state.__setitem__("debug", mode))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)

    @contextlib.contextmanager
    def capture(graph, pool=None, capture_error_mode="global"):
        state["log"].append(("capture_mode", capture_error_mode))
        state["mode"] = "capture"
        try:
            yield
        finally:
            state["mode"] = "eager"

    monkeypatch.setattr(torch.cuda, "graph", capture)
    return state


def test_step_graph_counts_launches_that_ran(fake_cuda):
    gen = torch.Generator()

    def step():
        fake_cuda["log"].append((fake_cuda["mode"], fake_cuda["debug"]))
        kernels.launches["small_kv_fwd"] += 24
        kernels.launches["topk_replay"] += 1
        return "outputs"

    kernels.launches["flash_fwd"] += 12  # a prefill before the graph
    g = graphs.StepGraph(step, generators=[gen])
    assert fake_cuda["log"] == [("eager", "error"), ("capture_mode", "thread_local"),
                                ("capture", 0)]
    assert fake_cuda["debug"] == 0  # restored after the warm-up
    assert g.warmup_outputs == "outputs" and g.graph.generators == [gen]
    assert g.launches == {"small_kv_fwd": 24, "topk_replay": 1}
    # the warm-up ran; the capture launched nothing
    assert dict(kernels.launches) == {"flash_fwd": 12, "small_kv_fwd": 24, "topk_replay": 1}
    for _ in range(3):
        assert g.replay() == "outputs"
    assert g.graph.replays == 3
    assert dict(kernels.launches) == {"flash_fwd": 12, "small_kv_fwd": 96, "topk_replay": 4}


def test_step_graph_capture_failure_raises(fake_cuda, monkeypatch):
    def broken(graph, pool=None, capture_error_mode="global"):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "graph", broken)
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.StepGraph(lambda: None)


def test_copy_and_clone_trees_keep_storage():
    src = {"a": torch.arange(4.0), "b": [torch.ones(2), None], "c": {"d": torch.zeros(())}}
    dst = graphs.clone_tree(src)
    assert dst["a"].data_ptr() != src["a"].data_ptr() and dst["b"][1] is None
    ptr = dst["a"].data_ptr()
    src["a"].add_(1)
    src["c"]["d"].fill_(5)
    graphs.copy_tree_(dst, src)
    assert dst["a"].data_ptr() == ptr and torch.equal(dst["a"], src["a"])
    assert float(dst["c"]["d"]) == 5.0
    with pytest.raises(KeyError):
        graphs.copy_tree_(dst, {"a": src["a"]})
