"""The readers of ``moe.routed_share`` and ``moe.routed_share.serve``: the
share of dense-dispatch MoE calls that ran routed, from the port's counters
``moe.routed`` and ``moe.dense``; None on a port without them."""

import collections
from types import SimpleNamespace

import pytest

from h100bench import lookup, program_spans

NAMES = ("moe.routed_share", "moe.routed_share.serve")


@pytest.fixture
def counters(monkeypatch):
    """A port whose recorder holds these counters."""
    counts = collections.Counter()
    fake = SimpleNamespace(snapshot=lambda: (dict(counts), {}))
    monkeypatch.setattr(program_spans, "program", lambda: fake)
    return counts


@pytest.mark.parametrize("name", NAMES)
def test_no_counters_read_nothing(counters, name):
    counters["pool.steps"] = 5  # another counter only: the parent's port
    assert lookup.metric(name).read(None) is None


@pytest.mark.parametrize("name", NAMES)
def test_only_routed_calls_read_100(counters, name):
    counters["moe.routed"] = 36
    assert lookup.metric(name).read(None) == 100.0


@pytest.mark.parametrize("name", NAMES)
def test_a_mix_reads_the_routed_share(counters, name):
    counters.update({"moe.routed": 3, "moe.dense": 9})
    assert lookup.metric(name).read(None) == pytest.approx(25.0)
    counters["moe.routed"] = 0
    assert lookup.metric(name).read(None) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_a_port_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(program_spans, "program", lambda: None)
    assert lookup.metric(name).read(None) is None


def test_the_port_counts_each_path():
    """The port's own counters, after one routed and one dense call of a
    tiny MoE layer, give the reader its share."""
    import torch

    from forde_tpu_torch.nn import moe
    from forde_tpu_torch.obs import spans

    layer = moe.MoELayer(num_experts=4, top_k=2, expert_hidden_dim=8, d_model=8)
    before = spans.snapshot()[0]
    x = torch.randn(1, 16, 8)  # 8 routed rows an expert
    saved = moe.ROUTED_MIN_ROWS
    try:
        for min_rows in (8, 9):  # routed at the constant, dense above the mean
            moe.ROUTED_MIN_ROWS = min_rows
            layer(x)
    finally:
        moe.ROUTED_MIN_ROWS = saved
    after = spans.snapshot()[0]
    for key in ("moe.routed", "moe.dense"):
        assert after.get(key, 0) - before.get(key, 0) == 1, key
    share = lookup.metric("moe.routed_share").read(None)
    assert share is not None and 0.0 < share < 100.0
