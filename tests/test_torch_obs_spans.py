"""The port's span and counter recorder (forde_tpu_torch.obs.spans) on the
CPU: parents of nested spans, request ids, the ring's bound, no profiler
range while no profiler is open, the ``forde.<name>`` ranges of an open
profiler on the clock ``to_profiler_ns`` gives; and the spans and
counters the decode pool and the LM train step leave, which change no
token and no loss.
"""

import contextlib

import pytest
import torch

from forde_tpu_torch.core.config import LLMConfig
from forde_tpu_torch.models.decode_pool import DecodePool
from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
from forde_tpu_torch.obs import spans
from forde_tpu_torch.train.state import create_train_state
from forde_tpu_torch.train.step import train_step

torch.set_num_threads(1)

REQUESTS = [(5, 4), (20, 3), (9, 5), (14, 2)]  # (prompt length, max_new_tokens)
TRAIN = ("train.forward", "train.backward", "train.optimizer")


def tiny_lm(seed=0):
    torch.manual_seed(seed)
    cfg = LLMConfig(vocab_size=256, d_model=32, num_layers=2, num_heads=2, head_dim=16,
                    max_seq_len=64, num_experts=4, top_k_experts=2, expert_hidden_dim=64,
                    window_size=16, compression_ratio=4, top_k_global=8, num_streams=2,
                    sinkhorn_iterations=3, dropout_rate=0.0)
    return cfg, FORDEDecoderLM(cfg)


def serve_tiny():
    """Every request of REQUESTS through a 2-row NSA pool, greedy, no EOS:
    {request id: output ids}."""
    _, model = tiny_lm()
    pool = DecodePool(model.eval(), rows=2, temperature=0.0, decode_fuse=1)
    rids = [pool.submit([(7 * i + j) % 255 + 1 for j in range(n)], max_new_tokens=new)
            for i, (n, new) in enumerate(REQUESTS)]
    out = {}
    while pool.pending():
        out.update(dict(pool.tick()))
    assert set(out) == set(rids)
    return out


def train_tiny(steps=2):
    """``steps`` LM train steps from one seed: their total losses."""
    cfg, model = tiny_lm()
    state = create_train_state(cfg, None, 1e-3, 0.01, model=model)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(steps):
        ids = torch.randint(1, cfg.vocab_size, (2, 32), generator=gen)
        state, m = train_step(state, {"input_ids": ids}, aux_loss_weight=0.01)
        losses.append(float(m["loss/total"]))
    return losses


class _Range:
    """A stand-in for the profiler's range: counts entries and exits, and
    raises on entry if told to."""

    def __init__(self, log, fail):
        self.log, self.fail = log, fail

    def __enter__(self):
        if self.fail:
            raise RuntimeError("range refused")
        self.log.append("enter")

    def __exit__(self, *exc):
        self.log.append("exit")


@pytest.mark.parametrize("fails", ["range", "events"])
def test_a_span_that_fails_to_open_leaves_no_parent_behind(monkeypatch, fails):
    """Whether the profiler's range or the device's events raise on entry,
    the thread's stack is as before, the range is closed, and the next
    span is a root that inherits no request."""
    log = []
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: _Range(log, fails == "range"))

    def refuse():
        raise RuntimeError("no stream")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", refuse)
    rec = spans.Recorder()
    with pytest.raises(RuntimeError):
        with rec.span("broken", device="cuda", request=5):
            pass
    assert rec._stack() == []
    assert log == ([] if fails == "range" else ["enter", "exit"])
    monkeypatch.undo()
    with rec.span("next"):
        pass
    (only,) = rec.records()
    assert only.name == "next" and only.parent is None and only.request is None


def test_nested_spans_record_their_parent_and_inherit_the_request():
    rec = spans.Recorder()
    with rec.span("outer", request=7):
        with rec.span("middle"):
            with rec.span("inner"):
                pass
        rec.interval("wait", 1, 2, request=9)
    with rec.span("alone"):
        pass
    by = {r.name: r for r in rec.records()}
    assert by["outer"].parent is None and by["alone"].parent is None
    assert by["middle"].parent == by["outer"].id
    assert by["inner"].parent == by["middle"].id
    assert by["wait"].parent == by["outer"].id
    requests = [by[n].request for n in ("outer", "middle", "inner", "wait", "alone")]
    assert requests == [7, 7, 7, 9, None]
    assert all(r.start_ns <= r.end_ns and r.device_ns is None for r in by.values())
    counters, aggregates = rec.snapshot()
    assert counters == {} and aggregates["inner"][0] == 1


def test_the_ring_keeps_the_newest_records_and_every_aggregate():
    rec = spans.Recorder(capacity=8)
    for i in range(20):
        with rec.span("s", request=i):
            pass
        rec.count("n")
    kept = rec.records()
    assert len(kept) == 8 and [r.request for r in kept] == list(range(12, 20))
    counters, aggregates = rec.snapshot()
    assert counters == {"n": 20}
    count, total, longest = aggregates["s"]
    assert count == 20 and 0 <= longest <= total
    rec.reset()
    assert rec.records() == [] and rec.snapshot() == ({}, {})


def test_no_profiler_range_while_no_profiler_is_open(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler open")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    rec = spans.Recorder()
    with rec.span("train.forward", device=torch.device("cpu")):
        torch.ones(4).sum()
    assert [r.name for r in rec.records()] == ["train.forward"]


def test_an_open_profiler_shows_each_span_on_the_same_clock():
    from torch.profiler import ProfilerActivity, profile

    rec = spans.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with rec.span("probe", request=i):
                with rec.span("probe.inner"):
                    torch.ones(8).add_(1)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(spans.PREFIX)]
    for name in ("probe", "probe.inner"):
        starts = sorted(e.start_ns() for e in events if e.name() == spans.PREFIX + name)
        records = sorted(r.start_ns for r in rec.records() if r.name == name)
        assert len(starts) == len(records) == 5
        for annotated, start in zip(starts, records):
            assert abs(annotated - spans.to_profiler_ns(start)) < 1_000_000


def test_the_pool_counts_its_work_and_tags_each_request():
    spans.reset()
    out = serve_tiny()
    counters, aggregates = spans.snapshot()
    assert counters["pool.submitted"] == counters["pool.admitted"] == len(out)
    assert counters["pool.rows_stepped"] == sum(new - 1 for _, new in REQUESTS)
    assert counters["pool.steps"] == aggregates["pool.step"][0]
    records = spans.records()
    by_id = {r.id: r for r in records}
    for rid in out:
        mine = [r for r in records if r.request == rid]
        names = [r.name for r in mine]
        assert names == ["pool.queue", "prefill.forward", "prefill.cache", "pool.prefill",
                         "pool.insert"], names
        queue, forward, cache, prefill, insert = mine
        assert queue.end_ns <= prefill.start_ns <= prefill.end_ns <= insert.start_ns
        assert by_id[forward.parent] is prefill and by_id[cache.parent] is prefill
        assert forward.end_ns <= cache.start_ns
    assert all(r.request is None and r.device_ns is None for r in records
               if r.name == "pool.step")


def test_a_train_step_has_one_forward_backward_and_optimizer_in_order():
    spans.reset()
    train_tiny(steps=3)
    records = [r for r in spans.records() if r.name in TRAIN]
    assert [r.name for r in records] == list(TRAIN) * 3
    for a, b in zip(records, records[1:]):
        assert a.end_ns <= b.start_ns
    assert all(r.device_ns is None and r.parent is None for r in records)


@contextlib.contextmanager
def recorder_removed(monkeypatch):
    """The program with every span and counter call a no-op."""
    with monkeypatch.context() as m:
        m.setattr(spans, "span", lambda *a, **k: contextlib.nullcontext())
        m.setattr(spans, "interval", lambda *a, **k: None)
        m.setattr(spans, "count", lambda *a, **k: None)
        yield


@pytest.mark.parametrize("run", [serve_tiny, train_tiny], ids=["pool_tokens", "train_losses"])
def test_spans_change_no_token_and_no_loss(monkeypatch, run):
    recorded = run()
    with recorder_removed(monkeypatch):
        spans.reset()
        plain = run()
    assert spans.records() == []
    assert recorded == plain
