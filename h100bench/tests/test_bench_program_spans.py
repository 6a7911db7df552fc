"""The readers of the port's own spans (``program_spans``), on a synthetic
outcome: harness spans, the traced window's kernels and program records
made by hand. Idle gaps go to the innermost program span; the idle shares
of single spans add up to at most the window's idle share; records of the
traced window never enter a timing metric; a prefill's device time is the
card's busy time that started inside its spans. On the card: the program's
spans and the profiler's events share one clock."""

import statistics
from types import SimpleNamespace

import pytest

from h100bench import lookup, program_spans
from h100bench.readers import idle_percent
from h100bench.trace import DeviceSummary, Kernel, Spans

MS = 1_000_000  # ns
OFFSET = 5_000 * MS  # the synthetic profiler clock: perf_counter ns + OFFSET


def rec(name, start, end, device=None, request=None):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, device_ns=device,
                           request=request)


@pytest.fixture
def program(monkeypatch):
    """A port whose recorder holds ``records``."""
    records = []
    fake = SimpleNamespace(records=lambda: list(records),
                           to_profiler_ns=lambda t: t + OFFSET)
    monkeypatch.setattr(program_spans, "program", lambda: fake)
    return records


def outcome(harness, kernels=(), window=None):
    """harness: (name, start ms, end ms, traced); kernels: (start ms, end ms)
    on the profiler clock."""
    spans = Spans()
    spans.records = [(n, t0 / 1e3, t1 / 1e3, tr) for n, t0, t1, tr in harness]
    device = None
    if window is not None:
        w0, w1 = window
        ks = [Kernel("k", OFFSET + a * MS, (b - a) * MS, None) for a, b in kernels]
        busy = sum(b - a for a, b in kernels)  # the tests' kernels do not overlap
        device = DeviceSummary((w1 - w0) / 1e3, busy / 1e3, ks)
        spans.records.append(("window", w0 / 1e3, w1 / 1e3, True))
    return SimpleNamespace(spans=spans, device=device)


def test_idle_gaps_go_to_the_innermost_program_span(program):
    # window 0-100 ms; kernels leave gaps 10-20, 30-45, 60-70 and 90-100
    out = outcome([("train.step", 0, 100, True)],
                  kernels=[(0, 10), (20, 30), (45, 60), (70, 90)], window=(0, 100))
    program += [
        rec("train.forward", 5 * MS, 40 * MS),
        rec("inner", 12 * MS, 25 * MS),  # nested in train.forward, between two gaps
        rec("train.backward", 40 * MS, 80 * MS),
        rec("pool.queue", 55 * MS, 95 * MS),  # a wait takes no gap
    ]
    # gap 10-20 begins in train.forward (inner opens at 12); 30-45 in train.forward
    # (inner closed at 25); 60-70 in train.backward; 90-100 in no program span
    gaps = program_spans.idle_gaps(out.device.kernels, OFFSET, OFFSET + 100 * MS)
    assert gaps == [(OFFSET + 10 * MS, 10 * MS), (OFFSET + 30 * MS, 15 * MS),
                    (OFFSET + 60 * MS, 10 * MS), (OFFSET + 90 * MS, 10 * MS)]
    assert program_spans.idle_percent_in(out, "train.forward") == pytest.approx(25.0)
    assert program_spans.idle_percent_in(out, "train.backward") == pytest.approx(10.0)
    assert program_spans.idle_percent_in(out, "inner") == pytest.approx(0.0)
    assert program_spans.idle_percent_in(out, "pool.queue") is None
    assert program_spans.idle_percent_in(out, "train.optimizer") is None  # no such span
    # a gap that begins inside the nested span goes to it
    program.append(rec("nested", 29 * MS, 31 * MS))
    assert program_spans.idle_percent_in(out, "nested") == pytest.approx(15.0)
    assert program_spans.idle_percent_in(out, "train.forward") == pytest.approx(10.0)


def test_single_span_idle_adds_up_to_at_most_the_window_idle(program):
    kernels = [(i * 7, i * 7 + 3) for i in range(14)]  # 0-3, 7-10, ... 91-94
    out = outcome([("pool.tick", 0, 100, True)], kernels=kernels, window=(0, 100))
    program += [rec("pool.prefill", 0, 60 * MS), rec("prefill.forward", 1 * MS, 30 * MS),
                rec("prefill.cache", 30 * MS, 58 * MS), rec("pool.insert", 60 * MS, 70 * MS),
                rec("pool.step", 71 * MS, 99 * MS)]
    names = ("prefill.forward", "prefill.cache", "pool.insert", "pool.step", "pool.prefill")
    shares = {n: program_spans.idle_percent_in(out, n) for n in names}
    assert all(v is not None and v >= 0 for v in shares.values())
    assert sum(shares.values()) <= idle_percent(out) + 1e-9
    assert sum(shares.values()) == pytest.approx(idle_percent(out))  # every gap in a span
    assert shares["prefill.forward"] > 0 and shares["pool.insert"] > 0


def test_traced_records_never_enter_the_timing_metrics(program):
    harness = [("train.step", 0, 100, False), ("train.step", 100, 200, False),
               ("train.step", 300, 400, True), ("pool.tick", 500, 600, False),
               ("pool.tick", 700, 800, True)]
    out = outcome(harness)
    program += [
        rec("train.forward", 10 * MS, 40 * MS, device=30 * MS),
        rec("train.forward", 110 * MS, 150 * MS, device=50 * MS),
        rec("train.forward", 310 * MS, 390 * MS, device=900 * MS),  # traced
        rec("train.forward", 250 * MS, 260 * MS, device=700 * MS),  # outside any step
        rec("pool.queue", 450 * MS, 510 * MS, request=1),  # closes inside the untraced tick
        rec("prefill.forward", 510 * MS, 530 * MS, device=4 * MS, request=1),
        rec("prefill.cache", 530 * MS, 540 * MS, device=2 * MS, request=1),
        rec("prefill.forward", 541 * MS, 560 * MS, device=6 * MS, request=2),
        rec("pool.queue", 650 * MS, 710 * MS, request=3),  # traced tick
        rec("prefill.forward", 710 * MS, 790 * MS, device=80 * MS, request=3),
    ]
    assert program_spans.device_ms(out, ("train.forward",), "train.step") == pytest.approx(40.0)
    assert program_spans.host_ms(out, "pool.queue", "pool.tick") == pytest.approx(60.0)
    assert program_spans.device_ms(out, ("prefill.forward", "prefill.cache"),
                                   "pool.tick") == pytest.approx(12.0)
    assert program_spans.device_ms(out, ("train.backward",), "train.step") is None
    # a record without device time (a CPU run) gives no device metric
    program.append(rec("train.forward", 20 * MS, 30 * MS))
    assert program_spans.device_ms(out, ("train.forward",), "train.step") is None


def test_prefill_device_time_is_the_card_busy_inside_a_requests_spans(program):
    # window 0-100 ms; request 3's forward crosses the window's start
    out = outcome([("pool.tick", 0, 100, True)], window=(0, 100), kernels=[
        (0, 3),  # starts in request 3's span: not counted
        (12, 14), (13, 16),  # request 1's forward, overlapping: 4 ms
        (25, 32),  # starts in request 1's cache build, runs past it: 7 ms
        (35, 38),  # in no prefill span
        (41, 43),  # request 2's forward: 2 ms
        (60, 90)])  # a pooled step
    program += [
        rec("prefill.forward", -5 * MS, 5 * MS, request=3),
        rec("prefill.cache", 5 * MS, 8 * MS, request=3),
        rec("pool.prefill", 9 * MS, 31 * MS, request=1),
        rec("prefill.forward", 10 * MS, 20 * MS, request=1),
        rec("prefill.cache", 20 * MS, 30 * MS, request=1),
        rec("pool.insert", 31 * MS, 39 * MS, request=1),
        rec("prefill.forward", 40 * MS, 50 * MS, request=2),
        rec("pool.step", 55 * MS, 95 * MS),
    ]
    assert program_spans.busy_ms_per_request(
        out, ("prefill.forward", "prefill.cache")) == pytest.approx((4 + 7 + 2) / 2)
    assert lookup.metric("pool.prefill_device_ms").read(out) == pytest.approx(6.5)
    # an untraced run has no window and reads nothing
    assert lookup.metric("pool.prefill_device_ms").read(outcome([("pool.tick", 0, 100, False)])) \
        is None


def test_the_metric_files_read_through_the_helper(program):
    out = outcome([("train.step", 0, 100, False)])
    program.append(rec("train.optimizer", 10 * MS, 20 * MS, device=8 * MS))
    assert lookup.metric("train.optimizer_ms").read(out) == pytest.approx(8.0)
    assert lookup.metric("train.forward_ms").read(out) is None
    assert lookup.metric("device_idle.train.forward").read(out) is None  # no traced window


def test_a_port_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "program", lambda: None)
    out = outcome([("train.step", 0, 100, False)], kernels=[(0, 50)], window=(0, 100))
    for name in ("train.forward_ms", "device_idle.train.forward", "pool.queue_wait_ms",
                 "pool.prefill_device_ms", "brain.gmm_ms", "device_idle.serve.insert"):
        assert lookup.metric(name).read(out) is None


@pytest.mark.chip
def test_program_spans_and_profiler_events_share_a_clock(card):
    """A tiny LM's train steps under the profiler on the card: each span's
    ``to_profiler_ns(start)`` against its ``forde.<name>`` range, and
    every kernel against the launch call that queued it; the medians are
    printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from h100bench import run
    from h100bench.drivers.lm_train import lm_config
    from h100bench.tests import tiny

    run.cache_env(lookup.ROOT)
    from forde_tpu_torch.models.decoder_lm import FORDEDecoderLM
    from forde_tpu_torch.obs import spans
    from forde_tpu_torch.train.state import create_train_state
    from forde_tpu_torch.train.step import train_step

    cfg = dict(lookup.config_file(lookup.benchmark(), "forde_lm_ref"), **tiny.LM)
    torch.manual_seed(0)
    model = FORDEDecoderLM(lm_config(cfg), device=card)
    state = create_train_state(lm_config(cfg), None, 1e-3, 0.0, model=model, device=card)
    ids = torch.randint(1, cfg["vocab_size"], (2, 64), device=card)
    state, _ = train_step(state, {"input_ids": ids})  # builds the kernels
    torch.cuda.synchronize(card)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            state, _ = train_step(state, {"input_ids": ids})
        torch.cuda.synchronize(card)
    events = list(prof.profiler.kineto_results.events())
    records = [r for r in spans.records() if r.name.startswith("train.")]
    gaps = []
    for name in ("train.forward", "train.backward", "train.optimizer"):
        starts = sorted(e.start_ns() for e in events if e.name() == spans.PREFIX + name
                        and not str(e.device_type()).endswith("CUDA"))
        mine = sorted(spans.to_profiler_ns(r.start_ns) for r in records if r.name == name)
        assert len(starts) == len(mine) == 20, name
        gaps += [abs(a - b) for a, b in zip(starts, mine)]
    launches = {e.correlation_id(): e.start_ns() for e in events
                if not str(e.device_type()).endswith("CUDA") and e.name().startswith("cu")}
    leads = [e.start_ns() - launches[e.correlation_id()] for e in events
             if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()
             and e.correlation_id() in launches]
    print(f"clock: span start vs its profiler range, median "
          f"{statistics.median(gaps) / 1e3:.2f} us, max {max(gaps) / 1e3:.2f} us over "
          f"{len(gaps)}; kernel start after its launch call: "
          f"min {min(leads) / 1e3:.2f} us, median {statistics.median(leads) / 1e3:.2f} us "
          f"over {len(leads)}")
    assert statistics.median(gaps) <= 50_000
    assert min(leads) >= -50_000  # no kernel starts before the call that queued it
    assert all(r.device_ns is not None and r.device_ns > 0 for r in records)
