"""What a run records besides its end-to-end metrics: host spans around
the harness's calls into the program, and, in a traced run, the device's
kernels from ``torch.profiler``.

``Spans`` keeps every span in memory as (name, start, end) on the host's
``perf_counter`` clock. While a ``DeviceTrace`` is open each span is also a
``torch.profiler.record_function`` range named ``h100bench.<name>``, so
that a kernel can be attributed to the span whose call launched it.

``DeviceTrace.summary()`` reduces the profiler's events to what the metric
readers take: the kernels (name, start, duration, the harness span that
launched them), the traced window's length, the seconds in which some
operation ran on the device (the union of the kernel, copy and set
intervals inside the window), and the breakdown of the result line: the
ten device operations that took most time, and the idle seconds summed by
the harness span the host was in when each idle gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

PREFIX = "h100bench."
WINDOW = "window"
NAME_CHARS = 160  # a device operation's name in the breakdown, cut to this


class Spans:
    """Host spans of one run."""

    def __init__(self) -> None:
        # (name, start, end, traced): traced spans ran under the profiler
        self.records: List[Tuple[str, float, float, bool]] = []
        self.annotate = False  # set while a DeviceTrace is open

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        rf = None
        traced = self.annotate
        if traced:
            from torch.profiler import record_function

            rf = record_function(PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter(), traced))
            if rf is not None:
                rf.__exit__(None, None, None)

    def durations(self, name: str) -> List[float]:
        """Seconds of every closed span called ``name`` that ran without
        the profiler, in order (the profiler slows the host)."""
        return [t1 - t0 for n, t0, t1, traced in self.records if n == name and not traced]


def base_name(name: str) -> str:
    """A kernel's own name in the profiler's demangled signature:
    ``void (anonymous namespace)::mha_bwd_dq_tc_kernel<64>(...)`` ->
    ``mha_bwd_dq_tc_kernel``."""
    bare = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", bare, maxsplit=1)[0].rsplit("::", 1)[-1]


@dataclass
class Kernel:
    name: str
    start_ns: int
    dur_ns: int
    span: Optional[str]  # the innermost harness span open at its launch


@dataclass
class DeviceSummary:
    window_s: float
    busy_s: float
    kernels: List[Kernel] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, prefixes: Tuple[str, ...], span: Optional[str] = None) -> float:
        """Device seconds of the kernels whose own name starts with one of
        ``prefixes`` (launched inside ``span`` if given)."""
        return sum(k.dur_ns for k in self.kernels if base_name(k.name).startswith(prefixes)
                   and (span is None or k.span == span)) / 1e9


class DeviceTrace:
    """A ``torch.profiler`` window over the run's device work. ``start``
    opens it and the window span, ``stop`` synchronises, closes both and
    keeps the events; the caller stops it at a step boundary."""

    def __init__(self, spans: Spans, device) -> None:
        self.spans, self.device = spans, device
        self.prof = None
        self._window = None
        self.events = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.spans.annotate = True
        self._window = self.spans.span(WINDOW)
        self._window.__enter__()

    @property
    def open(self) -> bool:
        return self.prof is not None and self.events is None

    def stop(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self.spans.annotate = False
        self.prof.stop()
        self.events = list(self.prof.profiler.kineto_results.events())
        self.prof = None

    def summary(self) -> Optional[DeviceSummary]:
        if self.events is None:
            return None
        return summarize(self.events)


def summarize(events) -> Optional[DeviceSummary]:
    """Reduce kineto events to a ``DeviceSummary`` (None without the
    window annotation). On the device: kernels, copies and sets (a user
    annotation is mirrored there too, and is left out); on the host: the
    harness's annotations, and the runtime's launch calls, whose
    correlation id a kernel carries (a graph's kernels carry the graph
    launch's)."""
    annotations = []  # (start, end, name) of the harness spans
    launches: Dict[int, int] = {}  # correlation id -> host start of the launch call
    device = []
    for e in events:
        name = e.name()
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if not on_device and name.startswith(PREFIX):
                annotations.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                    name[len(PREFIX):]))
        elif on_device:
            device.append(e)
        elif name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    window = [a for a in annotations if a[2] == WINDOW]
    if not window:
        return None
    w0, w1 = window[0][0], window[0][1]
    inner = sorted(a for a in annotations if a[2] != WINDOW)
    starts = [a[0] for a in inner]

    def span_at(t: int) -> Optional[str]:
        # the innermost (latest-starting) span that contains t
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            s0, s1, n = inner[i]
            if s0 <= t <= s1:
                return n
            i -= 1
        return None

    kernels, intervals = [], []
    for e in device:
        t0, dur = e.start_ns(), e.duration_ns()
        t1 = t0 + dur
        if t1 <= w0 or t0 >= w1:
            continue
        launch = launches.get(e.correlation_id(), t0)
        kernels.append(Kernel(e.name(), t0, dur, span_at(launch)))
        intervals.append((max(t0, w0), min(t1, w1)))
    intervals.sort()
    busy, gaps, cur0, cur1 = 0, [], None, None
    last_end = w0
    for a, b in intervals:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if a > last_end:
                gaps.append((a - last_end, last_end))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
        last_end = max(last_end, b)
    if cur1 is not None:
        busy += cur1 - cur0
    if w1 > last_end:
        gaps.append((w1 - last_end, last_end))
    by_name: Dict[str, float] = defaultdict(float)
    for k in kernels:
        by_name[k.name[:NAME_CHARS]] += k.dur_ns / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle_by_span: Dict[str, float] = defaultdict(float)
    for g, t in gaps:
        idle_by_span[span_at(t) or "outside_spans"] += g / 1e9
    idle_gaps = sorted(idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return DeviceSummary((w1 - w0) / 1e9, busy / 1e9, kernels, device_ops, idle_gaps)
