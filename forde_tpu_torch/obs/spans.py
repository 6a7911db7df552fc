"""Spans and counters inside the port, where the work happens.

A span is one named interval of host work::

    from forde_tpu_torch.obs import spans

    with spans.span("train.forward", device=ids.device):
        ...
    spans.count("pool.steps")

Each closed span leaves a ``Record``: its name, start and end in
``time.perf_counter_ns()`` (the clock a harness times its own calls with),
the id of the span open around it (``parent``) and a request id (given, or
the parent's), so that every span of one served request shares it. Records
go into a ring of the last ``RING`` spans; per-name aggregates (count,
total and longest nanoseconds) and the counters are updated on every span
and never dropped.

Device time. A span given a CUDA ``device`` also records a pair of
``torch.cuda.Event(enable_timing=True)`` on that device's current stream
at its start and end. The events are taken from a free list and go back to
it once read; nothing waits for them on the way. ``Record.device_ns`` is
the time between the two on the device's clock, the device's idle time
inside the span included, and is filled when the records are read
(``records()``, which waits for events still pending). While the stream
is capturing a CUDA graph, and for a CPU device, the span records no
events and its ``device_ns`` stays None.

Cost. Recording is always on: two clock reads, one append and the
aggregate's update under a lock; a device-timed span adds two event
records. While a ``torch.profiler`` is open, each span is also a
profiler range named ``forde.<name>`` (``torch._C._profiler.
_RecordFunctionFast``: ``record_function``'s range without its operator
call, whose entry took ~110 µs on an H100 machine's host against ~17),
so that a profiler's trace shows the program's spans beside its kernels;
with no profiler open, no range is opened.

Clocks. A kineto event's ``start_ns()`` reads Unix-epoch nanoseconds
(``time.time_ns()``'s clock); ``to_profiler_ns`` places a
``perf_counter_ns`` reading on it, so that a record can be laid over a
device trace's timeline.

Counters live in ``counters``, a ``collections.Counter`` updated under a
lock, as ``kernels.launches`` is.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

RING = 65_536
PREFIX = "forde."


@dataclass
class Record:
    """One closed span. ``device_ns`` is None until read, and stays None
    for a span that recorded no events."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: Optional[int]
    device_ns: Optional[int] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None


class _Span:
    """The context manager ``Recorder.span`` returns."""

    __slots__ = ("rec", "name", "device", "request", "id", "parent", "start", "events",
                 "stream", "rf")

    def __init__(self, rec: "Recorder", name: str, device, request: Optional[int]):
        self.rec, self.name, self.device, self.request = rec, name, device, request

    def __enter__(self) -> "_Span":
        rec = self.rec
        stack = rec._stack()
        self.parent, inherited = stack[-1] if stack else (None, None)
        if self.request is None:
            self.request = inherited
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            # the profiler's range takes its time stamp at the end of its
            # entry: the span's start is read right after it
            rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
            rf.__enter__()
            self.rf = rf
        try:
            self.start = time.perf_counter_ns()
            self.events = None
            dev = self.device
            if dev is not None and torch.device(dev).type == "cuda" \
                    and not torch.cuda.is_current_stream_capturing():
                self.stream = torch.cuda.current_stream(dev)
                events = rec._take_pair()
                events[0].record(self.stream)
                self.events = events
        except BaseException:
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            raise
        # on the stack only once entered: a span that failed to open
        # leaves no parent behind
        self.id = next(rec._ids)
        stack.append((self.id, self.request))
        return self

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            self.events[1].record(self.stream)
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec._stack().pop()
        rec._close(Record(self.id, self.name, self.start, end, self.parent, self.request,
                          events=self.events))


class Recorder:
    """Spans, their aggregates and counters (one process-wide instance
    below; a test may build its own)."""

    def __init__(self, capacity: int = RING):
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.counters: collections.Counter = collections.Counter()
        self._aggregates: Dict[str, List[int]] = {}  # name -> [count, total ns, max ns]
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._free: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._pending: collections.deque = collections.deque()  # records whose events are unread

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, device=None, request: Optional[int] = None) -> _Span:
        """A span around the ``with`` block; ``device``: time it on that
        CUDA device's current stream too."""
        return _Span(self, name, device, request)

    def interval(self, name: str, start_ns: int, end_ns: int,
                 request: Optional[int] = None) -> None:
        """Record a span whose start was read earlier (a wait in a queue),
        under the span open now."""
        stack = self._stack()
        parent = stack[-1][0] if stack else None
        self._close(Record(next(self._ids), name, start_ns, end_ns, parent, request))

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def _close(self, record: Record) -> None:
        took = record.end_ns - record.start_ns
        with self._lock:
            agg = self._aggregates.get(record.name)
            if agg is None:
                self._aggregates[record.name] = [1, took, took]
            else:
                agg[0] += 1
                agg[1] += took
                agg[2] = max(agg[2], took)
            if record.events is not None:
                self._pending.append(record)
        self.ring.append(record)

    def _take_pair(self) -> Tuple[torch.cuda.Event, torch.cuda.Event]:
        """A pair of timing events: a free one, else one freed by reading
        the oldest records whose events have completed (a query, no wait),
        else a new one."""
        with self._lock:
            if not self._free:
                while self._pending and self._pending[0].events[1].query():
                    self._resolve(self._pending.popleft())
            if self._free:
                return self._free.pop()
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def _resolve(self, record: Record) -> None:
        start, end = record.events
        record.device_ns = int(start.elapsed_time(end) * 1e6)
        record.events = None
        self._free.append((start, end))

    def records(self) -> List[Record]:
        """The ring's records, oldest first, each with its device time
        (waits for the events of spans still running on the device)."""
        with self._lock:
            while self._pending:
                record = self._pending.popleft()
                record.events[1].synchronize()
                self._resolve(record)
            return list(self.ring)

    def snapshot(self) -> Tuple[Dict[str, int], Dict[str, Tuple[int, int, int]]]:
        """The counters, and {name: (count, total ns, longest ns)} of every
        span closed since the last reset (the host clock's), read at once."""
        with self._lock:
            return dict(self.counters), {n: tuple(a) for n, a in self._aggregates.items()}

    def reset(self) -> None:
        """Forget every record, aggregate and counter."""
        self.records()
        with self._lock:
            self.ring.clear()
            self.counters.clear()
            self._aggregates.clear()


def _profiler_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few bracketed reads."""
    best = None
    for _ in range(9):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


RECORDER = Recorder()
_OFFSET_NS = _profiler_offset_ns()

span = RECORDER.span
interval = RECORDER.interval
count = RECORDER.count
counters = RECORDER.counters
records = RECORDER.records
snapshot = RECORDER.snapshot
reset = RECORDER.reset


def to_profiler_ns(perf_ns: int) -> int:
    """A ``perf_counter_ns`` reading on the profiler's event clock."""
    return perf_ns + _OFFSET_NS
