"""What the per-layer metrics of the port's own spans share.

The port records its spans and counters in ``forde_tpu_torch.obs.spans``
(one process-wide ring, read after the run). A checkout whose port has no
such module has no records, and every reader here returns None.

* Timing: only the records that closed inside the harness's untraced
  spans (``train.step``, ``brain.update``, ``pool.tick``: ``Spans``
  records with ``traced`` false) count; the profiler slows the host, and
  the set-up's steps and warm-up requests lie outside those spans.
* Busy: in the traced window, the kernels, copies and sets that started
  while the host was inside one request's spans, each taken whole (the
  union of their intervals), summed per request. A pool's admission
  follows a host read (the last step's tokens, or the last admission's
  first token), so what starts inside its spans was launched there.
* Idle: the traced window's idle gaps, rebuilt from the device summary's
  kernels as ``trace.summarize`` takes them (the union of kernel, copy and
  set intervals inside the window), each put down to the innermost program
  span open on the host when the gap began, on the profiler's clock
  (``spans.to_profiler_ns``). A wait (``pool.queue``) is not host work and
  takes no gap.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from h100bench.trace import WINDOW

WAITS = ("pool.queue",)


def program():
    """The port's span recorder module, or None where the port has none."""
    try:
        from forde_tpu_torch.obs import spans
    except ImportError:
        return None
    return spans


def _harness(outcome, name: str, traced: bool) -> List[Tuple[int, int]]:
    """(start, end) in ns on ``perf_counter`` of the harness spans called
    ``name``, traced or not, in order."""
    return sorted((round(t0 * 1e9), round(t1 * 1e9))
                  for n, t0, t1, tr in outcome.spans.records if n == name and tr == traced)


def _closed_inside(records, names: Sequence[str], within: List[Tuple[int, int]]):
    """(index of the ``within`` span, record) for each record named in
    ``names`` that closed inside one of the (sorted) ``within`` spans."""
    starts = [s for s, _ in within]
    for r in records:
        if r.name in names:
            i = bisect.bisect_right(starts, r.end_ns) - 1
            if i >= 0 and r.end_ns <= within[i][1]:
                yield i, r


def _records():
    spans = program()
    return spans.records() if spans is not None else []


def device_ms(outcome, names: Sequence[str], within: str) -> Optional[float]:
    """Device time (each span's pair of CUDA events) of the records named
    in ``names`` that closed inside the untraced harness spans ``within``,
    summed per harness span, mean over those spans, in ms."""
    sums: Dict[int, int] = defaultdict(int)
    for i, r in _closed_inside(_records(), names, _harness(outcome, within, False)):
        if r.device_ns is None:
            return None
        sums[i] += r.device_ns
    if not sums:
        return None
    return sum(sums.values()) / len(sums) / 1e6


def host_ms(outcome, name: str, within: str) -> Optional[float]:
    """Mean host duration of the records called ``name`` that closed
    inside the untraced harness spans ``within``, in ms."""
    took = [r.end_ns - r.start_ns
            for _, r in _closed_inside(_records(), (name,), _harness(outcome, within, False))]
    return sum(took) / len(took) / 1e6 if took else None


def busy_ms_per_request(outcome, names: Sequence[str]) -> Optional[float]:
    """Device time of each request's program spans named in ``names`` in
    the traced window: the union of the kernels, copies and sets (each
    whole) that started while the host was inside one of them, mean over
    the requests whose spans all lie in the window, in ms; None where the
    window holds none."""
    spans, dev = program(), outcome.device
    if spans is None or dev is None:
        return None
    window = _harness(outcome, WINDOW, True)
    if not window:
        return None
    w0, w1 = (spans.to_profiler_ns(t) for t in window[0])
    by_request: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    cut = set()  # requests with a span across the window's edge
    for r in spans.records():
        if r.name not in names or r.request is None:
            continue
        a, b = spans.to_profiler_ns(r.start_ns), spans.to_profiler_ns(r.end_ns)
        if b < w0 or a > w1:
            continue
        if a < w0 or b > w1:
            cut.add(r.request)
        by_request[r.request].append((a, b))
    inside = sorted((a, b, q) for q, ivs in by_request.items() if q not in cut for a, b in ivs)
    if not inside:
        return None
    starts = [a for a, _, _ in inside]
    ran: Dict[int, List[Tuple[int, int]]] = {q: [] for _, _, q in inside}
    for k in dev.kernels:
        i = bisect.bisect_right(starts, k.start_ns) - 1
        if i >= 0 and k.start_ns <= inside[i][1]:
            ran[inside[i][2]].append((k.start_ns, k.start_ns + k.dur_ns))
    return sum(_union_ns(ivs) for ivs in ran.values()) / len(ran) / 1e6


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(kernels: Iterable, w0: int, w1: int) -> List[Tuple[int, int]]:
    """(start, length) in ns of the stretches of [w0, w1] in which no
    kernel, copy or set ran (``trace.summarize``'s union)."""
    intervals = sorted((max(k.start_ns, w0), min(k.start_ns + k.dur_ns, w1)) for k in kernels
                       if k.start_ns + k.dur_ns > w0 and k.start_ns < w1)
    gaps, last_end = [], w0
    for a, b in intervals:
        if a > last_end:
            gaps.append((last_end, a - last_end))
        last_end = max(last_end, b)
    if w1 > last_end:
        gaps.append((last_end, w1 - last_end))
    return gaps


def innermost(gaps: List[Tuple[int, int]], spans: List[Tuple[int, int, str]]) -> Dict[str, int]:
    """Idle ns summed by the innermost of ``spans`` ((start, end, name) on
    one clock) open at each gap's start; a gap in no span counts nowhere.
    One sweep: spans enter in order of start (the longer first where two
    start together), and the latest-entered span still open is the
    innermost (the host's spans nest)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    idle: Dict[str, int] = defaultdict(int)
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for t, g in sorted(gaps):
        while j < len(spans) and spans[j][0] <= t:
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            idle[stack[-1][2]] += g
    return idle


def idle_percent_in(outcome, name: str) -> Optional[float]:
    """Share of the traced window in which the card was idle while the
    host was inside the program span ``name`` (innermost); None where the
    window holds no such span or ran nothing on the card."""
    spans, dev = program(), outcome.device
    if spans is None or dev is None or dev.window_s <= 0 or dev.busy_s <= 0:
        return None
    window = _harness(outcome, WINDOW, True)
    if not window:
        return None
    w0, w1 = (spans.to_profiler_ns(t) for t in window[0])
    hosted = [(spans.to_profiler_ns(r.start_ns), spans.to_profiler_ns(r.end_ns), r.name)
              for r in spans.records() if r.name not in WAITS]
    hosted = [s for s in hosted if s[1] >= w0 and s[0] <= w1]
    if not any(n == name for _, _, n in hosted):
        return None
    idle = innermost(idle_gaps(dev.kernels, w0, w1), hosted)
    return 100.0 * idle.get(name, 0) / 1e9 / dev.window_s
