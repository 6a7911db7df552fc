"""What the per-layer metric files share: each file of ``metrics/`` names
its layer, source and the end-to-end metric it moves, and reads its number
with one of these. A reader that finds nothing to read returns None, and
the metric is left out of the run's line; a share of a peak or a roofline
is never 0 by default."""

from __future__ import annotations

from typing import Optional, Tuple

# the program's hand-written CUDA kernels (forde_tpu_torch/csrc), by name
HAND_KERNELS = ("flash_", "mha_bwd_", "skv_", "small_kv_", "moment_", "topk_replay")


def idle_percent(outcome) -> Optional[float]:
    """Share of the traced window in which no operation ran on the card."""
    dev = outcome.device
    if dev is None or dev.window_s <= 0 or dev.busy_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)


def roofline_percent(outcome, least_fact: str, units_fact: str,
                     prefixes: Tuple[str, ...] = HAND_KERNELS,
                     span: Optional[str] = None) -> Optional[float]:
    """Sum of the kernels' least times (``least_fact`` per unit of work
    times ``units_fact`` units in the traced window) over their device
    time in that window (launched inside ``span`` if given)."""
    dev, facts = outcome.device, outcome.facts
    if dev is None or least_fact not in facts or not facts.get(units_fact):
        return None
    seconds = dev.kernel_seconds(prefixes, span)
    if seconds <= 0:
        return None
    return 100.0 * facts[least_fact] * facts[units_fact] / seconds


def mean_span_ms(outcome, name: str) -> Optional[float]:
    durations = outcome.spans.durations(name)
    if not durations:
        return None
    return 1e3 * sum(durations) / len(durations)
