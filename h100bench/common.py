"""What a driver takes and gives back, and the small helpers they share."""

from __future__ import annotations

import math
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import torch

from h100bench.trace import DeviceSummary, Spans


@dataclass
class RunContext:
    """One run of one cell. ``config`` is the configuration file, with
    ``overrides`` applied (tests shrink it); ``traffic`` the mix's data
    file; ``limits`` the comparison's limits. ``faults`` (tests only) names
    faults that the driver plants under the timed path."""

    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    spans: Spans = field(default_factory=Spans)
    faults: Set[str] = field(default_factory=set)
    log: List[str] = field(default_factory=list)

    def say(self, line: str) -> None:
        """An earlier line of the run's standard error (peak GiB, the
        card, launches, the generator's lateness)."""
        self.log.append(line)


@dataclass
class Check:
    """One number compared with the reference, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver measured. ``metrics``: the end-to-end values by name;
    ``facts``: what the per-layer readers read besides spans and the
    device summary (operations and least times per unit of work, counts
    of the window)."""

    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    spans: Spans
    facts: Dict[str, float] = field(default_factory=dict)
    device: Optional[DeviceSummary] = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def card(device: torch.device) -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def tail(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile by nearest rank over every value (a tail of all
    requests: nothing left out)."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)) - 1, 0)]


def release(device: torch.device) -> None:
    """Free what the program held, so that the reference runs in the room
    it leaves."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
