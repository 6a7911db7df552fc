"""Metrics logging and throughput metering (port of
forde_tpu/obs/metrics.py, without JAX and without TensorBoard): scalars
as JSON lines in ``<log_dir>/metrics.jsonl``, and items per second."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

# The decoder LM's metric keys under the reference's TensorBoard tags.
REFERENCE_TAGS = {
    "loss/total": "Loss/total",
    "loss/lm": "Loss/lm",
    "loss/aux": "Loss/aux",
    "training/grad_norm": "Training/grad_norm",
}


class MetricsWriter:
    """Appends {"tag", "value", "step"} lines to ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")

    def scalars(self, metrics: Dict[str, float], step: int) -> None:
        for tag, value in metrics.items():
            self.scalar(tag, float(value), step)

    def close(self) -> None:
        self._jsonl.close()


class ThroughputMeter:
    """Pairs (or tokens) per second on the one device the port runs on,
    over the steps counted since the last ``reset``, on the host clock."""

    def __init__(self, items_per_step: int):
        self.items_per_step = items_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self) -> None:
        self._steps += 1

    @property
    def items_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        if dt == 0 or self._steps == 0:
            return 0.0
        return self._steps * self.items_per_step / dt
