"""The reference's benchmark drivers, on the port (ports of
``benchmarks/decoder.py``, ``serving_bench.py``, ``quant_decode.py`` and
``decode_scaling.py``; ``forde_tpu_torch.bench`` ports ``bench.py``).

Each driver runs the reference's configurations and timed work: the same
configuration fields and defaults, the same seeded inputs (numpy draws in
the reference's order), the same warm-up, timed loop and arithmetic of its
rates. Run one as a module, on the card unless ``--device cpu`` is given
(``bench`` takes ``device`` as a keyword of ``main``):

    python3 -m forde_tpu_torch.bench
    python3 -m forde_tpu_torch.benchmarks.decoder
    python3 -m forde_tpu_torch.benchmarks.serving_bench --bf16 ...
    python3 -m forde_tpu_torch.benchmarks.quant_decode
    python3 -m forde_tpu_torch.benchmarks.decode_scaling

Each keeps the reference's printed lines and ends in one JSON line in
``bench.py``'s shape (``result_line``), whose ``extra`` also holds the
card (``nvidia-smi``'s name and power limit), the peak device memory and
the kernel launches of the timed sections. A timed section ends in
``sync``, where the reference forces a host transfer.

This module holds what the five share.
"""

from __future__ import annotations

import gc
import json
import subprocess
from typing import Optional

import torch


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device) -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` since the last ``reset_peak``,
    in GiB; None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def release(device: torch.device) -> None:
    """Free what the last run left behind (its graphs' pools included)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def card(device: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def result_line(metric: str, value, unit: str, extra: dict, device: torch.device) -> str:
    """The driver's last line: ``{"metric", "value", "unit", "vs_baseline",
    "extra"}``. ``vs_baseline`` is null: the reference's baselines are TPU
    targets, not the card's. ``extra`` gains the card and the device."""
    return json.dumps({
        "metric": metric, "value": value, "unit": unit, "vs_baseline": None,
        "extra": {**extra, "card": card(device), "device": device.type},
    })
