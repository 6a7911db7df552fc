"""Find a cell's parts by name: nothing in the harness lists them.

* the cell, its configuration entry and its end-to-end and per-layer
  metrics: ``BENCHMARK.json`` at the root of the checkout;
* the configuration's sizes: the file its entry names;
* the traffic mix: ``traffic/<traffic>.json``, whose ``driver`` key names
  ``drivers/<driver>.py``;
* a per-layer metric: ``metrics/<metric>.py`` (names hold dots, so the
  file is loaded by its path);
* the limits of the comparison that decides ``correct``:
  ``limits/<workload>.json``.

A later cell, mix or metric is a new file and a new entry; no file here
changes. ``base`` is the harness's folder (a test points it at a copy).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config_entry(bench: dict, name: str) -> dict:
    return _named(bench["configs"], name, "config")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    return read_json(root / config_entry(bench, name)["file"])


def traffic(name: str, base: Path = BASE) -> dict:
    return read_json(base / "traffic" / f"{name}.json")


def limits(workload_name: str, base: Path = BASE) -> dict:
    return read_json(base / "limits" / f"{workload_name}.json")


def _applies(metric: dict, workload_name: str) -> bool:
    return "workloads" not in metric or workload_name in metric["workloads"]


def end_to_end(bench: dict, workload_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, workload_name)]


def per_layer(bench: dict, workload_name: str) -> List[dict]:
    return [m for m in bench["per_layer"] if _applies(m, workload_name)]


def driver(name: str, base: Path = BASE) -> ModuleType:
    return _load(base / "drivers" / f"{name}.py", f"h100bench.drivers.{name}")


def metric(name: str, base: Path = BASE) -> ModuleType:
    return _load(base / "metrics" / f"{name}.py",
                 "h100bench.metrics." + name.replace(".", "__"))


def _load(path: Path, module_name: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

