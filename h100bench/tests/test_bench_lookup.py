"""Cells, mixes and metrics are found by name: a later one is a new file
and a new entry, and no file changes."""

import json
import shutil

from h100bench import lookup, run
from h100bench.tests import tiny


def test_every_entry_resolves():
    bench = lookup.benchmark()
    for cell in bench["workloads"]:
        mix = lookup.traffic(cell["traffic"])
        assert lookup.driver(mix["driver"]).run
        assert lookup.limits(cell["name"])
        assert lookup.config_file(bench, cell["config"])
    for m in bench["per_layer"]:
        module = lookup.metric(m["name"])
        assert (module.LAYER, module.SOURCE, module.MOVES, module.UNIT) == (
            m["layer"], m["source"], m["moves"], m["unit"])


def test_a_new_mix_and_metric_are_found_in_a_copy(tmp_path):
    base = tmp_path / "h100bench"
    shutil.copytree(lookup.BASE, base, ignore=shutil.ignore_patterns("__pycache__"))
    root = tmp_path
    shutil.copy(lookup.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "traffic" / "train_tiny.json").write_text(json.dumps(
        dict(lookup.traffic("train_8x2k"), **tiny.TRAIN, driver="lm_train")))
    (base / "limits" / "forde_lm_ref.train_tiny.json").write_text(
        (base / "limits" / "forde_lm_ref.train_8x2k.json").read_text())
    (base / "metrics" / "steps.window.py").write_text(
        'LAYER = "train step"\nSOURCE = "host_clock"\nMOVES = "train_step_ms"\nUNIT = "1"\n'
        "def read(outcome):\n    return outcome.facts['steps']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "forde_lm_ref.train_tiny", "config": "forde_lm_ref",
                               "traffic": "train_tiny", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "steps.window", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_step_ms", "workloads": ["forde_lm_ref.train_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "h100bench" / "configs").mkdir(exist_ok=True)
    result, _ = run.run_cell("forde_lm_ref.train_tiny", 5, 0.5, True, device="cpu", root=root,
                             base=base, overrides=tiny.LM)
    assert result["metrics"]["steps.window"]["value"] >= 1
    assert all(p.read_bytes() == data for p, data in before.items())
