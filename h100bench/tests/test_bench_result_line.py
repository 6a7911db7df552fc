"""A run's last line: its keys, the cell's metrics with their units, and
every compared number beside its limit under the last key."""

import json

from h100bench import lookup, run
from h100bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(workload, traffic_tiny, trace):
    return run.run_cell(workload, 2 ** 31 + 77, 1.0, trace, device="cpu", overrides=tiny.LM,
                        traffic_overrides=traffic_tiny)


def test_training_line():
    result, log = _run("forde_lm_ref.train_8x2k", tiny.TRAIN, False)
    assert list(result) == KEYS
    bench = lookup.benchmark()
    names = {m["name"]: m["unit"] for m in lookup.end_to_end(bench, "forde_lm_ref.train_8x2k")}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == names
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["checks"] and all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert log[-len(result["checks"]):] == [
        line for line in log if line.startswith("check ")]
    json.loads(json.dumps(result))


def test_serving_line_reports_its_own_metrics():
    result, _ = _run("forde_lm_ref.serve_saturated", tiny.SERVE, False)
    assert set(result["metrics"]) == {"serve_output_tokens_per_s", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_traced_line_carries_per_layer_metrics_only():
    result, _ = _run("forde_lm_ref.train_8x2k", tiny.TRAIN, True)
    layer = {m["name"] for m in lookup.per_layer(lookup.benchmark(), "forde_lm_ref.train_8x2k")}
    assert set(result["metrics"]) <= layer
    assert "mfu.train" in result["metrics"]
    assert "train_step_ms" not in result["metrics"]
    assert list(result)[-1] == "checks"
