"""One run of one cell:

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``) runs from the start of this process to the first
timed step: imports, the CUDA context, the kernels from the checkout's
build cache, the weights from the seed and the warm-up of the cell's
shapes. The driver then measures for ``--seconds`` and checks what the
timed path produced against the plain reference. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from the same run's spans and a ``torch.profiler``
window.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, every compared number beside its
limit (also the last lines of standard error). No result is printed, and
the exit code is not 0, when the cell's cards are not there (3), when
JAX or the JAX package was loaded (4), or when a file the cell needs is
missing.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Iterable, Optional, Tuple  # noqa: E402

from h100bench import lookup  # noqa: E402

# Top-level module names that no run may load (compared whole: the port's
# name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "forde_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache in fixed directories of the checkout,
    and no library loading JAX on its own."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names: Iterable[str]) -> list:
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             root: Path = lookup.ROOT, base: Path = lookup.BASE,
             overrides: Optional[dict] = None, traffic_overrides: Optional[dict] = None,
             faults: Iterable[str] = (),
             started: float = PROCESS_START) -> Tuple[dict, list]:
    """Run one cell; returns (result line, earlier stderr lines). The
    check for the cards is the caller's (``main``); a test passes
    ``device="cpu"`` and shrinks the configuration and the mix with
    ``overrides`` and ``traffic_overrides``."""
    import torch

    from h100bench.common import RunContext, card

    bench = lookup.benchmark(root)
    cell = lookup.workload(bench, workload)
    config = dict(lookup.config_file(bench, cell["config"], root), **(overrides or {}))
    mix = dict(lookup.traffic(cell["traffic"], base), **(traffic_overrides or {}))
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    ctx = RunContext(workload, config, mix, lookup.limits(workload, base), seed, seconds,
                     trace, device, faults=set(faults))
    outcome = lookup.driver(mix["driver"], base).run(ctx, started)

    wanted = lookup.per_layer(bench, workload) if trace else lookup.end_to_end(bench, workload)
    metrics = {}
    for m in wanted:
        # a per-layer reader that finds nothing to read returns None
        value = (lookup.metric(m["name"], base).read(outcome) if trace
                 else outcome.metrics.get(m["name"]))
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": bool(outcome.checks) and all(c.ok for c in outcome.checks),
              "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": dev}
    if trace and outcome.device is not None:
        dev["busy_s"] = outcome.device.busy_s
        dev["window_s"] = outcome.device.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in outcome.device.device_ops],
                               "idle_gaps": [list(x) for x in outcome.device.idle_gaps]}
    # a number that never came (no request finished) reads as the largest float
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else sys.float_info.max,
                                 "limit": c.limit} for c in outcome.checks}
    log = [f"card: {card(device)}", *ctx.log]
    log += [f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}"
            for c in outcome.checks]
    return result, log


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(lookup.ROOT)
    import torch

    chips = int(lookup.workload(lookup.benchmark(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    result, log = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules(sys.modules)
    if found:
        print(f"h100bench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for line in log:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
