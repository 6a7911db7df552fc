"""Readings that the limits of ``correct`` are set from (not part of a
run): for each seed the program's numbers against the reference, the
controls' (the reference with every product in a lower precision, in the
program's place) and each planted fault's.

    python3 -m h100bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--controls tf32|fp8] [--control-seeds 1,2] [--faults half_batch] [--fault-seeds 1]

One JSON line per seed and side, from the ``calibrate`` of the driver
that runs the cell's mix. ``--set key=json`` changes the configuration
(a witness run); ``--sweep 4,8,12`` instead offers a serving mix at each
rate for ``--seconds`` and prints the backlog and the tails (the knee).
"""

from __future__ import annotations

import argparse
import json
import time

from h100bench import lookup
from h100bench.run import cache_env


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--set", action="append", default=[],
                   help="key=json: change the configuration for a witness run")
    p.add_argument("--sweep", default="", help="rates of a serving mix")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cache_env(lookup.ROOT)
    import torch

    from h100bench.common import RunContext

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    bench = lookup.benchmark()
    cell = lookup.workload(bench, args.workload)
    config = lookup.config_file(bench, cell["config"])
    for kv in args.set:
        key, value = kv.split("=", 1)
        config[key] = json.loads(value)
    mix = lookup.traffic(cell["traffic"])
    drv = lookup.driver(mix["driver"])
    device = torch.device(args.device)
    for seed in ints(args.seeds):
        ctx = RunContext(args.workload, config, mix, {}, seed, args.seconds, False, device)
        if args.sweep:
            for line in drv.sweep(ctx, [float(r) for r in args.sweep.split(",")], args.seconds):
                print(json.dumps({"seed": seed, **line}), flush=True)
            continue
        controls = [c for c in args.controls.split(",") if c and seed in ints(args.control_seeds)]
        faults = [f for f in args.faults.split(",") if f and seed in ints(args.fault_seeds)]
        t0 = time.perf_counter()
        for side, numbers in drv.calibrate(ctx, controls, faults):
            print(json.dumps({"seed": seed, "side": side, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}), flush=True)
            t0 = time.perf_counter()


if __name__ == "__main__":
    main()
