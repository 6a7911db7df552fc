"""The control comes out not correct: the reference in the next precision
below the configuration's (float32 with TF32 off: TF32 products; bf16:
fp8 products) put in the program's place, on the card at the full widths
with fewer rows and requests, against the cells' committed limits; the
program itself stays within them. Runs on the H100
(``pytest h100bench/tests -m chip``)."""


import pytest

from h100bench import lookup
from h100bench.common import RunContext
from h100bench.reference.lowp import CONTROL


def _ctx(workload, device, seed, **mix):
    bench = lookup.benchmark()
    cell = lookup.workload(bench, workload)
    return RunContext(workload, lookup.config_file(bench, cell["config"]),
                      dict(lookup.traffic(cell["traffic"]), **mix), lookup.limits(workload),
                      seed, 0.0, False, device)


def _fails(numbers, limits):
    return [k for k, v in numbers.items() if k in limits and not v <= limits[k]]


@pytest.mark.chip
@pytest.mark.parametrize("workload,mix", [
    ("forde_lm_ref.train_8x2k", dict(batch=2)),
    ("clip_vit_b16.train_sensed_256", dict(batch=64)),
    ("forde_lm_ref.serve_saturated", dict(calibrate_seconds=4.0, check_tokens=300)),
])
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_control_fails_and_program_holds(card, workload, mix, seed):
    ctx = _ctx(workload, card, seed, **mix)
    drv = lookup.driver(ctx.traffic["driver"])
    control = CONTROL[ctx.config["dtype"]]
    sides = dict(drv.calibrate(ctx, [control], []))
    assert not _fails(sides["program"], ctx.limits)
    assert _fails(sides[f"control_{control}"], ctx.limits)
