"""A run with its timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program at a tiny size on the
CPU, with the cell's committed limits. (One chip: no exchange between
chips to leave out.) A sound run at the same size, in fp32, is correct."""

import pytest

from h100bench import run
from h100bench.tests import tiny

LM = ("forde_lm_ref.train_8x2k", tiny.LM, tiny.TRAIN)
SERVE = ("forde_lm_ref.serve_saturated", tiny.LM, tiny.SERVE)
CLIP = ("clip_vit_b16.train_sensed_256", tiny.CLIP, tiny.CLIP_TRAIN)
CASES = [
    (*LM, "unchanged"),  # the step returns its state
    (*LM, "half_batch"),  # the mean over half the rows
    (*LM, "slow_loop_unchanged"),  # the slow loop leaves the routers as they were
    (*CLIP, "unchanged"),
    (*CLIP, "half_batch"),
    (*CLIP, "slow_loop_unchanged"),  # ... the neuron types
    (*SERVE, "token_altered"),  # a token changed where the step returns it
    (*SERVE, "unchanged"),  # the pool's step repeats itself
]


def _run(workload, config, mix, faults, **extra):
    result, _ = run.run_cell(workload, 2 ** 31 + 4321, 2.0, False, device="cpu",
                             overrides=dict(config, **extra), traffic_overrides=mix,
                             faults=faults)
    return result


@pytest.mark.parametrize("workload,config,mix", [LM, SERVE, CLIP])
def test_sound_run_is_correct(workload, config, mix):
    assert _run(workload, config, mix, (), dtype="float32")["correct"]


@pytest.mark.parametrize("workload,config,mix,fault", CASES)
def test_fault_is_not_correct(workload, config, mix, fault):
    result = _run(workload, config, mix, (fault,))
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
