"""Share of the program's dense-dispatch MoE calls that ran over the routed
rows only: its counters ``moe.routed`` and ``moe.dense``, counted over the
whole process (set-up, window and traced window), routed over both, in %.
None on a port without the counters, or where no MoE layer ran."""

from h100bench.program_spans import program

LAYER = "train step"
SOURCE = "program_span"
MOVES = "train_step_ms"
UNIT = "%"


def routed_share(spans):
    """100 x routed / (routed + dense) from the recorder's counters."""
    if spans is None:
        return None
    counters, _ = spans.snapshot()
    routed, dense = counters.get("moe.routed", 0), counters.get("moe.dense", 0)
    if routed + dense == 0:
        return None
    return 100.0 * routed / (routed + dense)


def read(outcome):
    return routed_share(program())
