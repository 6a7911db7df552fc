"""``moe.routed_share`` of a serving cell: the share of the program's
dense-dispatch MoE calls (prefills, the pooled decode's capture, the warm-up
requests) that ran over the routed rows only, over the whole process, in %.
None on a port without the counters."""

from h100bench import lookup
from h100bench.program_spans import program

LAYER = "serving pool"
SOURCE = "program_span"
MOVES = "serve_output_tokens_per_s"
UNIT = "%"


def read(outcome):
    return lookup.metric("moe.routed_share").routed_share(program())
