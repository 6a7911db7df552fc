"""Model operations of the tokens the pooled decode steps produced (each
at its own position, active rows only) over the host time of those steps
(``pool.step`` spans, each ending in the read of its tokens) and the
card's peak rate."""

LAYER = "serving pool"
SOURCE = "host_clock"
MOVES = "serve_output_tokens_per_s"
UNIT = "%"


def read(outcome):
    f = outcome.facts
    if not f.get("decode_flops") or not f.get("decode_step_s"):
        return None
    return 100.0 * f["decode_flops"] / f["decode_step_s"] / f["peak_ops_per_s"]
