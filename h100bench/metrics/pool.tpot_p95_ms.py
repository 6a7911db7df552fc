"""95th percentile over every request of the window of (last token -
first token) / (tokens - 1): the pooled steps' pace as a request sees
it, prefills that stall the pool included."""

LAYER = "serving pool"
SOURCE = "host_clock"
MOVES = "serve_output_tokens_per_s"
UNIT = "ms"


def read(outcome):
    return outcome.metrics.get("serve_tpot_p95_ms")
