"""95th percentile over every request of the window of its first token's
time minus its scheduled arrival, queueing included. Above the pool's
knee the queue grows through the run, so this tail swings with the
smallest change: a per-layer reading of the pool's admission, not a
bound."""

LAYER = "serving pool"
SOURCE = "host_clock"
MOVES = "serve_output_tokens_per_s"
UNIT = "s"


def read(outcome):
    return outcome.metrics.get("serve_ttft_p95_s")
