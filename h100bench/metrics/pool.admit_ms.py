"""Host clock from the pool taking requests off its queue to their first
tokens on the host (one-row NSA prefills, the cache rows copied in), over
the requests admitted: the mean admission."""

LAYER = "serving pool"
SOURCE = "host_clock"
MOVES = "serve_output_tokens_per_s"
UNIT = "ms"


def read(outcome):
    return outcome.facts.get("admit_ms")
