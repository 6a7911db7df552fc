"""Host clock around each scheduler tick that admits nothing (one pooled
decode step and the read of its tokens), mean over those ticks."""

LAYER = "serving pool"
SOURCE = "host_clock"
MOVES = "serve_output_tokens_per_s"
UNIT = "ms"


def read(outcome):
    return outcome.facts.get("decode_step_ms")
