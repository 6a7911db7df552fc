"""Host time of the program's ``pool.queue`` spans, from a request's
``submit`` to the tick that gives it a slot, mean over the requests
admitted inside the window's untraced ``pool.tick`` spans."""

from h100bench.program_spans import host_ms

LAYER = "serving pool"
SOURCE = "program_span"
MOVES = "serve_output_tokens_per_s"
UNIT = "ms"


def read(outcome):
    return host_ms(outcome, "pool.queue", "pool.tick")
