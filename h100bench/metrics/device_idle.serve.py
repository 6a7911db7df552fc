"""Share of the traced window (the first ``trace_seconds`` of the
serving window) in which no kernel, copy or set ran on the card."""

from h100bench.readers import idle_percent

LAYER = "device"
SOURCE = "device_trace"
MOVES = "serve_output_tokens_per_s"
UNIT = "%"


def read(outcome):
    return idle_percent(outcome)
