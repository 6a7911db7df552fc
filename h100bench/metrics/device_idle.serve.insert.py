"""Share of the traced serving window in which no kernel, copy or set ran on
the card while the host was inside the program's ``pool.insert`` span (the
cache row and sampling settings copied into the slot, the first token's host
read) and no span nested in it."""

from h100bench.program_spans import idle_percent_in

LAYER = "device"
SOURCE = "device_trace"
MOVES = "serve_output_tokens_per_s"
UNIT = "%"


def read(outcome):
    return idle_percent_in(outcome, "pool.insert")
