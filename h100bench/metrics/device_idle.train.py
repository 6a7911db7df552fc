"""Share of the traced window in which no kernel, copy or set ran on the
card (one minus the union of their intervals over the window)."""

from h100bench.readers import idle_percent

LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_step_ms"
UNIT = "%"


def read(outcome):
    return idle_percent(outcome)
