"""Host clock around each slow-loop update of the window, between two
synchronisations; the mean over the window's updates."""

from h100bench.readers import mean_span_ms

LAYER = "brain"
SOURCE = "host_clock"
MOVES = "train_step_ms"
UNIT = "ms"


def read(outcome):
    return mean_span_ms(outcome, "brain.update")
