"""Share of the traced window in which no kernel, copy or set ran on the card
while the host was inside the program's ``train.backward`` span (the
gradients (``autograd.grad``) and their reduction over ranks) and no span
nested in it: each idle gap goes to the innermost program span open when it
began."""

from h100bench.program_spans import idle_percent_in

LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_step_ms"
UNIT = "%"


def read(outcome):
    return idle_percent_in(outcome, "train.backward")
