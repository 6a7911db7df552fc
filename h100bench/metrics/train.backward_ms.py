"""Device time of the program's ``train.backward`` span (the gradients
(``autograd.grad``) and their reduction over ranks): the CUDA events it
records on the step's stream, summed over each untraced ``train.step`` of
the window (a step of accumulated microbatches has several), mean over the
steps. The device's idle time inside the span counts."""

from h100bench.program_spans import device_ms

LAYER = "train step"
SOURCE = "program_span"
MOVES = "train_step_ms"
UNIT = "ms"


def read(outcome):
    return device_ms(outcome, ("train.backward",), "train.step")
