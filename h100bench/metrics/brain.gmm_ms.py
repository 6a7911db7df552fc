"""Device time of the program's ``brain.gmm`` spans (the slow loop's GMM
fits and the relabelling of their clusters, one a group of layers of one
width): their CUDA events summed over each untraced ``brain.update`` of
the window, mean over the updates."""

from h100bench.program_spans import device_ms

LAYER = "brain"
SOURCE = "program_span"
MOVES = "train_step_ms"
UNIT = "ms"


def read(outcome):
    return device_ms(outcome, ("brain.gmm",), "brain.update")
