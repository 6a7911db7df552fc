"""The hand-written kernels' least time (bytes over the memory's bandwidth
or operations over their route's peak, whichever is larger, per kernel
call, from the layers' shapes and masks: attention, and the dual
encoder's moment sums) over their device time in the traced steps."""

from h100bench.readers import roofline_percent

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_step_ms"
UNIT = "%"


def read(outcome):
    return roofline_percent(outcome, "kernel_least_s_per_step", "traced_steps")
