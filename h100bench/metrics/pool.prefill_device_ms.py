"""Device time of one admission's prefill, from the traced window: the
kernels, copies and sets that started while the host was inside the
program's ``prefill.forward`` (the one-row forward) or ``prefill.cache``
(the NSA cache built from it) spans of one request, the union of their
intervals, mean over the requests admitted in the window. The card's idle
time inside the spans does not count."""

from h100bench.program_spans import busy_ms_per_request

LAYER = "serving pool"
SOURCE = "device_trace"
MOVES = "serve_output_tokens_per_s"
UNIT = "ms"


def read(outcome):
    return busy_ms_per_request(outcome, ("prefill.forward", "prefill.cache"))
