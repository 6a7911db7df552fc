"""Share of the traced serving window in which no kernel, copy or set ran on
the card while the host was inside the program's ``prefill.cache`` span (the
NSA cache built from the forward: ring, pools, scores, ``topk_replay``, the
top-k gathers) and no span nested in it."""

from h100bench.program_spans import idle_percent_in

LAYER = "device"
SOURCE = "device_trace"
MOVES = "serve_output_tokens_per_s"
UNIT = "%"


def read(outcome):
    return idle_percent_in(outcome, "prefill.cache")
