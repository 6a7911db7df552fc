"""The pooled decode steps' small-KV kernels (the compressed and top-k
branches of every layer; the window branch of a decode step is not a
hand-written kernel): their least time over their device time, for the
kernels launched inside the harness's ``pool.step`` spans."""

from h100bench.readers import roofline_percent

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "serve_output_tokens_per_s"
UNIT = "%"


def read(outcome):
    return roofline_percent(outcome, "decode_least_s_per_step", "traced_steps",
                            prefixes=("small_kv_",), span="pool.step")
