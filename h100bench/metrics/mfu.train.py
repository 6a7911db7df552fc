"""Model operations of the window's training steps over the window and
the card's peak rate in the configuration's dtype (``counts/``: routed
experts only, admitted keys only, no recomputation)."""

LAYER = "train step"
SOURCE = "host_clock"
MOVES = "train_step_ms"
UNIT = "%"


def read(outcome):
    f = outcome.facts
    if not f.get("flops_per_step") or not f.get("window_s"):
        return None
    return 100.0 * f["steps"] * f["flops_per_step"] / f["window_s"] / f["peak_ops_per_s"]
