"""``fit_mfu``: the traced fit's least time at the card's published peaks
(the larger of all its bytes over the memory rate and all its operations
over the float32 rate; ``benchmark/counts/work.py``) over the fit's wall
time, in percent."""

from benchmark.counts.work import least_seconds
from benchmark.harness.layers import traced_fit_work


def read(ctx):
    work, peaks, s = traced_fit_work(ctx), ctx.get("peaks"), ctx.get("trace")
    if work is None or peaks is None or s.window_s <= 0:
        return None
    total = (sum(w[0] for w in work.values()), sum(w[1] for w in work.values()))
    least, by = least_seconds(total, peaks)
    return {"value": 100.0 * least / s.window_s, "note": f"bound by {by}"}
