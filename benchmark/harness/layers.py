"""Arithmetic the per-layer readers share: a fit's work from its shape,
roofline shares, idle shares."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.counts.work import fit_work, least_seconds


def traced_fit_work(ctx) -> Optional[dict]:
    """``{part: (bytes, ops)}`` of the traced fit, or None without one."""
    s = ctx.get("trace")
    if s is None or not s.rounds or "shape" not in ctx:
        return None
    return fit_work(rounds=s.rounds, **ctx["shape"])


def kernel_roofline(ctx, part: str, names: Sequence[str]):
    """``part``'s least time over the device time of the kernels whose
    names hold one of ``names``, in percent; None where nothing ran."""
    work, peaks, s = traced_fit_work(ctx), ctx.get("peaks"), ctx.get("trace")
    if work is None or peaks is None:
        return None
    t = s.kernel_seconds(names)
    if t <= 0:
        return None
    least, by = least_seconds(work[part], peaks)
    return {"value": 100.0 * least / t, "note": f"bound by {by}"}


def idle_pct(ctx):
    s = ctx.get("trace")
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
