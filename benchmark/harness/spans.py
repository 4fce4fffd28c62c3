"""The program's spans in a profiler window, each charged with the device
work it issued.

The port names the layers of a fit with profiler scopes
(``spark_ensemble_tpu_torch/telemetry/trace.py``: ``fit``, ``fit.bin``,
``fit.round``, ``round.step``, ``tree.level``, ``tree.split``, ...; the
catalogue is in ``docs/tracing.md``).  They are operator-level events of
the profiler's host timeline, beside the aten operators and on the same
clock, so ``summarize`` in ``trace.py`` names an idle gap inside one by
it and counts nothing else of them.  :func:`span_table` reads them from
the same kineto events and charges each kernel, launch call and wait to
the innermost span around the call that issued it: a kernel finds its
launch by correlation id, and a runtime call its thread through the
operator it links to (the profiler numbers the threads of operators and
of runtime calls apart).
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict

from benchmark.harness.trace import LAUNCH_CALLS, SYNC_CALLS

#: the names the program's spans start with
SPAN_PREFIXES = ("fit", "round.", "tree.")


def _call(e, method: str, default=0):
    """``e.<method>()``, or ``default`` where the event lacks it."""
    fn = getattr(e, method, None)
    return default if fn is None else fn()


def _is_annotation(e) -> bool:
    """A user annotation's device-side copy: the extent of the kernels of a
    ``record_function`` range, not device work of its own."""
    return bool(_call(e, "is_user_annotation", False)) or (
        "user_annotation" in str(_call(e, "activity_type", "")))


class _SpanIndex:
    """The innermost span at each instant of each thread: spans on one
    thread nest, so a sweep over their starts and ends cuts the timeline
    into pieces with one innermost span each."""

    def __init__(self, spans):
        self.parent = [-1] * len(spans)
        self._cuts: Dict[int, tuple] = {}
        by_tid: Dict[int, list] = {}
        for i, (s, e, _, tid) in enumerate(spans):
            by_tid.setdefault(tid, []).append((s, -e, i))
        for tid, items in by_tid.items():
            times, owners, stack = [], [], []

            def close_until(t):
                while stack and spans[stack[-1]][1] <= t:
                    times.append(spans[stack.pop()][1])
                    owners.append(stack[-1] if stack else -1)

            for s, _, i in sorted(items):
                close_until(s)
                self.parent[i] = stack[-1] if stack else -1
                stack.append(i)
                times.append(s)
                owners.append(i)
            close_until(float("inf"))
            self._cuts[tid] = (times, owners)

    def owner(self, tid: int, t: int) -> int:
        """The innermost span of thread ``tid`` open at ``t``, or -1."""
        cuts = self._cuts.get(tid)
        if cuts is None:
            return -1
        k = bisect_right(cuts[0], t) - 1
        return cuts[1][k] if k >= 0 else -1


def span_table(events) -> Dict[str, dict]:
    """Per span name: ``count``; ``wall_s``, its host durations summed;
    ``extent_s``, each instance's host start to the later of its host end
    and the end of the last device event issued inside it (its inner
    spans' included), summed; ``device_s``, ``launches`` and ``syncs``, the
    device events, launch calls and waits whose innermost span it is.
    ``{}`` where the window holds no span."""
    spans, ops, calls, device = [], {}, [], []
    for e in events:
        name = e.name()
        if "CUDA" in str(e.device_type()):
            if not _is_annotation(e):
                s = e.start_ns()
                device.append((s + e.duration_ns(), e.duration_ns(),
                               _call(e, "correlation_id"), _call(e, "linked_correlation_id")))
            continue
        s = e.start_ns()
        if name.startswith(("cuda", "cu")):
            kind = "launches" if name in LAUNCH_CALLS else "syncs" if name in SYNC_CALLS else None
            calls.append((kind, s, _call(e, "correlation_id"), _call(e, "linked_correlation_id")))
            continue
        tid = _call(e, "start_thread_id")
        ops[_call(e, "correlation_id")] = (tid, s)
        if name.startswith(SPAN_PREFIXES):
            spans.append((s, s + e.duration_ns(), name, tid))
    if not spans:
        return {}
    ops.pop(0, None)  # id 0 is no id: events that carry none link to nothing
    index = _SpanIndex(spans)
    table = {name: {"count": 0, "wall_s": 0.0, "extent_s": 0.0, "device_s": 0.0,
                    "launches": 0, "syncs": 0} for _, _, name, _ in spans}
    issued = {}
    for kind, start, corr, linked in calls:
        op = ops.get(linked)
        owner = -1 if op is None else index.owner(op[0], start)
        if corr:
            issued[corr] = owner
        if kind is not None and owner >= 0:
            table[spans[owner][2]][kind] += 1
    last_end = [e for _, e, _, _ in spans]
    for end, dur, corr, linked in device:
        owner = issued.get(corr, -1) if corr else -1
        if owner < 0 and linked in ops:
            owner = index.owner(*ops[linked])
        if owner < 0:
            continue
        table[spans[owner][2]]["device_s"] += dur * 1e-9
        while owner >= 0:
            last_end[owner] = max(last_end[owner], end)
            owner = index.parent[owner]
    for i, (s, e, name, _) in enumerate(spans):
        row = table[name]
        row["count"] += 1
        row["wall_s"] += (e - s) * 1e-9
        row["extent_s"] += (last_end[i] - s) * 1e-9
    return table
