"""Trace analysis for ``profile_dir`` captures: where does the round go?
(PyTorch port of ``utils/profiling.py``.)

Every estimator fit can capture a ``torch.profiler`` trace of CPU and CUDA
activity (the ``profile_dir`` param, ``utils/instrumentation.py``), written
as a Chrome trace ``*.pt.trace.json`` (gzipped or not).  This module turns
that capture into the per-op cost table that drives kernel work:

    est = GBMClassifier(num_base_learners=20, profile_dir="/tmp/prof")
    est.fit(X, y)
    python -m spark_ensemble_tpu_torch.utils.profiling /tmp/prof

The summary groups trace slices by name and reports total duration and
call counts, descending.  With ``device_only`` (the default) it keeps the
card's own slices (kernels, memcpys and memsets): the hand-written
kernels appear under their CUDA names (``level_hist``, ``route_packed``,
``leaf_sums``), beside PyTorch's own kernels.  A CPU-only capture has no
device slices; summarize it with ``device_only=False``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Tuple


def find_trace_files(trace_dir: str, latest_only: bool = True) -> List[str]:
    """``*.pt.trace.json`` / ``*.pt.trace.json.gz`` files under a profile
    capture directory.

    Each capture is one file (``trace_<ns>_<pid>.pt.trace.json``), and
    profile_dir is typically a REUSED fixed path — so by default only the
    latest capture is returned; summing across captures would silently
    merge pre- and post-change runs into one misleading table.
    ``latest_only=False`` merges all captures."""
    files = sorted(
        f
        for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
        for f in glob.glob(os.path.join(trace_dir, "**", pattern),
                           recursive=True)
    )
    if not latest_only or not files:
        return files
    # capture file names lead with their nanosecond timestamp
    return [max(files, key=os.path.basename)]


def load_trace_events(path: str) -> List[dict]:
    """Complete ("X"-phase) slice events of one chrome-trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return [
        e
        for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and "dur" in e
    ]


#: trace categories of work the card itself ran
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_events(
    events: List[dict], device_only: bool = True
) -> List[Tuple[str, float, int]]:
    """Aggregate slice durations by event name -> [(name, total_us, count)]
    sorted by total descending.  ``device_only`` keeps the card's slices
    (kernels, memcpys, memsets) and drops host rows (operators, runtime
    calls), which otherwise double-count the device time they launch or
    wait on."""
    totals: Dict[str, List[float]] = {}
    for e in events:
        if device_only and e.get("cat") not in _DEVICE_CATEGORIES:
            continue
        name = e.get("name", "?")
        slot = totals.setdefault(name, [0.0, 0])
        slot[0] += float(e["dur"])
        slot[1] += 1
    return sorted(
        ((n, v[0], int(v[1])) for n, v in totals.items()),
        key=lambda t: -t[1],
    )


def summarize_trace(
    trace_dir: str,
    top: int = 25,
    device_only: bool = True,
    latest_only: bool = True,
) -> Tuple[List[Tuple[str, float, int]], float]:
    """``(top rows, grand_total_us)`` for the (latest) capture — the total
    covers EVERY aggregated op, not just the displayed rows, so percentage
    shares stay honest after truncation."""
    events: List[dict] = []
    for path in find_trace_files(trace_dir, latest_only=latest_only):
        events.extend(load_trace_events(path))
    rows = summarize_events(events, device_only=device_only)
    total = sum(r[1] for r in rows)
    return rows[:top], total


def format_summary(
    rows: List[Tuple[str, float, int]], total_us: Optional[float] = None
) -> str:
    total = total_us if total_us else (sum(r[1] for r in rows) or 1.0)
    lines = [f"{'total_ms':>10}  {'%':>5}  {'count':>6}  op"]
    for name, us, count in rows:
        lines.append(
            f"{us / 1000.0:>10.3f}  {100.0 * us / total:>5.1f}  "
            f"{count:>6d}  {name[:100]}"
        )
    return "\n".join(lines)


def rows_to_records(
    rows: List[Tuple[str, float, int]], total_us: Optional[float] = None
) -> List[dict]:
    """The machine-readable form of the cost table: one record per op with
    ``{"op", "total_us", "count", "share"}`` — the SAME schema
    ``tools/telemetry_report.py`` emits for telemetry phases, so trace
    summaries and telemetry reports diff against each other directly."""
    total = total_us if total_us else (sum(r[1] for r in rows) or 1.0)
    return [
        {"op": name, "total_us": us, "count": count, "share": us / total}
        for name, us, count in rows
    ]


def write_jsonl(records: List[dict], path: str) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument(
        "--all-events",
        action="store_true",
        help="include host rows (operators, runtime calls), not just the "
        "card's kernels, memcpys and memsets",
    )
    ap.add_argument(
        "--merge-captures",
        action="store_true",
        help="sum across ALL captures under the dir (default: latest only)",
    )
    ap.add_argument(
        "--jsonl",
        metavar="PATH",
        help="also write the table as JSONL records "
        '{"op","total_us","count","share"} — the shared machine-readable '
        "format tools/telemetry_report.py reads and emits",
    )
    args = ap.parse_args(argv)
    rows, total = summarize_trace(
        args.trace_dir,
        top=args.top,
        device_only=not args.all_events,
        latest_only=not args.merge_captures,
    )
    if not rows:
        print(f"no trace events found under {args.trace_dir}")
        return 1
    if args.jsonl:
        write_jsonl(rows_to_records(rows, total), args.jsonl)
    print(format_summary(rows, total))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
