"""Pod-scope trace stitching: N per-rank JSONL streams -> one timeline
(PyTorch port of ``telemetry/podview.py``; the same functions, output and
rules).

Every process of a mesh fit writes its own telemetry stream with its own
wall clock, its own pid-local span ids and its own per-fit trace ids.
This module merges those streams into a single pod-level trace that
``tools/trace_viewer.py`` renders with one ``host{i}`` track group per
rank and the preemption -> rewind flow arrows crossing ranks:

- **Fit alignment**: the k-th *distributed* fit on every rank (the fits
  that emit ``dist_config``) is the same pod-wide fit (ranks run the
  elastic attempt sequence in lockstep), so the k-th group's spans are
  rewritten onto one ``pod.{k}`` trace under one synthesized
  ``pod_fit_{k}`` root.  Manifest digests are cross-checked when both
  streams recorded them (a mismatch is reported, not fatal).
- **Clock offsets**: ranks' wall clocks may disagree.  Offsets are
  estimated at the fit's sync barriers (the manifest-agreement gather and
  each level or leaf pass's last reduce), where every rank unblocks at
  nearly the same true instant: the per-rank offset is the median over
  matched barriers of ``t_rank - t_reference``.  Ranks that share one
  host clock (the port's gloo ranks on one machine) estimate offsets near
  zero.
- **Id hygiene**: span and parent ids are prefixed ``h{i}.``, threads are
  rewritten into ``host{i}`` track groups, and flow ids are left as they
  are: ``parallel/elastic.py`` derives a preemption's flow id from
  ``crc32(victim, site)`` on every rank, which is what lets the viewer
  draw the arrow from the victim's stream into a survivor's rewind.

The per-rank dist spans (``dist_level_<l>``, ``dist_leaf``) carry measured
``steps_s``/``fetch_s`` walls, which :func:`skew_report` folds into
straggler attribution: per-round max/median ratios, the per-round
offender and the persistent offender across rounds.

Pure stdlib, no package imports: in the port ``dist_config``'s
``process`` is the rank.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "load_stream",
    "expand_inputs",
    "host_index",
    "estimate_offsets",
    "stitch",
    "stitch_files",
    "skew_report",
    "render_skew",
]

#: span names that end at a cross-host sync barrier (the blocking
#: replicated-reduce fetch in DistributedSweep.sweep_forest)
DIST_SPAN_PREFIX = "dist_level_"
DIST_LEAF_SPAN = "dist_leaf"


def _is_dist_span(ev: Dict[str, Any]) -> bool:
    if ev.get("event") != "span":
        return False
    name = ev.get("name", "")
    return name.startswith(DIST_SPAN_PREFIX) or name == DIST_LEAF_SPAN


def load_stream(path: str) -> List[Dict[str, Any]]:
    """One telemetry JSONL stream, lenient about a half-written tail
    line (the stream is append-only; a killed host stops mid-line)."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def expand_inputs(paths: Sequence[str]) -> List[str]:
    """Resolve a mix of files and directories into a deterministic list
    of JSONL streams: directories are walked recursively (sorted), only
    ``*.jsonl`` files are taken, and duplicates are dropped preserving
    first-seen order — the shape the streaming CI job uploads
    (``**/telemetry_p*.jsonl`` under one artifact root)."""
    out: List[str] = []
    seen = set()

    def add(p: str) -> None:
        rp = os.path.abspath(p)
        if rp not in seen:
            seen.add(rp)
            out.append(p)

    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs.sort()
                for name in sorted(files):
                    if name.endswith(".jsonl"):
                        add(os.path.join(root, name))
        else:
            add(p)
    return out


def host_index(events: List[Dict[str, Any]], default: int) -> int:
    """The host (process) index a stream was written by: the
    ``dist_config`` row records the rank; streams without one
    (single-process fits) fall back to their input position."""
    for ev in events:
        if ev.get("event") == "dist_config" and "process" in ev:
            return int(ev["process"])
    return default


def _dist_fit_order(events: List[Dict[str, Any]]) -> List[str]:
    """fit_ids of this stream's distributed fits, in first-``dist_config``
    order — position k is pod-wide fit group k."""
    order: List[str] = []
    seen = set()
    for ev in events:
        if ev.get("event") == "dist_config":
            fid = ev.get("fit_id", "?")
            if fid not in seen:
                seen.add(fid)
                order.append(fid)
    return order


def _barrier_points(
    events: List[Dict[str, Any]], fit_id: str
) -> Dict[Tuple, float]:
    """Wall-clock times at which this host crossed each sync barrier of
    one fit, keyed so the same barrier matches across hosts: the i-th
    manifest agreement, and the i-th occurrence of each dist sweep span
    (barrier = the moment its blocking reduce fetch returned —
    ``ts + steps_s + fetch_s`` when the span carries the measured
    split, else the span end)."""
    pts: Dict[Tuple, float] = {}
    agree_i = 0
    name_counts: Dict[str, int] = {}
    for ev in events:
        if ev.get("fit_id") != fit_id:
            continue
        if ev.get("event") == "dist_manifest_agreed":
            pts[("agree", agree_i)] = float(ev.get("ts", 0.0))
            agree_i += 1
        elif _is_dist_span(ev):
            name = ev.get("name", "")
            k = name_counts.get(name, 0)
            name_counts[name] = k + 1
            ts = float(ev.get("ts", 0.0))
            if "steps_s" in ev and "fetch_s" in ev:
                barrier = ts + float(ev["steps_s"]) + float(ev["fetch_s"])
            else:
                barrier = ts + float(ev.get("dur_s", 0.0))
            pts[("span", name, k)] = barrier
    return pts


def estimate_offsets(
    streams: Sequence[List[Dict[str, Any]]],
) -> List[float]:
    """Per-stream clock offsets relative to stream 0, estimated at the
    matched sync barriers of each pod-wide fit group.  The median over
    matched barriers rejects the occasional late unblock (a host that
    also ran the finish program before its next barrier); a stream
    sharing no barriers with the reference keeps offset 0.0."""
    if not streams:
        return []
    per_stream: List[Dict[Tuple, float]] = []
    for events in streams:
        pts: Dict[Tuple, float] = {}
        for g, fid in enumerate(_dist_fit_order(events)):
            for key, ts in _barrier_points(events, fid).items():
                pts[(g,) + key] = ts
        per_stream.append(pts)
    ref = per_stream[0]
    offsets = [0.0]
    for pts in per_stream[1:]:
        deltas = [pts[k] - ref[k] for k in pts.keys() & ref.keys()]
        offsets.append(statistics.median(deltas) if deltas else 0.0)
    return offsets


def stitch(
    streams: Sequence[List[Dict[str, Any]]],
    offsets: Optional[Sequence[float]] = None,
    hosts: Optional[Sequence[int]] = None,
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Merge per-host streams into one pod-level event list (sorted by
    aligned ``ts``) plus a stitch-info summary.  See the module
    docstring for the rewrite rules."""
    if hosts is None:
        hosts = [host_index(ev, i) for i, ev in enumerate(streams)]
    if offsets is None:
        offsets = estimate_offsets(streams)
    group_maps = [
        {fid: g for g, fid in enumerate(_dist_fit_order(ev))}
        for ev in streams
    ]
    digests: Dict[int, Dict[int, str]] = {}
    merged: List[Dict[str, Any]] = []
    bounds: Dict[int, List[float]] = {}
    for events, h, off, gmap in zip(streams, hosts, offsets, group_maps):
        for ev in events:
            row = dict(ev)
            if "ts" in row:
                row["ts"] = float(row["ts"]) - off
            row["host"] = h
            g = gmap.get(row.get("fit_id", ""))
            if row.get("event") == "dist_manifest_agreed" and g is not None:
                digests.setdefault(g, {})[h] = row.get("digest", "")
            if row.get("event") == "span":
                if row.get("span_id"):
                    row["span_id"] = f"h{h}.{row['span_id']}"
                if row.get("parent_id"):
                    row["parent_id"] = f"h{h}.{row['parent_id']}"
                th = row.get("thread")
                if not th or th == "main":
                    row["thread"] = f"host{h}"
                elif th == f"host{h}" or th.startswith(f"host{h}/"):
                    pass
                else:
                    row["thread"] = f"host{h}/{th}"
                if g is not None:
                    row["trace_id"] = f"pod.{g}"
                    if not row.get("parent_id"):
                        row["parent_id"] = f"pod.{g}.root"
                    ts = float(row.get("ts", 0.0))
                    b = bounds.setdefault(g, [ts, ts])
                    b[0] = min(b[0], ts)
                    b[1] = max(b[1], ts + float(row.get("dur_s", 0.0)))
            merged.append(row)
    for g, (lo, hi) in sorted(bounds.items()):
        merged.append({
            "event": "span",
            "name": f"pod_fit_{g}",
            "trace_id": f"pod.{g}",
            "span_id": f"pod.{g}.root",
            "parent_id": "",
            "ts": lo,
            "dur_s": max(hi - lo, 0.0),
            "pid": 0,
            "thread": "pod",
            "fit_id": f"pod:{g}",
            "hosts": list(hosts),
        })
    merged.sort(key=lambda e: float(e.get("ts", 0.0)))
    mismatches = [
        {"group": g, "digests": dict(per)}
        for g, per in sorted(digests.items())
        if len(set(per.values())) > 1
    ]
    info = {
        "streams": len(streams),
        "hosts": list(hosts),
        "offsets": [float(o) for o in offsets],
        "groups": len(bounds),
        "digest_mismatches": mismatches,
    }
    return merged, info


def stitch_files(
    paths: Sequence[str],
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """:func:`stitch` over :func:`expand_inputs`-resolved paths; the
    info dict gains the resolved ``inputs`` list."""
    resolved = expand_inputs(paths)
    streams = [load_stream(p) for p in resolved]
    merged, info = stitch(streams)
    info["inputs"] = resolved
    return merged, info


# ---------------------------------------------------------------------------
# straggler & skew detection
# ---------------------------------------------------------------------------


def _median(values: List[float]) -> float:
    return statistics.median(values) if values else 0.0


def skew_report(
    streams: Sequence[List[Dict[str, Any]]],
    hosts: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Fold per-host sweep/reduce/shard-wait walls into straggler
    attribution.  Per round (the ``round`` attr on dist sweep spans):
    the max/median ratio across hosts and the offending host (ties
    break to the smallest index, so attribution is deterministic).
    ``pod_skew_ratio`` is the same ratio over whole-fit per-host sweep
    walls — 1.0 for a single host, the sentinel's healthy floor.
    ``host_stalled`` chaos events are tallied separately by victim so
    an injected stall is attributable even when only one process emits
    (single-process simulated pods)."""
    if hosts is None:
        hosts = [host_index(ev, i) for i, ev in enumerate(streams)]
    per_host: Dict[int, Dict[str, float]] = {}
    rounds: Dict[int, Dict[int, float]] = {}
    stalls: Dict[int, Dict[str, float]] = {}
    for events, h in zip(streams, hosts):
        agg = per_host.setdefault(h, {
            "steps_s": 0.0, "fetch_s": 0.0, "sweep_s": 0.0,
            "reduce_s": 0.0, "shard_wait_s": 0.0,
        })
        for ev in events:
            if _is_dist_span(ev):
                steps = float(ev.get("steps_s", ev.get("dur_s", 0.0)))
                agg["steps_s"] += steps
                agg["fetch_s"] += float(ev.get("fetch_s", 0.0))
                rnd = int(ev.get("round", -1))
                rounds.setdefault(rnd, {})
                rounds[rnd][h] = rounds[rnd].get(h, 0.0) + steps
            elif ev.get("event") == "dist_sweep":
                agg["sweep_s"] += float(ev.get("sweep_us", 0.0)) / 1e6
                agg["reduce_s"] += float(ev.get("reduce_us", 0.0)) / 1e6
            elif ev.get("event") == "shard_wait_us":
                agg["shard_wait_s"] += float(ev.get("wait_us", 0.0)) / 1e6
            elif ev.get("event") == "host_stalled":
                victim = int(ev.get("victim", h))
                slot = stalls.setdefault(
                    victim, {"count": 0, "seconds": 0.0}
                )
                slot["count"] += 1
                slot["seconds"] += float(ev.get("seconds", 0.0))
    round_rows: List[Dict[str, Any]] = []
    offender_counts: Dict[int, int] = {}
    for rnd in sorted(rounds):
        values = rounds[rnd]
        med = _median(list(values.values()))
        top = max(values.items(), key=lambda kv: (kv[1], -kv[0]))
        ratio = (top[1] / med) if med > 0 else 1.0
        round_rows.append({
            "round": rnd,
            "ratio": ratio,
            "offender": top[0],
            "values": {str(h): v for h, v in sorted(values.items())},
        })
        # balanced rounds (ratio ~1) carry no attribution signal — a
        # tie-broken "offender" there would dilute a real straggler's
        # persistence count
        if ratio > 1.1:
            offender_counts[top[0]] = offender_counts.get(top[0], 0) + 1
    # hosts with no distributed activity at all (a stream of single-host
    # fits) carry no skew signal — drop them so the report only renders
    # when there is a pod to report on
    per_host = {
        h: agg for h, agg in per_host.items()
        if any(v > 0 for v in agg.values())
        or any(h in vals for vals in rounds.values())
    }
    totals = {h: agg["steps_s"] for h, agg in per_host.items()}
    pod_ratio = 1.0
    if len(totals) > 1:
        med = _median(list(totals.values()))
        pod_ratio = (max(totals.values()) / med) if med > 0 else 1.0
    persistent = None
    if offender_counts:
        persistent = max(
            offender_counts.items(), key=lambda kv: (kv[1], -kv[0])
        )[0]
    return {
        "hosts": sorted(per_host),
        "per_host": {str(h): agg for h, agg in sorted(per_host.items())},
        "rounds": round_rows,
        "pod_skew_ratio": float(pod_ratio),
        "persistent_offender": persistent,
        "stalls": {str(v): s for v, s in sorted(stalls.items())},
    }


def render_skew(report: Dict[str, Any]) -> str:
    """The skew report as the text block ``tools/telemetry_report.py``
    appends after the per-fit sections."""
    lines = ["== pod skew =="]
    ratio = report.get("pod_skew_ratio", 1.0)
    head = f"pod_skew_ratio: {ratio:.2f}"
    persistent = report.get("persistent_offender")
    if persistent is not None:
        head += f"  persistent offender: host {persistent}"
    lines.append(head)
    for h in report.get("hosts", []):
        agg = report["per_host"][str(h)]
        lines.append(
            f"host {h}: sweep {agg['steps_s'] * 1e3:.1f}ms  "
            f"fetch {agg['fetch_s'] * 1e3:.1f}ms  "
            f"reduce {agg['reduce_s'] * 1e3:.1f}ms  "
            f"shard_wait {agg['shard_wait_s'] * 1e3:.1f}ms"
        )
    for row in report.get("rounds", []):
        vals = "  ".join(
            f"h{h}={v * 1e3:.1f}ms" for h, v in row["values"].items()
        )
        lines.append(
            f"round {row['round']}: ratio {row['ratio']:.2f}  "
            f"offender host {row['offender']}  ({vals})"
        )
    for victim, s in report.get("stalls", {}).items():
        lines.append(
            f"stalls: host {victim} x{int(s['count'])} "
            f"({s['seconds']:.2f}s injected)"
        )
    return "\n".join(lines)
