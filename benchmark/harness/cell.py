"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line's fields."""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Optional

import torch

from benchmark.harness import spec
from benchmark.harness.spec import Cell


def card_peaks(device) -> Optional[dict]:
    if torch.device(device).type != "cuda":
        return None
    table = spec.load_json(spec.BENCH_DIR / "counts" / "peaks.json")["cards"]
    return table.get(torch.cuda.get_device_name(0))


def judge(numbers: dict, limits: dict) -> bool:
    """Every limit has its number, and no number is above its limit (a
    number that is not finite fails)."""
    return set(numbers) >= set(limits) and all(
        math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, rows: Optional[int] = None) -> dict:
    """Run ``cell`` once -> the result's fields (without ``device`` and
    the forbidden-module check, which the caller adds)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    drv = spec.driver_module(cell.driver, cell.root)
    state = drv.setup(cell, seed, dev, rows=rows)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    result = drv.window(cell, state, seconds, trace, seed)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    memory_peak = max(setup_peak, window_peak) if cuda else 0
    layer = drv.layer_context(cell, state, result)
    t_check = time.perf_counter()
    numbers = drv.check(cell, state, result, seed)
    check_s = time.perf_counter() - t_check
    correct = judge(numbers, cell.limits) and result["failed"] == 0
    metrics = {}
    notes = {"window_s": result["elapsed"], "check_s": check_s, **result.get("notes", {})}
    if trace:
        ctx = {"cell": cell, "trace": result["trace"], "peaks": card_peaks(dev),
               "window_peak_bytes": window_peak, **layer}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.root)(ctx)
            if isinstance(value, dict):
                notes[m["name"]] = value.get("note")
                value = value.get("value")
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = {"setup_s": setup_s, **result["metrics"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "memory_peak_bytes": memory_peak}
    if trace and result["trace"] is not None:
        s = result["trace"]
        out["busy_s"], out["window_s"] = s.busy_s, s.window_s
        out["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    out["notes"] = notes
    out["checks"] = {k: {"value": numbers[k], "limit": cell.limits.get(k)} for k in numbers}
    return out


def result_line(fields: dict, device_entry: dict) -> str:
    """The last line of standard output: the contract's keys, then the
    compared numbers with their limits (``checks``), last."""
    dev = dict(device_entry)
    if "busy_s" in fields:
        dev["busy_s"], dev["window_s"] = fields["busy_s"], fields["window_s"]
    line = {"correct": fields["correct"], "attempted": fields["attempted"],
            "failed": fields["failed"], "metrics": fields["metrics"], "device": dev}
    if "breakdown" in fields:
        line["breakdown"] = fields["breakdown"]
    line["checks"] = fields["checks"]
    return json.dumps(line)


def print_notes(fields: dict, power: str) -> None:
    """The card and its power limit, the window's and the check's seconds,
    what the driver notes (a fit cell: each fit's seconds) and what bounds
    each roofline share, on standard error."""
    notes = {"card": power, **{k: v for k, v in fields["notes"].items() if v}}
    print("notes " + json.dumps(notes), file=sys.stderr)


def print_checks(checks: dict) -> None:
    """The compared numbers beside their limits, as the last lines of
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
