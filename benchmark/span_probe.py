"""Profile whole fits of ``higgs.fit``'s estimator, as the benchmark's traced
run does, and print one JSON line a fit: ``summarize``'s readings, the
span table's (``harness/spans.py``), the readings that the span metrics
of PERF.md section 7 would give, and whether the spans were on.

    python benchmark/span_probe.py --seed 2236067977 --order on,off,off,on

``--order`` lists the profiled fits: ``on`` runs the program as it is,
``off`` with its span entry point (``telemetry/trace.py::span``) forced
to the null span, so the two modes' walls give what the spans cost under
a profiler.  A checkout whose program has no span entry point runs every
fit as it is and prints no span readings.  ``--rows``, ``--rounds`` and
``--device cpu`` shrink the fit for a test.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402


def _span_readings(table: dict, rounds: int) -> dict:
    """The five span metrics, from the span table of one fit."""

    def extent_ms(name):
        return table[name]["extent_s"] * 1e3 if name in table else None

    def per_round(name, key, scale=1.0):
        return table[name][key] / rounds * scale if name in table else None

    fixed = None
    if "fit" in table and "fit.rounds" in table:
        fixed = extent_ms("fit") - extent_ms("fit.rounds")
    return {
        "fit.bin_ms": extent_ms("fit.bin"),
        "fit.fixed_ms": fixed,
        "fit.split_device_ms_per_round": per_round("tree.split", "device_s", 1e3),
        "fit.step_device_ms_per_round": per_round("round.step", "device_s", 1e3),
        "fit.step_syncs_per_round": per_round("round.step", "syncs"),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--order", default="on,off,off,on,on,off")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    env.prepare(ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import spec
    from benchmark.harness.data import make_table
    from benchmark.harness.spans import _is_annotation, span_table
    from benchmark.harness.trace import summarize

    cell = spec.load_cell("higgs.fit", ROOT)
    drv = spec.driver_module(cell.driver, ROOT)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    X, y = make_table(cell.config["data"], args.seed, dev, args.rows)
    drv.estimator(cell.config, cell.mix["warm_rounds"]).fit(X, y, device=dev)
    est = drv.estimator(cell.config, args.rounds)
    est.fit(X, y, device=dev)  # one whole fit before the profiled ones
    try:
        from spark_ensemble_tpu_torch.telemetry import trace as trace_mod

        live = trace_mod._profiler_enabled
    except (ImportError, AttributeError):
        trace_mod = live = None

    def sync():
        if cuda:
            torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    lines = []
    try:
        for k, mode in enumerate(args.order.split(",")):
            if trace_mod is not None:
                trace_mod._profiler_enabled = live if mode == "on" else (lambda: False)
            sync()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                model = est.fit(X, y, device=dev)
                sync()
                wall = time.perf_counter() - t0
            events = prof.profiler.kineto_results.events()
            s = summarize(events, wall)
            table = span_table(events)
            R = model.num_members
            device_s = sum(e.duration_ns() for e in events
                           if "CUDA" in str(e.device_type()) and not _is_annotation(e)) * 1e-9
            out = {
                "fit": k, "mode": mode if trace_mod is not None else "as_is",
                "wall_s": wall, "rounds": R, "busy_s": s.busy_s,
                "idle_pct": 100 * (1 - s.busy_s / wall),
                "launches_per_round": s.launches / R, "syncs_per_round": s.syncs / R,
                "device_s": device_s,
                "annotations": sum(1 for e in events if _is_annotation(e)),
                "idle_gaps": s.idle_gaps, "device_ops": s.device_ops[:5],
            }
            if table:
                out["metrics"] = _span_readings(table, R)
                out["below_fit_share"] = (
                    sum(r["device_s"] for n, r in table.items() if n != "fit") / device_s
                    if device_s else None)
                out["per_round"] = {
                    n: {"launches": r["launches"] / R, "syncs": r["syncs"] / R,
                        "device_ms": r["device_s"] / R * 1e3, "count": r["count"]}
                    for n, r in table.items()}
                out["fit_spans_ms"] = {
                    n: {"extent": r["extent_s"] * 1e3, "wall": r["wall_s"] * 1e3}
                    for n, r in table.items() if n.startswith("fit")}
            print(json.dumps(out), flush=True)
            lines.append(out)
    finally:
        if trace_mod is not None:
            trace_mod._profiler_enabled = live
    return lines


if __name__ == "__main__":
    main()
