#!/usr/bin/env python3
"""Device time of each level of the level histogram in a fit cell's fits
(``--workload``, default ``higgs.fit``), one checkout against another, on
one CUDA card.

    python3 tools/level_hist_times.py --seed 2236067977 PARENT_DIR CHANGE_DIR
    python3 tools/level_hist_times.py --workload epsilon.fit --seed 5 .

Each positional argument is the root of a checkout (a directory holding
``spark_ensemble_tpu_torch/`` and ``benchmark/``).  For each, in the order
given, a fresh Python process puts that checkout first on ``sys.path``,
makes the cell's table on the card from the seed (``benchmark/harness/
data.py``), warms up with the cell's warm fit and one whole fit, then
profiles ``--fits`` whole fits with ``torch.profiler``.  The kernels whose
name holds ``level_hist`` are taken in the order they started: a depth-8
tree launches one histogram a level, levels 0-7 in turn, so histogram ``i``
is level ``i % 8``; where a level walks row lists, the lists' kernels
(``level_hist_count``, ``level_hist_rows``) run just before its histogram
and count to its level, their own share under ``lists_ms``.  A fit whose
trace lost a histogram (the count is not 8 a round) is left out and
counted.

It prints one JSON line per checkout: per level the median, min and max
device milliseconds over the traced trees and that level's plan
(``level_plan``: grid, CTAs a cluster, clusters a tile and whether it
walks row lists, where the checkout's plan has them), the levels' sum of
medians, the fits' walls, and the launches that split a tile over
clusters (``LEVEL_SPLITS``) and that walked row lists (``LEVEL_COMPACT``),
where the checkout counts them; then the card's name and power limit.  Two
checkouts compare fairly only within one run, on one card.
"""

import argparse
import subprocess
import sys

ONE = r'''
import json, statistics, sys, time
from pathlib import Path

root, seed, fits = Path(sys.argv[1]).resolve(), int(sys.argv[2]), int(sys.argv[3])
workload = sys.argv[4]
sys.path.insert(0, str(root))
from benchmark.harness import env

env.prepare(root)
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import spec
from benchmark.harness.data import make_table
from spark_ensemble_tpu_torch.ops import hist_kernels as hk

cell = spec.load_cell(workload, root)
drv = spec.driver_module(cell.driver, root)
dev = torch.device("cuda")
data, tree = cell.config["data"], cell.config["base_learner"]
depth, B = tree["max_depth"], tree["max_bins"]
X, y = make_table(data, seed, dev)
drv.estimator(cell.config, cell.mix["warm_rounds"]).fit(X, y, device=dev)
est = drv.estimator(cell.config)
est.fit(X, y, device=dev)
torch.cuda.synchronize()
hk.reset_launch_counts()
per_level = [[] for _ in range(depth)]
lists_level = [[] for _ in range(depth)]
walls, lost = [], 0
LISTS = ("level_hist_count", "level_hist_rows")
for _ in range(fits):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = est.fit(X, y, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "level_hist" in e.name),
                 key=lambda e: e.time_range.start)
    hists, lists, pending = [], [], 0.0
    for e in evs:
        ms = e.time_range.elapsed_us() / 1e3
        if any(k in e.name for k in LISTS):
            pending += ms
        else:
            hists.append(ms + pending)
            lists.append(pending)
            pending = 0.0
    if len(hists) != depth * model.num_members:
        lost += 1
        continue
    for i, (ms, lms) in enumerate(zip(hists, lists)):
        per_level[i % depth].append(ms)
        lists_level[i % depth].append(lms)
n, d = X.shape
bits = 4 if B <= 16 else 8
levels = []
for lv, ms in enumerate(per_level):
    plan = hk.level_plan(n, d, 1, 2, B, 2**lv, bits, (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES))
    levels.append({
        "level": lv, "trees": len(ms),
        "ms": statistics.median(ms) if ms else None,
        "min_ms": min(ms) if ms else None, "max_ms": max(ms) if ms else None,
        "lists_ms": statistics.median(lists_level[lv]) if ms else None,
        "grid": plan.grid, "cs": plan.cs, "clusters": getattr(plan, "clusters", 1),
        "rows_per_chunk": plan.rows_per_chunk, "compact": getattr(plan, "compact", False)})
splits = getattr(hk, "LEVEL_SPLITS", None)
compact = getattr(hk, "LEVEL_COMPACT", None)
print(json.dumps({
    "root": str(root), "workload": workload, "seed": seed, "fits": fits, "lost_fits": lost, "walls_s": walls,
    "levels": levels,
    "sum_ms": sum(r["ms"] for r in levels if r["ms"] is not None),
    "level_splits": None if splits is None else dict(splits),
    "level_compact": None if compact is None else dict(compact),
    "launches": dict(hk.LAUNCHES)}), flush=True)
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--fits", type=int, default=2)
    ap.add_argument("--workload", default="higgs.fit")
    args = ap.parse_args(argv)
    rc = 0
    for root in args.roots:
        rc |= subprocess.run([sys.executable, "-c", ONE, root, str(args.seed),
                              str(args.fits), args.workload]).returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
