"""Readings of a cell's check on many seeds, for the sound program, the
lower-precision control and the planted faults, in one process.

    python benchmark/control.py --workload higgs.fit --seeds 1,2,3 \
        --variants program,control,unchanged,half_batch,altered

Each (variant, seed) sets the cell up from the seed at its own size, runs
the timed entry once (one whole fit) and prints one JSON line with the
check's numbers.  The limits in
``benchmark/limits/`` are set between the sound program's largest
readings and the smallest readings of the control and the faults
(``PERF.md``).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fit_reading(drv, cell, seed, variant, device, rows=None):
    from benchmark import faults

    over = cell.config.get("control_params", {}) if variant == "control" else {}
    state = drv.setup(cell, seed, device, rows=rows, **over)
    ctx = faults.planted(variant) if variant in faults.FIT_FAULTS else _null()
    with ctx:
        model = state.est.fit(state.X, state.y, device=state.device)
    return drv.check(cell, state, {"models": [model]}, seed)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--variants", default="program,control")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=None, help="a smaller table (tests)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env

    env.prepare(ROOT)
    import torch

    from benchmark.harness import spec

    cell = spec.load_cell(args.workload, ROOT)
    drv = spec.driver_module(cell.driver, cell.root)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            numbers = fit_reading(drv, cell, seed, variant, torch.device(args.device), args.rows)
            print(json.dumps({"workload": cell.name, "variant": variant, "seed": seed,
                              "numbers": numbers, "s": time.perf_counter() - t}), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
