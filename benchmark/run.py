"""Run one benchmark cell once and print its result as the last line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found by
name from ``BENCHMARK.json`` (``benchmark/README.md``).  The run builds
its inputs from ``--seed`` on the card, warms up (``setup_s``), measures
for ``--seconds``, checks what the window produced against the plain
reference in ``benchmark/reference/``, and prints one JSON object.  It
exits non-zero without a result when the card or the program is missing,
or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import env

    env.prepare(ROOT)
    from benchmark.harness import spec

    cell = spec.load_cell(args.workload, ROOT)
    from benchmark.harness import device

    try:
        device.require(cell.chips)
    except device.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    from benchmark.harness.cell import print_checks, print_notes, result_line, run_cell

    fields = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = env.forbidden_loaded()
    if loaded:
        print(f"no result: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    line = result_line(fields, device.entry(cell.chips, fields["memory_peak_bytes"]))
    print_notes(fields, device.power_limit())
    print_checks(fields["checks"])
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
