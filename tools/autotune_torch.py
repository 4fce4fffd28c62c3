"""Offline autotune search of the PyTorch port, on the card.

Times every registered tunable's candidates with real fenced fits and
kernel launches on this process's device (the CUDA card when one is
present, else the CPU, where the ``pallas`` group is skipped) and
publishes the winners to the port's tuning cache, where every later fit's
sites read them (mode ``cache``, the default):

    python3 tools/autotune_torch.py --budget smoke          # about a minute
    python3 tools/autotune_torch.py --budget full           # letter-shaped
    python3 tools/autotune_torch.py --budget fast --groups fit,pallas --json

The cache location follows ``SE_TPU_AUTOTUNE_CACHE`` (or
``~/.cache/spark_ensemble_tpu_torch/autotune``); ``--out`` overrides it for
this run.  Entries are keyed ``cuda/<device name>/n<log2 rows>`` and
``cuda/<device name>/*``.  ``--no-save`` measures and reports without
publishing.  A winner displaces a default only when it beats it by more
than the noise floor.  ``SE_TPU_COMPILE_CACHE=<dir>`` keeps the kernels'
library there, so a second run loads it without nvcc.  Exit code 0: the
search completed and (unless ``--no-save``) the cache was published.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from spark_ensemble_tpu_torch.autotune.search import BUDGETS, _GROUPS

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--budget", choices=sorted(BUDGETS), default="fast",
        help="search workload size: smoke, fast, full (letter-shaped)",
    )
    parser.add_argument(
        "--groups", default=None,
        help=f"comma-separated subset of {','.join(_GROUPS)} (default: all)",
    )
    parser.add_argument(
        "--out", default=None,
        help="cache directory to publish to (default: SE_TPU_AUTOTUNE_CACHE "
        "or ~/.cache/spark_ensemble_tpu_torch/autotune)",
    )
    parser.add_argument(
        "--no-save", action="store_true",
        help="measure and report only; do not publish the cache",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the full result (winners + per-candidate timings) as JSON",
    )
    args = parser.parse_args(argv)

    from spark_ensemble_tpu_torch.autotune import ensure_compilation_cache, run_search

    ensure_compilation_cache()
    groups = (
        tuple(g.strip() for g in args.groups.split(",") if g.strip())
        if args.groups else None
    )
    res = run_search(
        budget=args.budget,
        groups=groups,
        save=not args.no_save,
        directory=args.out,
    )
    if args.json:
        print(json.dumps(res, indent=2, sort_keys=True))
        return 0
    print(f"platform={res['platform']} device_kind={res['device_kind']} "
          f"shape_class={res['shape_class']} budget={res['budget']}")
    for name, per_candidate in res["timings"].items():
        best = min(per_candidate, key=per_candidate.get)
        row = " | ".join(
            f"{c}{'*' if c == best else ''} {t * 1e3:.3f}ms"
            for c, t in per_candidate.items()
        )
        print(f"  {name}: {row}")
    if res["winners"]:
        print("winners (beat the default by > noise floor):")
        for name, val in sorted(res["winners"].items()):
            print(f"  {name} = {val}")
    else:
        print("winners: none (the defaults hold on this device)")
    if res.get("cache_path"):
        print(f"published: {res['cache_path']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
