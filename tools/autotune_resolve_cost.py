"""The autotune layer's host cost on the card, in one process.

    python3 tools/autotune_resolve_cost.py [--fits 4]

Prints one JSON line with the time of one ``resolve`` call outside a fit,
of ``ops/hist_kernels.level_knobs`` (two resolves) and of the ``stat`` of
an absent manifest, each the mean of 20,000 calls; then the rate (rounds
per second) of 100-round fits of the main path (the fused tier, letter-
shaped data) with the sites resolving as shipped against the same fits
with every per-round site (``level_knobs``, ``pack_width``'s ``pack_bits``)
replaced by its constant, alternating which runs first; then the card's
name and power limit.  It needs a CUDA card and an empty tuning cache
(``SE_TPU_AUTOTUNE_CACHE`` is pointed at a fresh temporary directory).
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--fits", type=int, default=4, help="fits of each kind")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("autotune_resolve_cost: no CUDA card", file=sys.stderr)
        return 2
    os.environ["SE_TPU_AUTOTUNE_CACHE"] = tempfile.mkdtemp(prefix="atc-")

    import chip_smoke as cs
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.autotune.cache import cache_dir
    from spark_ensemble_tpu_torch.autotune.resolve import resolve
    from spark_ensemble_tpu_torch.ops import binning, hist_kernels as hk
    from spark_ensemble_tpu_torch.ops import tree as tt

    hk.build_kernels()
    manifest = os.path.join(cache_dir(), "latest", "manifest.json")
    out = {}
    for name, fn in (("resolve_us", lambda: resolve("fused_block_rows", 256, n=15000)),
                     ("level_knobs_us", lambda: hk.level_knobs(3, 15000)),
                     ("stat_absent_manifest_us", lambda: os.path.exists(manifest))):
        fn()
        t0 = time.perf_counter()
        for _ in range(20000):
            fn()
        out[name] = (time.perf_counter() - t0) / 20000 * 1e6

    X, y = cs.letter_data()

    def rate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs._main_path_gbm(st, 100).fit(X, y, device="cuda")
        torch.cuda.synchronize()
        return 100 / (time.perf_counter() - t0)

    shipped = (tt.level_knobs, binning._tuned)
    constants = (lambda nterms, n=None: (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES),
                 lambda name, default, n=None: default)
    rate()  # warm
    rates = {"resolving": [], "constants": []}
    try:
        for i in range(args.fits):
            order = ("resolving", "constants") if i % 2 == 0 else ("constants", "resolving")
            for kind in order:
                tt.level_knobs, binning._tuned = shipped if kind == "resolving" else constants
                rates[kind].append(rate())
    finally:
        tt.level_knobs, binning._tuned = shipped
    out["iters_per_s"] = rates
    print(json.dumps(out), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
