#!/usr/bin/env python3
"""Fit throughput of the port's fused tier and its kernels' times, one
checkout against another, on one CUDA card.

    python3 fit_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each argument is the root of a checkout (a directory holding
``spark_ensemble_tpu_torch/``).  For each, in the order given, a fresh
Python process imports that checkout's package, builds its kernels, warms up
with a 3-round fit, then times two 100-round fits of the main path
(GBMClassifier, logloss, newton, optimized weights, depth 5, 64 bins, fused
tier) on letter-shaped synthetic data, and counts the host calls of a third
under the profiler.  It also times the main path's four kernel calls at
their deepest shapes through that checkout's wrappers (15000 rows, 26
members, 16 features, 64 bins in 8-bit lanes: the level histograms at 16
nodes, the route at 8 parents, the leaf pass routed from 16 parents into 32
leaves, and one ``index_add_`` on the leaf pass's cell ids): ``ms`` per call
with CUDA events around 50 calls, host issue time included, and
``device_ms``, the kernels' own time per call from ``torch.profiler``; each
the median, min and max of 5 runs.  It prints one JSON line per checkout,
then the card's name and power limit.  Two checkouts compare fairly only
within one run, on one card, in alternating order.
"""

import subprocess
import sys

ONE = r'''
import json, statistics, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.ops import binning, hist_kernels as hk
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

rng = np.random.RandomState(0)
X = rng.randn(15000, 16).astype(np.float32)
centers = rng.randn(26, 16).astype(np.float32)
y = np.argmax(X @ centers.T + 0.5 * rng.randn(15000, 26), axis=1).astype(np.float32)

def gbm(rounds):
    return st.GBMClassifier(
        num_base_learners=rounds, loss="logloss", updates="newton", learning_rate=0.3,
        optimized_weights=True,
        base_learner=st.DecisionTreeRegressor(max_depth=5, max_bins=64, hist="fused",
                                              hist_precision="highest"))

def ms(fn, runs=5, reps=50):
    fn(); torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record(); torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return [times[runs // 2], times[0], times[-1]]

def device_ms(fn, runs=5, reps=50):
    """As chip_smoke.py's device_ms: per run, each kernel's median traced
    duration times its launches per call, since a trace can drop events."""
    fn(); torch.cuda.synchronize()
    traces = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us.setdefault(e.name, []).append(e.time_range.elapsed_us())
        traces.append(us)
    per_call = {}
    for us in traces:
        for k, v in us.items():
            per_call[k] = max(per_call.get(k, 0.0), len(v) / reps)
    times = sorted(sum(statistics.median(v) * per_call[k] for k, v in us.items()) / 1e3
                   for us in traces)
    return [times[runs // 2], times[0], times[-1]]

hk.build_kernels()
dev = torch.device("cuda")
kr = np.random.RandomState(1)
Xd = torch.as_tensor(X, device=dev)
Xb = binning.bin_features(Xd, binning.compute_bins(Xd, 64))
packed = binning.pack_bins(Xb, 64, 8).packed
vals = torch.as_tensor(np.stack([kr.rand(15000, 26), kr.randn(15000, 26)], axis=2).astype(np.float32), device=dev)
ids = lambda k: torch.as_tensor(kr.randint(0, k, size=(15000, 26)).astype(np.int32), device=dev)
tab = lambda k, hi: torch.as_tensor(kr.randint(0, hi, size=(26, k)).astype(np.int32), device=dev)
node16, p8, p16 = ids(16), ids(8), ids(16)
bf8, bt8, bf16, bt16 = tab(8, 16), tab(8, 64), tab(16, 16), tab(16, 64)
kw = dict(bits=8, num_features=16)
calls = {
    "hist_i32": lambda: hk.hist_level_pallas(Xb, node16, vals, n_nodes=16, max_bins=64),
    "hist_packed": lambda: hk.hist_level_packed(packed, node16, vals, n_nodes=16, max_bins=64, **kw),
    "route_packed": lambda: hk.route_packed(packed, p8, bf8, bt8, **kw),
    "leaf_sums": lambda: hk.fused_round_level(packed, p16, vals, bf16, bt16, n_nodes=32, max_bins=64,
                                              leaf=True, **kw),
}
leaf_ids = hk.route_plain(Xb, p16, bf16, bt16)
lidx = (torch.arange(26, device=dev)[None, :] * 32 + leaf_ids.long()).reshape(-1)
lacc, lsrc = torch.zeros(26 * 32, 2, device=dev), vals.reshape(-1, 2)
calls["leaf_index_add_"] = lambda: lacc.index_add_(0, lidx, lsrc)
kernels = {k: {"ms": ms(f), "device_ms": device_ms(f)} for k, f in calls.items()}
gbm(3).fit(X, y, device="cuda")
rates = []
for _ in range(2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = gbm(100).fit(X, y, device="cuda")
    torch.cuda.synchronize()
    rates.append(100 / (time.perf_counter() - t0))
with profile(activities=[ProfilerActivity.CPU]) as prof:
    gbm(100).fit(X, y, device="cuda")
    torch.cuda.synchronize()
host_calls = {e.key: e.count for e in prof.key_averages()
              if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaStreamSynchronize",
                           "aten::_local_scalar_dense")}
acc = float((model.predict(X).cpu().numpy() == y).mean())
print(json.dumps({"checkout": sys.argv[1], "iters_per_s": rates, "train_accuracy": acc,
                  "host_calls_100_rounds": host_calls, "kernels": kernels}), flush=True)
'''


def main():
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("fit_ab: needs a CUDA card and at least one checkout directory", file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, "-c", ONE, root], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
