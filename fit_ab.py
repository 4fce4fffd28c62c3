#!/usr/bin/env python3
"""Fit throughput of the port's fused tier, one checkout against another, on
one CUDA card.

    python3 fit_ab.py PARENT_DIR CHANGE_DIR CHANGE_DIR PARENT_DIR

Each argument is the root of a checkout (a directory holding
``spark_ensemble_tpu_torch/``).  For each, in the order given, a fresh
Python process imports that checkout's package, builds its kernels, warms up
with a 3-round fit, then times two 100-round fits of the main path
(GBMClassifier, logloss, newton, optimized weights, depth 5, 64 bins, fused
tier) on letter-shaped synthetic data, and counts the host calls of a third
under the profiler.  It prints one JSON line per checkout, then the card's
name and power limit.  Two checkouts compare fairly only within one run, on
one card, in alternating order.
"""

import subprocess
import sys

ONE = r'''
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
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

hk.build_kernels()
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
calls = {e.key: e.count for e in prof.key_averages()
         if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaStreamSynchronize",
                      "aten::_local_scalar_dense")}
acc = float((model.predict(X).cpu().numpy() == y).mean())
print(json.dumps({"checkout": sys.argv[1], "iters_per_s": rates, "train_accuracy": acc,
                  "host_calls_100_rounds": calls}), flush=True)
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
