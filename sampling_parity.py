#!/usr/bin/env python3
"""GBM's gradient row sampling at the main path's full width, the JAX
package against the PyTorch port, on the CPU.

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 sampling_parity.py

Fits bench.py's main-path classifier (logloss, newton, learning rate 0.3,
depth-5, 64-bin trees on the scatter tier, 20 rounds) on letter-shaped
synthetic data (15000 x 16, 26 classes, seed 0, as chip_smoke.py makes it)
with ``sampling`` none, goss (0.2/0.1) and mvs, and with the legacy
``sample_method="goss"``, in both packages, and prints one JSON line per
method with each package's train accuracy and fit seconds.  Like the
tests, it imports both packages; the port runs on ``device="cpu"``.
Takes about five minutes.
"""

import json
import time

import numpy as np

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st

METHODS = (("none", {}), ("goss", dict(sampling="goss", top_rate=0.2, other_rate=0.1)),
           ("mvs", dict(sampling="mvs")), ("legacy_goss", dict(sample_method="goss")))


def main():
    rng = np.random.RandomState(0)
    X = rng.randn(15000, 16).astype(np.float32)
    centers = rng.randn(26, 16).astype(np.float32)
    y = np.argmax(X @ centers.T + 0.5 * rng.randn(15000, 26), axis=1).astype(np.float32)
    kw = dict(num_base_learners=20, loss="logloss", updates="newton", learning_rate=0.3)
    for label, extra in METHODS:
        row = {"method": label}
        for name, pkg in (("jax", se), ("port", st)):
            est = pkg.GBMClassifier(base_learner=pkg.DecisionTreeRegressor(hist="scatter"),
                                    **kw, **extra)
            t0 = time.perf_counter()
            model = est.fit(X, y) if pkg is se else est.fit(X, y, device="cpu")
            row[f"{name}_fit_s"] = time.perf_counter() - t0
            row[f"{name}_train_accuracy"] = float(np.mean(np.asarray(model.predict(X)) == y))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
