"""Dataset loading: libsvm parsing and dense array containers (PyTorch port
of ``utils/datasets.py``; numpy only, the estimators move arrays to the
device).

The reference's substrate is Spark's DataFrame/libsvm reader; ours is a
dense ``(X: f32[n, d], y: f32[n])`` pair of host numpy arrays.  The three
datasets bundled with the reference (``adult``, ``cpusmall``, ``letter``)
are read in place from ``SPARK_ENSEMBLE_REFERENCE_DATA``, else from
``reference/data`` under the checkout, and never copied into the repo.

The native C++ parser (``utils/_libsvm_native.py``) is the fast path.  The
numpy parser gives the same arrays; it runs when the native one cannot be
built or loaded, and the failure is logged.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("spark_ensemble_tpu_torch")

REFERENCE_DATA = os.environ.get(
    "SPARK_ENSEMBLE_REFERENCE_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference", "data"),
)

_DATASETS = {
    "adult": ("adult/adult.svm", "binary"),
    "cpusmall": ("cpusmall/cpusmall.svm", "regression"),
    "letter": ("letter/letter.svm", "multiclass"),
}


def _parse_numpy(
    path: str, n_features: Optional[int]
) -> Tuple[np.ndarray, np.ndarray]:
    labels = []
    rows = []
    max_idx = 0
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            feats = []
            for tok in parts[1:]:
                idx, val = tok.split(":")
                idx = int(idx)
                max_idx = max(max_idx, idx)
                feats.append((idx - 1, float(val)))
            rows.append(feats)
    d = n_features if n_features is not None else max_idx
    X = np.zeros((len(rows), d), dtype=np.float32)
    for i, feats in enumerate(rows):
        for j, v in feats:
            if j < d:  # out-of-range features dropped (native path parity)
                X[i, j] = v
    y = np.asarray(labels, dtype=np.float32)
    return X, y


def parse_libsvm(
    path: str, n_features: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a libsvm text file into dense float32 ``(X, y)`` arrays.

    Mirrors the semantics of Spark's ``format("libsvm")`` reader used
    throughout the reference test suites (1-based feature indices; blank
    and ``#`` lines skipped; indices past ``n_features`` dropped).
    Tries the native parser first and falls back to numpy, logging why."""
    try:
        from spark_ensemble_tpu_torch.utils._libsvm_native import (
            parse_libsvm_native,
        )

        return parse_libsvm_native(path, n_features)
    except Exception:
        logger.warning(
            "native libsvm parser unavailable; parsing %s with numpy",
            path, exc_info=True,
        )
    return _parse_numpy(path, n_features)


def load_dataset(
    name: str, data_dir: Optional[str] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Load one of the reference's bundled datasets by name.

    Labels are normalized the way the reference tests consume them:
    - adult: ±1 → {0, 1}
    - letter: 1..26 → 0..25
    - cpusmall: raw regression target
    """
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(_DATASETS)}")
    rel, kind = _DATASETS[name]
    base = data_dir or REFERENCE_DATA
    path = os.path.join(base, rel)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    X, y = parse_libsvm(path)
    if kind == "binary":
        y = (y > 0).astype(np.float32)
    elif kind == "multiclass":
        y = (y - y.min()).astype(np.float32)
    return X, y


def has_reference_data() -> bool:
    return all(
        os.path.exists(os.path.join(REFERENCE_DATA, rel))
        for rel, _ in _DATASETS.values()
    )


def train_test_split(
    X: np.ndarray,
    y: np.ndarray,
    test_fraction: float = 0.3,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic random split (reference tests: ``df.randomSplit(Array(0.7, 0.3))``)."""
    rng = np.random.RandomState(seed)
    n = X.shape[0]
    perm = rng.permutation(n)
    n_test = int(round(n * test_fraction))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return X[train_idx], y[train_idx], X[test_idx], y[test_idx]
