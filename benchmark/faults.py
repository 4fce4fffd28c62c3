"""Faults planted under the timed path, and the lower-precision control.

Each fault patches the program in this process only, inside a ``with``
block, and restores it on exit.  They exist to show that the check fails
what it must (``benchmark/tests/test_bench_runs.py``; ``benchmark/control.py``
reads them on the card at the cells' sizes):

- ``unchanged``: a boosting round returns its predictions unchanged;
- ``half_batch``: a round's trees fit on half of the rows, their
  statistics' means taken over that half;
- ``altered``: one leaf value of every fitted tree is moved by 1% of the
  tree's spread of leaf values, where it is produced.

The control is the program with the configuration's ``control_params``
(``hist_precision="default"``: statistics rounded to bf16).
"""

from __future__ import annotations

import contextlib

import torch

FIT_FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def planted(fault: str):
    """A context manager that plants ``fault`` in the program."""
    from spark_ensemble_tpu_torch.models import gbm, tree

    if fault == "unchanged":
        return _patched(gbm, "_advance", lambda orig: lambda pred, *a, **k: pred.clone())
    if fault == "half_batch":
        def make(orig):
            def half(*args, **kwargs):
                labels, fit_w, bag_w = orig(*args, **kwargs)
                n = fit_w.shape[0]
                keep = (torch.arange(n, device=fit_w.device) < n // 2).to(fit_w.dtype)
                return labels, fit_w * keep[:, None] * 2.0, bag_w
            return half
        return _patched(gbm, "_pseudo_residuals_and_weights", make)
    if fault == "altered":
        def make(orig):
            def altered(*args, **kwargs):
                out = orig(*args, **kwargs)
                trees = out[0] if isinstance(out, tuple) else out
                lv = trees.leaf_value
                spread = lv.amax(dim=(1, 2)) - lv.amin(dim=(1, 2))
                lv[:, 0, 0] += 0.01 * spread
                return out
            return altered
        return _patched(tree, "fit_forest", make)
    raise ValueError(f"unknown fault {fault!r}")
