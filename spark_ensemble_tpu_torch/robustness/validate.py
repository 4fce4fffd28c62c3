"""Fail-fast input validation at ``fit()`` entry (PyTorch port of
``robustness/validate.py``).

A NaN/Inf feature or label does not crash a fit: it flows through every
round and yields a silently non-finite model.  One fused all-finite
reduction over X and y runs at fit entry (one host read); only when it
fails is each array checked alone, to name the culprit.  ``allow_nan=True``
is the escape hatch.
"""

from __future__ import annotations

import torch


def _all_finite(arrs) -> bool:
    return bool(torch.stack([torch.isfinite(a).all() for a in arrs]).all())


def validate_fit_inputs(X, y=None, allow_nan: bool = False,
                        family: str = "") -> None:
    """Raise ``ValueError`` when X (or y) holds NaN/Inf, unless
    ``allow_nan``.  Non-float inputs pass through untouched."""
    if allow_nan:
        return
    named = [(name, a) for name, a in (("X", X), ("y", y))
             if a is not None and a.is_floating_point()]
    if not named or _all_finite([a for _, a in named]):
        return
    bad = [name for name, a in named if not _all_finite([a])]
    prefix = f"{family}: " if family else ""
    raise ValueError(
        f"{prefix}{' and '.join(bad) or 'input'} contains NaN or Inf values; "
        "ensemble fits would silently produce a non-finite model. Clean the "
        "inputs, or pass allow_nan=True to skip this check."
    )
