"""Weighted median and quantile, exact by sort and cumulative weight
(PyTorch port of the local path of ``utils/quantile.py``).

Reference semantics: ``Utils.weightedMedian`` (`Utils.scala:26-40`) sorts
by value and takes the first element whose cumulative weight reaches half
the total — a ``>=`` crossing.  The sort is stable, as ``jnp.argsort`` is,
so tied values keep their input order and the same element is selected.
The JAX package's sharded path (psum-ed histogram refinement over a mesh)
waits for the distribution slice (ROADMAP queue 1, item 18).
"""

from __future__ import annotations

from typing import Optional

import torch


def _sorted_cum(values: torch.Tensor, weights: torch.Tensor, dim: int = -1):
    order = torch.argsort(values, dim=dim, stable=True)
    v = torch.gather(values, dim, order)
    cum = torch.cumsum(torch.gather(weights, dim, order), dim=dim)
    return v, cum


def weighted_median(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """First value (in sorted order) whose cumulative weight >= total/2."""
    return weighted_median_rows(values[None, :], weights)[0]


def weighted_median_rows(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Row-wise weighted median of ``values [n, m]`` under one weight vector
    ``weights [m]`` -> ``[n]`` (the JAX package vmaps ``weighted_median``
    over rows for Drucker's median vote, ``models/boosting.py``)."""
    w = weights.to(values.dtype).expand_as(values)
    v, cum = _sorted_cum(values, w, dim=1)
    idx = torch.argmax((cum >= 0.5 * cum[:, -1:]).to(torch.uint8), dim=1)
    return v.gather(1, idx[:, None])[:, 0]


def weighted_quantile(values: torch.Tensor, q,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact weighted quantile(s): the first sorted value whose cumulative
    weight reaches ``q * total`` (``q`` a scalar or a vector in [0, 1]),
    clipped to the last value."""
    if weights is None:
        weights = torch.ones_like(values)
    v, cum = _sorted_cum(values, weights)
    target = torch.as_tensor(q, dtype=cum.dtype, device=cum.device) * cum[-1]
    idx = torch.searchsorted(cum, target.reshape(-1), side="left")
    idx = torch.clamp(idx, 0, v.shape[0] - 1)
    return v[idx].reshape(target.shape)
