"""Weighted median and quantile (PyTorch port of ``utils/quantile.py``).

Reference semantics: ``Utils.weightedMedian`` (`Utils.scala:26-40`) sorts
by value and takes the first element whose cumulative weight reaches half
the total — a ``>=`` crossing.  Local inputs take the exact kernel: a
stable sort (as ``jnp.argsort``, so tied values keep their input order and
the same element is selected), a cumulative sum and a search.

Sharded inputs (``axis_name``, a mesh fit's row axis) never gather the
column, as the reference's streaming ``approxQuantile`` never holds it on
one executor: 4 rounds of 256-bin weight histograms, each reduced across
the ranks, walk the monotone map of f32 values onto the 2^32 integer keys
down to one key (256^4 = 2^32).  The keys are held in int64, since torch
has no full unsigned 32-bit arithmetic.  The result is the first value
whose global cumulative weight reaches the target: always a data value of
positive weight, and bit-identical to the exact local kernel whenever the
weight sums are exactly representable (the crossing test compares sums
accumulated in other orders, so with general f32 weights a crossing
within one ulp of the target may pick the neighbouring value).
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_ensemble_tpu_torch.ops.collective import (
    pmax_reduce,
    pmin_reduce,
    preduce,
)

# 4 rounds x 256 bins walk the 2^32 keys down to one: 256^4 = 2^32
_BINS = 256
_ROUNDS = 4
_SIGN = 0x80000000


def _f32_keys(v: torch.Tensor) -> torch.Tensor:
    """Monotone map f32 -> [0, 2^32) in int64 (the radix-sort key trick:
    the sign bit set for non-negatives, all bits flipped for negatives);
    -0.0 keys just below +0.0 and NaNs above +inf."""
    b = v.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b >= 0, b.to(torch.int64) + _SIGN, (~b).to(torch.int64))


def _key_to_f32(u: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_f32_keys``."""
    b = torch.where(u >= _SIGN, u - _SIGN, ~u).to(torch.int32)
    return b.view(torch.float32)


def _sharded_crossing_key(u, w, finite_lo, finite_hi, target, axis_name):
    """Key of the first value whose GLOBAL cumulative weight >= ``target``:
    each round buckets this rank's in-bracket keys into 256 equal key
    ranges, reduces the 256 weights across the ranks, and narrows the
    bracket to the bin where the cumulative crosses the target.  The
    crossing bin always carries positive weight, so zero-weight values are
    never selected."""
    lo, hi = finite_lo, finite_hi
    cum_below = torch.zeros((), dtype=torch.float32, device=u.device)
    for _ in range(_ROUNDS):
        step = (hi - lo) // _BINS + 1
        rel = (u - lo) // step
        in_bracket = (u >= lo) & (u <= hi)
        hist = torch.zeros((_BINS,), dtype=torch.float32, device=u.device)
        # the sort-based accumulation: repeatable on CUDA, unlike atomics
        hist.index_put_((torch.clamp(rel, 0, _BINS - 1),),
                        torch.where(in_bracket, w, 0.0), accumulate=True)
        hist = preduce(hist, axis_name)
        cum = cum_below + torch.cumsum(hist, dim=0)
        ge = cum >= target
        # rounding slack can leave the target above the last cumulative:
        # take the bin holding hi, which converges on the data max
        hi_bin = (hi - lo) // step
        j = torch.where(ge.any(), torch.argmax(ge.to(torch.uint8)), hi_bin)
        new_lo = lo + j * step
        hi = torch.minimum(hi, new_lo + step - 1)
        cum_below = torch.where(j > 0, cum[torch.clamp(j - 1, min=0)], cum_below)
        lo = new_lo
    return lo


def _crossing_value_sharded(values, weights, q, axis_name):
    w = weights.to(torch.float32)
    total = preduce(torch.sum(w), axis_name)
    target = torch.as_tensor(q, dtype=torch.float32, device=values.device) * total
    u = _f32_keys(values)
    # bracket at the global finite min/max: a q=0 walk converges to the
    # bracket's low edge, which must be the smallest data value; NaNs
    # stay out of the bracket
    finite = ~torch.isnan(values)
    inf = torch.tensor(float("inf"), device=values.device)
    lo0 = _f32_keys(pmin_reduce(torch.min(torch.where(finite, values, inf)), axis_name))
    hi0 = _f32_keys(pmax_reduce(torch.max(torch.where(finite, values, -inf)), axis_name))
    keys = [_sharded_crossing_key(u, w, lo0, hi0, t, axis_name)
            for t in target.reshape(-1)]
    return _key_to_f32(torch.stack(keys)).reshape(target.shape)


def _sorted_cum(values: torch.Tensor, weights: torch.Tensor, dim: int = -1):
    order = torch.argsort(values, dim=dim, stable=True)
    v = torch.gather(values, dim, order)
    cum = torch.cumsum(torch.gather(weights, dim, order), dim=dim)
    return v, cum


def weighted_median(values: torch.Tensor, weights: torch.Tensor,
                    axis_name=None) -> torch.Tensor:
    """First value (in sorted order) whose cumulative weight >= total/2;
    with ``axis_name`` the global median of the ranks' rows, by the
    sharded walk (module docstring)."""
    if axis_name is not None:
        return _crossing_value_sharded(values, weights, 0.5, axis_name)
    return weighted_median_rows(values[None, :], weights)[0]


def weighted_median_rows(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Row-wise weighted median of ``values [n, m]`` under one weight vector
    ``weights [m]`` -> ``[n]`` (the JAX package vmaps ``weighted_median``
    over rows for Drucker's median vote, ``models/boosting.py``)."""
    w = weights.to(values.dtype).expand_as(values)
    order = torch.argsort(values, dim=1, stable=True)
    v = torch.gather(values, 1, order)
    ws = torch.gather(w, 1, order)
    # the running sum column by column, in member order: a row's sum then
    # does not depend on how many rows share the call (a scan kernel over
    # [n, m] may split the rows' sums another way at another n)
    cols = [ws[:, 0]]
    for j in range(1, ws.shape[1]):
        cols.append(cols[-1] + ws[:, j])
    cum = torch.stack(cols, dim=1)
    idx = torch.argmax((cum >= 0.5 * cum[:, -1:]).to(torch.uint8), dim=1)
    return v.gather(1, idx[:, None])[:, 0]


def weighted_quantile(values: torch.Tensor, q,
                      weights: Optional[torch.Tensor] = None,
                      axis_name=None) -> torch.Tensor:
    """Exact weighted quantile(s): the first sorted value whose cumulative
    weight reaches ``q * total`` (``q`` a scalar or a vector in [0, 1]),
    clipped to the last value.  With ``axis_name`` the global quantile of
    the ranks' rows, by the sharded walk (module docstring)."""
    if weights is None:
        weights = torch.ones_like(values)
    if axis_name is not None:
        return _crossing_value_sharded(values, weights, q, axis_name)
    v, cum = _sorted_cum(values, weights)
    target = torch.as_tensor(q, dtype=cum.dtype, device=cum.device) * cum[-1]
    idx = torch.searchsorted(cum, target.reshape(-1), side="left")
    idx = torch.clamp(idx, 0, v.shape[0] - 1)
    return v[idx].reshape(target.shape)
