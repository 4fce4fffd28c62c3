"""Quantile feature binning (PyTorch port of ``ops/binning.py``).

Bin semantics: ``bin(x) = #{i : t_i < x}`` so a split at bin ``b`` ("go
left iff bin <= b") is exactly "go left iff x <= t_b"; trees trained on
binned features predict on raw ones.

Thresholds must match the JAX package bit for bit, because every split the
trees store is one of them.  ``torch.quantile`` interpolates differently
from ``jnp.quantile`` (10-14% of thresholds differ at letter scale), so
``compute_bins`` restates ``jnp.quantile``'s 'linear' method: float32
positions ``q * (n - 1)``, float32 weights, and the interpolation as XLA
evaluates it, ``fma(low, low_w, f32(high * high_w))`` — emulated in float64,
which rounds once like the fused multiply-add.

Packed bins are int32 bit patterns of the JAX package's uint32 words
(torch has no ``>>`` for uint32 on the CPU): each unpack shift is
arithmetic and is masked right after, so the low ``bits`` are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Bins(NamedTuple):
    """Per-feature split thresholds; ``thresholds[f, i]`` ascending in i."""

    thresholds: torch.Tensor  # f32[d, max_bins - 1]

    @property
    def max_bins(self) -> int:
        return self.thresholds.shape[1] + 1

    @property
    def num_features(self) -> int:
        return self.thresholds.shape[0]


def compute_bins(X: torch.Tensor, max_bins: int = 64) -> Bins:
    """Quantile thresholds at (i+1)/max_bins, i = 0..max_bins-2, per
    feature — bit-identical to ``jnp.quantile(X, qs, axis=0).T``."""
    X = X.to(torch.float32)
    n = X.shape[0]
    q = torch.arange(1, max_bins, dtype=torch.float32, device=X.device) / max_bins
    pos = q * torch.tensor(float(n - 1), dtype=torch.float32, device=X.device)
    low = torch.floor(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low_i = low.clamp(0, n - 1).long()
    high_i = torch.ceil(pos).clamp(0, n - 1).long()
    S = torch.sort(X, dim=0).values  # [n, d]
    lv, hv = S[low_i], S[high_i]  # [B-1, d]
    hh = hv * high_w[:, None]  # rounded to f32, as XLA's fused form does
    thr = (lv.double() * low_w.double()[:, None] + hh.double()).to(torch.float32)
    # a column holding NaN quantiles to all-NaN, like jnp.quantile
    thr[:, torch.isnan(X).any(dim=0)] = float("nan")
    return Bins(thresholds=thr.T.contiguous())


def bin_features(X: torch.Tensor, bins: Bins) -> torch.Tensor:
    """``int32[n, d]`` bin indices: count of thresholds strictly below x."""
    ids = torch.searchsorted(
        bins.thresholds.contiguous(), X.to(torch.float32).T.contiguous(),
        right=False,
    )
    return ids.T.to(torch.int32).contiguous()


def bin_occupancy_ids(ids: torch.Tensor, max_bins: int) -> torch.Tensor:
    """``int32[d, max_bins]`` per-feature counts of the bin ids ``ids``
    (``int[n, d]``), counted where ``ids`` lives by one integer
    ``scatter_add_`` into a fixed-size buffer.  ``torch.bincount`` would
    read its output size back from the device: a host sync, which a CUDA
    graph cannot capture."""
    n, d = ids.shape
    offsets = torch.arange(d, device=ids.device, dtype=torch.int64) * max_bins
    flat = (ids.to(torch.int64) + offsets).reshape(-1)
    out = torch.zeros(d * max_bins, dtype=torch.int32, device=ids.device)
    out.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out.reshape(d, max_bins)


def bin_occupancy(X: torch.Tensor, bins: Bins) -> torch.Tensor:
    """``int32[d, max_bins]`` per-feature bin-count histogram of ``X``'s
    rows under ``bins``: the drift-sketch primitive
    (``telemetry/quality.py``).  The counts are exact integers, so the
    sketch does not depend on row order or on how a request stream was
    split into batches: histograms of any partition of the rows sum to
    the histogram of the whole, which the serving engine's padded-bucket
    accumulation relies on."""
    return bin_occupancy_ids(bin_features(X, bins), bins.max_bins)


class CompressedBins(NamedTuple):
    """Bit-packed bin matrix: ``packed[r, w]`` holds ``32 // bits`` ids,
    stored as int32 bit patterns of the JAX package's uint32 words."""

    packed: torch.Tensor  # i32[n, W], W = ceil(d / (32 // bits))
    bits: int  # lane width: 4, 8, or 32 (32 = unpacked passthrough)
    num_features: int  # d before padding

    @property
    def lanes(self) -> int:
        return 32 // self.bits

    @property
    def words_per_row(self) -> int:
        return self.packed.shape[1]


def pack_width(max_bins: int) -> int:
    """Lane width (bits) for ``max_bins`` bin ids: the narrowest of {4, 8}
    that holds ``max_bins`` values, or 32 (no packing) past 256 — the JAX
    package's static rule with autotune off."""
    return 4 if max_bins <= 16 else (8 if max_bins <= 256 else 32)


def pack_bins(Xb: torch.Tensor, max_bins: int, bits: int = 0) -> CompressedBins:
    """Pack ``Xb i32[n, d]`` (ids in [0, max_bins)) into ``bits``-bit lanes.
    Lane-major layout: word ``w`` of a row packs features ``l*W + w`` for
    lane ``l``.  Trailing pad features pack as id 0."""
    n, d = Xb.shape
    bits = bits or pack_width(max_bins)
    if bits >= 32:
        return CompressedBins(
            packed=Xb.to(torch.int32).contiguous(), bits=32, num_features=d
        )
    lanes = 32 // bits
    W = -(-d // lanes)
    X = torch.zeros((n, W * lanes), dtype=torch.int64, device=Xb.device)
    X[:, :d] = Xb.to(torch.int64)
    X = X.reshape(n, lanes, W)
    words = torch.zeros((n, W), dtype=torch.int64, device=Xb.device)
    for lane in range(lanes):
        words |= X[:, lane, :] << (lane * bits)
    # uint32 value -> the int32 with the same bits
    words = torch.where(words >= 2**31, words - 2**32, words)
    return CompressedBins(
        packed=words.to(torch.int32).contiguous(), bits=bits, num_features=d
    )


def unpack_bins(cb: CompressedBins) -> torch.Tensor:
    """Inverse of :func:`pack_bins`: ``i32[n, d]`` bin ids."""
    if cb.bits >= 32:
        return cb.packed.to(torch.int32)
    n, W = cb.packed.shape
    shifts = torch.arange(0, 32, cb.bits, dtype=torch.int32, device=cb.packed.device)
    # [n, lanes, W]: lane l of word w is feature l*W + w (three launches)
    lanes = (cb.packed[:, None, :] >> shifts[None, :, None]) & (2**cb.bits - 1)
    return lanes.reshape(n, cb.lanes * W)[:, : cb.num_features].contiguous()
