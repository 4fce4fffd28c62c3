"""Counter-based random draws, bit-exact with ``jax.random`` (PyTorch port
of ``utils/random.py``).

The JAX package draws every bag weight and feature mask from
``jax.random``'s threefry2x32 generator, with
``jax_threefry_partitionable`` on (the default of jax 0.9).  This module is
the port's own copy of the pieces it uses, written in torch integer ops so
the same keys give the same bits on the CPU and on the card (the one float
function on the way, ``log`` in :func:`poisson`, runs on the CPU):

- keys: :func:`PRNGKey`, :func:`fold_in`, :func:`split`;
- draws: :func:`random_bits` (32-bit), :func:`uniform` (float32 in
  [minval, maxval)), :func:`bernoulli` (mode ``low``), :func:`randint`
  (int32) and :func:`poisson` (Knuth's loop, rate < 10);
- the sampling plans: :func:`member_keys`, :func:`bootstrap_weights`,
  :func:`subspace_mask`.

A key is an ``int64[..., 2]`` tensor holding two 32-bit words; torch's
``uint32`` lacks most CUDA ops, so every word is carried in ``int64`` and
masked with ``0xFFFFFFFF``.  Leading key axes batch a draw (the JAX
package's ``vmap`` over members): a draw of ``shape`` from keys
``[..., 2]`` has shape ``[..., *shape]``, each key's draw equal to the
unbatched one.

Sampling semantics (the reference's ``RDD.sample`` and ``subspace()``):
row sampling becomes a weight vector (Poisson counts with replacement, a
0/1 Bernoulli mask without) and a feature subspace a boolean mask.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all ``int64`` tensors of 32-bit values,
    broadcast together.  jax's ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _hash_keys(key: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    """Hash counters ``(hi, lo)`` of shape ``S`` under keys ``[..., 2]`` ->
    two word tensors of shape ``[..., *S]``."""
    lead = key.shape[:-1]
    view = lead + (1,) * hi.dim()
    return threefry2x32(key[..., 0].reshape(view), key[..., 1].reshape(view),
                        hi, lo)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``[0, seed mod 2^32]`` (jax
    takes an int seed as 32 bits when 64-bit mode is off)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter ``[0, data]`` (data
    taken as uint32) under ``key``.  ``data`` is an int or an integer
    tensor that broadcasts against the key's leading axes."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` in partitionable mode: key ``i`` is the hash of
    the counter ``[0, i]``, so ``split(key, n)[i] == fold_in(key, i)``.
    Keys ``[..., 2]`` -> ``[..., num, 2]``."""
    lo = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y0, y1 = _hash_keys(key, torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Union[int, Sequence[int]]) -> torch.Tensor:
    """32-bit draws ``int64[..., *shape]`` (jax's
    ``_threefry_random_bits_partitionable``): element ``i`` of the
    row-major flat index hashes the counter ``[i >> 32, i & mask]`` and
    returns the xor of the two output words."""
    shape = _shape(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    y0, y1 = _hash_keys(key, idx >> 32, idx & _MASK)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits of a draw as the
    mantissa of a float in [1, 2), less 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats  # jax's floats * 1 + 0, floored at 0: floats exactly
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # jax's f32 ``floats * (hi - lo) + lo`` compiles to one fused
    # multiply-add: the product is exact in float64, and the sum is
    # rounded to float32 once (up to a double rounding of ~2^-29 odds)
    # graftlint: ignore[f64-upcast] -- emulates jax.random.uniform's fused multiply-add: the product exact in float64, one rounding to float32
    span = (hi - lo).to(torch.float64)
    # graftlint: ignore[f64-upcast] -- the same fused multiply-add emulation
    out = (floats.to(torch.float64) * span + lo.to(torch.float64)).to(torch.float32)
    return torch.maximum(lo, out)


def bernoulli(key: torch.Tensor, p: float, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode ``low``): ``uniform < p`` in float32
    (the scalar compares as float32, with no copy to the device)."""
    return uniform(key, shape) < float(np.float32(p))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32: two 32-bit draws (from
    ``split(key)``) folded into ``[minval, maxval)`` modulo the span with
    jax's uint32 arithmetic (``2^32 mod span`` as the high word's
    multiplier)."""
    if not (-(2**31) <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint draws int32 values; minval/maxval out of range")
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    # uint32 products wrap: 2^16 squared is 0 there
    multiplier = ((2**16 % span) ** 2 & _MASK) % span
    offset = ((higher % span) * multiplier & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return (minval + offset).to(torch.int32)


def poisson(key: torch.Tensor, lam: float, shape=()) -> torch.Tensor:
    """``jax.random.poisson`` for a rate below 10 (Knuth's algorithm, the
    branch jax takes there) -> int32.  jax's loop, copied: every
    iteration splits the carried key, counts each element whose log
    product still lies above ``-lam`` and adds ``log(uniform)`` of the
    subkey to every element; it stops when no element is still running
    (per key, when keys are batched: a finished key's counts no longer
    move, as under jax's ``vmap``).

    The uniforms are drawn on the key's device, but their logs are taken
    and summed on the CPU: the card's ``torch.log`` differs from the CPU's
    in the last bit on some inputs (about 8% of uniforms on an H100), and
    a count whose log product lands within that bit of ``-lam`` would
    differ.  So the counts are the CPU's, and jax's, on every device."""
    lam = float(lam)
    if not lam < 10.0:
        raise NotImplementedError(
            "poisson draws at rates >= 10 take jax's rejection sampler, "
            "which the port does not have"
        )
    shape = _shape(shape)
    lead = key.shape[:-1]
    if lam == 0.0:
        return torch.zeros(lead + shape, dtype=torch.int32, device=key.device)
    neg_lam = -torch.tensor(lam, dtype=torch.float32)
    k = torch.zeros(lead + shape, dtype=torch.int32)
    log_prod = torch.zeros(lead + shape, dtype=torch.float32)
    rng = key
    while bool((log_prod > neg_lam).any()):
        keys = split(rng, 2)
        rng, sub = keys[..., 0, :], keys[..., 1, :]
        k = torch.where(log_prod > neg_lam, k + 1, k)
        log_prod = log_prod + torch.log(uniform(sub, shape).cpu())
    return (k - 1).to(key.device)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` -> ``int64[n]``: jax's
    ``_shuffle`` of ``arange(n)``, ``ceil(3 ln n / ln(2^32 - 1))`` rounds,
    each splitting the carried key, drawing 32-bit sort keys from the
    subkey and sorting by them stably (the words are non-negative in
    int64, so their order is the uint32 order)."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        keys = split(key, 2)
        key, sub = keys[0], keys[1]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def member_keys(seed: int, num_members: int, device=None) -> torch.Tensor:
    """Independent keys per ensemble member (reference: ``seed + i``)."""
    return split(PRNGKey(seed, device), num_members)


def bootstrap_weights(key: torch.Tensor, n: int, replacement: bool,
                      subsample_ratio: float) -> torch.Tensor:
    """Row-sampling weights ``f32[..., n]`` with Spark ``RDD.sample``
    semantics: Poisson(subsample_ratio) counts with replacement, a
    Bernoulli(subsample_ratio) 0/1 mask without.  Equal on every device:
    :func:`poisson` takes its logs on the CPU."""
    if replacement:
        return poisson(key, subsample_ratio, (n,)).to(torch.float32)
    return bernoulli(key, subsample_ratio, (n,)).to(torch.float32)


def subspace_mask(key: torch.Tensor, num_features: int,
                  subspace_ratio: float) -> torch.Tensor:
    """Bernoulli feature mask ``bool[..., d]`` (reference
    `HasSubBag.scala:73-79`) with at least one active feature: an empty
    draw falls back to one feature drawn by ``randint`` from the same key,
    as the JAX package does."""
    mask = bernoulli(key, subspace_ratio, (num_features,))
    pick = randint(key, (), 0, num_features).long()
    fallback = torch.nn.functional.one_hot(pick, num_features).to(torch.bool)
    return torch.where(mask.any(dim=-1, keepdim=True), mask, fallback)
