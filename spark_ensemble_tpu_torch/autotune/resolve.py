"""Resolution of tunables at fit time (PyTorch port of
``autotune/resolve.py``, the resolution layer only).

Hot-path sites call ``resolve(name, default, n=...)`` with their live
module constant as the default.  Resolution order (first hit wins), as in
the JAX package:

1. an active :func:`override` (tests and in-process toggles);
2. ``SE_TPU_AUTOTUNE=off`` -> the default, always;
3. the on-disk cache entry for the device and shape class (modes
   ``cache``, the default, and ``search``);
4. under mode ``search`` with no entry: a one-shot search fills the cache;
5. the default.

The port has no tuning cache yet (ROADMAP, Slice F), so step 3 finds no
entry and mode ``cache`` resolves to the default, as the JAX package does
when its cache holds nothing for the device.  :func:`search` raises
``NotImplementedError``; mode ``search`` warns and takes the default, as
the JAX package does when its search fails.

Wired sites: ``stream_chunk_rows`` (``ops/tree.py``'s stream tier),
``shard_rows`` (``data/shards.write_shards``) and ``prefetch_depth``
(``data/prefetch.ShardPrefetcher``).  A streaming fit is bit-identical to
a resident ``hist="stream"`` fit only when the two row counts agree, so
tests pin both with ``override(stream_chunk_rows=N, shard_rows=N)``.
"""

from __future__ import annotations

import logging
import os
import warnings
from contextlib import contextmanager
from typing import Optional

logger = logging.getLogger("spark_ensemble_tpu_torch")

MODE_ENV = "SE_TPU_AUTOTUNE"
_MODES = ("off", "cache", "search")

#: the tunables' names (the JAX package's ``autotune/space.py``
#: ``TUNABLES``); each site passes its own shipped default to ``resolve``
TUNABLES = (
    "scan_chunk", "stream_chunk_rows", "shard_rows", "prefetch_depth",
    "predict_fused_max_cells", "hist_tier", "pallas_block_rows",
    "pallas_vmem_budget", "pack_bits", "fused_block_rows",
    "fused_vmem_budget", "predict_bucket_pow2_exact",
    "predict_bucket_octave_steps", "pipeline_depth", "configs_per_dispatch",
    "sample_bucket_floor", "goss_top_rate", "goss_other_rate",
)

# override stack: process-global, not thread-local, as in the JAX package
# (a worker thread running a fit inside an override must see it)
_OVERRIDES: list = []


def autotune_mode() -> str:
    """Active mode: the innermost ``override(mode=...)`` if any, else
    ``SE_TPU_AUTOTUNE`` (default ``cache``)."""
    for frame in reversed(_OVERRIDES):
        if frame.get("mode") is not None:
            return frame["mode"]
    raw = os.environ.get(MODE_ENV, "").strip().lower()
    if not raw:
        return "cache"
    if raw not in _MODES:
        logger.warning(
            "%s=%r is not one of %s; treating as 'off'", MODE_ENV, raw, _MODES
        )
        return "off"
    return raw


@contextmanager
def override(mode: Optional[str] = None, **params):
    """Force tunables (and/or the mode) for a scope; overridden params win
    over everything else.  Unknown names raise."""
    unknown = [k for k in params if k not in TUNABLES]
    if unknown:
        raise ValueError(f"unknown tunables: {unknown}")
    if mode is not None and mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}; got {mode!r}")
    frame = {"mode": mode, "params": params}
    _OVERRIDES.append(frame)
    try:
        yield
    finally:
        _OVERRIDES.remove(frame)


def reset() -> None:
    """Drop any memoized cache view.  The port keeps none yet (no cache),
    so this is a no-op kept for the JAX package's API."""


def search(*args, **kwargs):
    """The measured search that fills the tuning cache: not ported yet."""
    raise NotImplementedError(
        "autotune search is not supported by the PyTorch port yet "
        "(ROADMAP Slice F: autotune/ space, search and cache)"
    )


def resolve(name: str, default, *, n: Optional[int] = None):
    """The tuned value for ``name`` at this site, or ``default``.

    ``default`` is the caller's live module constant (read at call time,
    so a test's monkeypatch of the constant keeps working); ``n`` is the
    row count when the site knows one (the shape class of the JAX
    package's cache key, unused until the cache is ported)."""
    for frame in reversed(_OVERRIDES):
        if name in frame["params"]:
            return frame["params"][name]
    if autotune_mode() == "search":
        # the JAX package runs its search here and, when that fails, warns
        # and goes on: tuning must never break a fit
        warnings.warn(
            f"{MODE_ENV}=search: the PyTorch port has no autotune search "
            "yet (ROADMAP Slice F); using the shipped defaults",
            RuntimeWarning, stacklevel=2,
        )
    # every mode lands on the default: no cache entry exists for any device
    return default
