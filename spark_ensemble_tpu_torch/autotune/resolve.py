"""Resolution of tunables at fit time (PyTorch port of
``autotune/resolve.py``).

Hot-path sites call ``resolve(name, default, n=...)`` with their live
module constant as the default.  Resolution order (first hit wins), as in
the JAX package:

1. an active :func:`override` (tests, the search's candidates);
2. ``SE_TPU_AUTOTUNE=off`` -> the default, always (hand-set estimator
   params never reach resolve at all: the sites skip it);
3. the on-disk cache entry for ``(platform, device_kind, shape_class)``
   (modes ``cache``, the default, and ``search``);
4. under mode ``search`` with no entry for this device: the smoke search
   runs once in-process and publishes, then step 3 serves it;
5. the default.

Within a fit (``utils/instrumentation.instrumented_fit`` enters
:func:`pinned`), each site resolves once: a name, default and row count
looked up again in the same fit returns the first answer from a dict, so
a site read every round or launch costs a dict lookup, not a manifest
``stat`` (``tools/autotune_resolve_cost.py`` times both on the card).
Overrides still win there.

The device is the card when one is present (``("cuda", <device name>)``),
else ``("cpu", "cpu")``; a CPU fit in a process that sees a card resolves
the card's entry too.  The loaded cache is memoized per directory and
revalidated by one ``stat`` of the published manifest per call.  With no
published cache, resolution touches neither the device nor the disk beyond
that ``stat``, so a fit with an empty cache launches and syncs exactly as
one with autotuning off.

Wired sites (``autotune/space.py`` names each): ``scan_chunk``
(``models/base.resolved_scan_chunk``), ``stream_chunk_rows``,
``predict_fused_max_cells`` and ``hist_tier`` (``ops/tree.py``),
``pack_bits`` (``ops/binning.pack_width``), the four kernel knobs
(``ops/hist_kernels.level_knobs``, once per forest fit), ``shard_rows``,
``prefetch_depth``, ``pipeline_depth`` (``execution.py``),
``configs_per_dispatch`` (``models/gbm_sweep.py``) and the sampling stage's
``sample_bucket_floor``, ``goss_top_rate``, ``goss_other_rate``
(``models/gbm.py``).
"""

from __future__ import annotations

import contextvars
import functools
import logging
import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

from spark_ensemble_tpu_torch.autotune.cache import (
    TuningCache,
    cache_dir,
    manifest_signature,
)
from spark_ensemble_tpu_torch.autotune.space import TUNABLES, shape_class

logger = logging.getLogger("spark_ensemble_tpu_torch")

MODE_ENV = "SE_TPU_AUTOTUNE"
_MODES = ("off", "cache", "search")

# override stack: process-global, not thread-local, as in the JAX package
# (a worker thread running a fit inside an override must see it)
_OVERRIDES: list = []

# memoized cache view: {dir: (manifest_signature, TuningCache)}
_LOADED: Dict[str, Tuple[Any, TuningCache]] = {}
_LOAD_LOCK = threading.Lock()

# re-entrancy guard of mode "search" (the search fits models, whose hot
# paths call resolve)
_IN_SEARCH = threading.local()

# the current fit's resolutions, {(name, default, n): value}, or None
# outside a fit; a context variable, so each thread's fit has its own
_PINNED: contextvars.ContextVar = contextvars.ContextVar("autotune_pinned", default=None)


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
    over the cache.  Unknown names raise."""
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


@contextmanager
def pinned():
    """Resolve each (name, default, row count) once in this scope (a fit);
    a nested scope shares the outer one's answers."""
    if _PINNED.get() is not None:
        yield
        return
    token = _PINNED.set({})
    try:
        yield
    finally:
        _PINNED.reset(token)


def reset() -> None:
    """Drop the memoized cache view (tests that swap cache directories or
    content mid-process; the manifest ``stat`` revalidates otherwise)."""
    with _LOAD_LOCK:
        _LOADED.clear()


@functools.lru_cache(maxsize=1)
def _device_identity() -> Tuple[str, str]:
    """``("cuda", <name of card 0>)`` when a card is present, else
    ``("cpu", "cpu")``; read once per process."""
    import torch

    try:
        if torch.cuda.is_available():
            return "cuda", torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 - a broken CUDA install counts as no card
        pass
    return "cpu", "cpu"


def _load() -> TuningCache:
    d = cache_dir()
    sig = manifest_signature(d)
    with _LOAD_LOCK:
        memo = _LOADED.get(d)
        if memo is not None and memo[0] == sig:
            return memo[1]
    cache = TuningCache.load(d) if sig is not None else TuningCache()
    with _LOAD_LOCK:
        _LOADED[d] = (sig, cache)
    return cache


def _maybe_search() -> None:
    """Mode ``search`` with no entry for this device: run the smoke search
    once, then serve from the cache as mode ``cache`` does."""
    if getattr(_IN_SEARCH, "active", False):
        return
    platform, kind = _device_identity()
    if any(k.startswith(f"{platform}/") for k in _load().entries):
        return
    _IN_SEARCH.active = True
    # the search's own fits resolve apart from the fit that triggered it,
    # whose answers so far predate the published winners
    memo, token = _PINNED.get(), _PINNED.set(None)
    try:
        from spark_ensemble_tpu_torch.autotune.search import run_search

        logger.info(
            "%s=search and no tuned entries for %s/%s: running the smoke "
            "search once", MODE_ENV, platform, kind,
        )
        run_search(budget="smoke")
        reset()
    except Exception:  # noqa: BLE001 - tuning must never break a fit
        logger.warning("in-process autotune search failed", exc_info=True)
    finally:
        _PINNED.reset(token)
        if memo is not None:
            memo.clear()
        _IN_SEARCH.active = False


def search(budget: str = "smoke", **kwargs) -> Dict[str, Any]:
    """Run the measured search now (``autotune.search.run_search``) and
    publish its winners; returns its result."""
    from spark_ensemble_tpu_torch.autotune.search import run_search

    return run_search(budget, **kwargs)


def resolve(name: str, default, *, n: Optional[int] = None):
    """The tuned value for ``name`` at this site, or ``default``.

    ``default`` is the caller's LIVE module constant (read at call time,
    so a test's monkeypatch of the constant keeps working); ``n`` is the
    row count when the site knows one (it selects the shape class)."""
    for frame in reversed(_OVERRIDES):
        if name in frame["params"]:
            return frame["params"][name]
    memo = _PINNED.get()
    if memo is None:
        return _lookup(name, default, n)
    key = (name, default, n)
    if key not in memo:
        memo[key] = _lookup(name, default, n)
    return memo[key]


def _lookup(name: str, default, n: Optional[int]):
    """Steps 2-5 of the resolution order."""
    mode = autotune_mode()
    if mode == "off":
        return default
    if mode == "search":
        _maybe_search()
    cache = _load()
    if not cache.entries:
        return default
    platform, kind = _device_identity()
    return cache.lookup(platform, kind, shape_class(n)).get(name, default)


def fingerprint() -> tuple:
    """Tuning-state token: states that may resolve differently (cache
    generations, override frames, modes) never share one.  Cheap: one env
    read and one manifest ``stat``."""
    mode = autotune_mode()
    if mode == "off" and not _OVERRIDES:
        return ("autotune-off",)
    over = tuple(
        (k, v) for frame in _OVERRIDES for k, v in frame["params"].items()
    )
    return (mode, manifest_signature(), over)


def resolved_snapshot(n: Optional[int] = None) -> Dict[str, Any]:
    """Every tunable's resolved value at this site, the mode, and whether
    any cache entry applied."""
    mode = autotune_mode()
    platform, kind = _device_identity()
    if mode == "off":
        tuned: Dict[str, Any] = {}
    else:
        tuned = _load().lookup(platform, kind, shape_class(n))
    values = {
        t.name: resolve(t.name, t.default, n=n) for t in TUNABLES
    }
    return {
        "mode": mode,
        "cache_hit": bool(tuned),
        "cache_dir": cache_dir(),
        "values": values,
    }
