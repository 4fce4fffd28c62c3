"""Deterministic measured search over the tunable space (PyTorch port of
``autotune/search.py``).

The search times real fits and launches on this process's device: a
letter-shaped GBM fit, its full-batch predict, the stream histogram tier,
a mixed-size predict request stream, and the CUDA level-histogram kernels
under candidate plans, each fenced through the telemetry ``RoundTimer`` so
that asynchronous launches cannot fake a win.  Winners land in the on-disk
:class:`~spark_ensemble_tpu_torch.autotune.cache.TuningCache` keyed by
``(platform, device_kind, shape_class)`` and are read at fit time
(``autotune/resolve.py``).

Determinism: fixed-seed synthetic data, a fixed candidate order (the
default first), and a winner rule of "least median time, but only if it
beats the default by more than the noise floor", as in the JAX package, so
that a search repeated on one machine converges instead of flapping.
Tests inject a ``measure`` callable for deterministic winners.

The ``pallas`` group keeps its name (``groups=`` and the CLI are the JAX
package's) and times the CUDA kernels: ``hist_level_pallas``
(``level_hist<2>``) under ``pallas_block_rows`` and ``fused_round_level``
(a route, then ``level_hist<3>`` over packed bins) under
``fused_block_rows``.  Its tensors live on the card, so a kernel that fails
to launch raises; it never times a plain version.  Off the card it runs
only under an injected ``measure``, as the JAX package runs its group off
the TPU; with real measurement it logs and skips.

Entry points: :func:`run_search` (``tools/autotune_torch.py``) and
:func:`autotune_fit` (tune for an estimator's data, searching only when
the cache holds nothing for this device and shape class).
"""

from __future__ import annotations

import logging
import statistics
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from spark_ensemble_tpu_torch.autotune.cache import TuningCache, entry_key
from spark_ensemble_tpu_torch.autotune.resolve import (
    _device_identity,
    override,
    reset,
)
from spark_ensemble_tpu_torch.autotune.space import TUNABLES, shape_class

logger = logging.getLogger("spark_ensemble_tpu_torch")

# only winners beating the default config by more than this fraction are
# recorded: below it the spread is timing noise, and recording it would
# make back-to-back searches flap between near-ties
NOISE_FLOOR = 0.02

# (n, d, k, rounds, repeats, max_depth, max_bins) per budget; "full" is
# letter-shaped (the main path's shape class)
BUDGETS: Dict[str, Dict[str, int]] = {
    "smoke": dict(n=2048, d=8, k=4, rounds=6, repeats=1, depth=4, bins=32),
    "fast": dict(n=8192, d=16, k=8, rounds=16, repeats=2, depth=5, bins=64),
    "full": dict(n=15000, d=16, k=26, rounds=24, repeats=3, depth=5, bins=64),
}

_GROUPS = ("fit", "predict", "stream", "bucket", "pallas")


def clear_program_caches() -> None:
    """Drop what the port latches between calls: the kernels' plan caches
    (``ops/hist_kernels.py``).  Their keys hold the resolved knob values,
    so a new candidate never reads a stale plan; clearing keeps a
    candidate's first call from finding plans made for another."""
    from spark_ensemble_tpu_torch.ops import hist_kernels as hk

    for fn in (hk._level_plan, hk._lane_level_plan, hk.route_plan, hk.leaf_plan,
               hk._checked_level_plan, hk._checked_route_plan,
               hk._checked_leaf_plan):
        fn.cache_clear()


def _measure_real(tag: Dict[str, Any], thunk: Callable[[], Any],
                  repeats: int) -> float:
    """Median fenced wall time of ``thunk`` over ``repeats`` runs, after
    one untimed warm run (the kernels' build and first launch excluded)."""
    from spark_ensemble_tpu_torch.telemetry.events import global_metrics
    from spark_ensemble_tpu_torch.telemetry.registry import RoundTimer
    from spark_ensemble_tpu_torch.utils.instrumentation import block_on_arrays

    timer = RoundTimer(
        "autotune/measure", global_metrics().histogram("autotune/measure_s")
    )
    block_on_arrays(thunk())  # warm run, fenced so it does not spill over
    times = []
    for _ in range(max(repeats, 1)):
        timer.start()
        out = thunk()
        times.append(timer.stop(out))
    return statistics.median(times)


def _synth_classification(n: int, d: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable k-class data (fixed seed: the search must
    measure the same work every run)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, k)).astype(np.float32)
    logits = X @ W + 0.5 * rng.standard_normal((n, k)).astype(np.float32)
    y = np.argmax(logits, axis=1).astype(np.int32)
    return X, y


def _candidate_rows(values, default) -> List[Any]:
    """Default first (its time is the comparison floor), then the rest in
    declared order."""
    rest = [v for v in values if v != default]
    return [default] + rest


def _sweep(
    name: str,
    candidates: List[Any],
    make_thunk: Callable[[], Callable[[], Any]],
    measure: Callable,
    repeats: int,
    timings: Dict[str, Dict[str, float]],
    extra_override: Optional[Dict[str, Any]] = None,
    real: bool = True,
) -> Tuple[Any, float, float]:
    """Time every candidate of one tunable -> (winner, its time, the
    default's time).  ``make_thunk`` builds a fresh workload per
    candidate, under the candidate's override."""
    default = candidates[0]
    results: Dict[Any, float] = {}
    for cand in candidates:
        ov = dict(extra_override or {})
        ov[name] = cand
        with override(mode="cache", **ov):
            if real:
                clear_program_caches()
            thunk = make_thunk()
            t = measure({"tunable": name, "candidate": cand}, thunk, repeats)
        results[cand] = t
        logger.info("autotune %s=%r: %.4fs", name, cand, t)
    timings[name] = {str(c): results[c] for c in candidates}
    best = min(results, key=lambda c: (results[c], str(c) != str(default)))
    if results[best] >= results[default] * (1.0 - NOISE_FLOOR):
        best = default  # not convincingly better than the shipped default
    return best, results[best], results[default]


def run_search(
    budget: str = "smoke",
    *,
    groups: Optional[Tuple[str, ...]] = None,
    measure: Optional[Callable] = None,
    save: bool = True,
    directory: Optional[str] = None,
) -> Dict[str, Any]:
    """Run the measured search -> ``{"winners", "timings", "platform",
    "device_kind", "shape_class", "budget", "shape"}``, and (when
    ``save``) publish the winners to the cache under both the tuned shape
    class and ``"*"``.

    ``measure(tag, thunk, repeats) -> seconds`` is injectable for
    deterministic tests; the default times real fenced runs on the card
    (or the CPU when the process sees no card)."""
    if budget not in BUDGETS:
        raise ValueError(f"budget must be one of {sorted(BUDGETS)}; got {budget!r}")
    cfg = BUDGETS[budget]
    groups = tuple(groups or _GROUPS)
    bad = [g for g in groups if g not in _GROUPS]
    if bad:
        raise ValueError(f"unknown search groups: {bad}")
    real = measure is None
    measure = measure or _measure_real
    repeats = cfg["repeats"]

    import torch

    from spark_ensemble_tpu_torch.models.gbm import GBMClassifier
    from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor

    platform, device_kind = _device_identity()
    dev = "cuda" if platform == "cuda" else "cpu"
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    X, y = _synth_classification(n, d, k)
    sc = shape_class(n)

    winners: Dict[str, Any] = {}
    timings: Dict[str, Dict[str, float]] = {}

    def fresh_estimator(**extra):
        return GBMClassifier(
            num_base_learners=cfg["rounds"],
            loss="logloss",
            updates="newton",
            learning_rate=0.3,
            base_learner=DecisionTreeRegressor(
                max_depth=cfg["depth"], max_bins=cfg["bins"]
            ),
            **extra,
        )

    # -- fit group: hist tier, then scan_chunk at the winning tier ----------
    model = None
    if "fit" in groups:
        def fit_thunk():
            est = fresh_estimator()

            def run():
                return est.fit(X, y, device=dev).params

            return run

        tiers = ["auto", "scatter", "matmul"]
        if n > 200_000:
            tiers.append("stream")  # stream only wins at HBM scale
        tier, _, _ = _sweep(
            "hist_tier", tiers, fit_thunk, measure, repeats, timings,
            real=real,
        )
        if tier != "auto":
            winners["hist_tier"] = tier
        tier_ov = {"hist_tier": tier} if tier != "auto" else {}

        chunks = _candidate_rows(
            [c for c in TUNABLES["scan_chunk"].candidates
             if c <= cfg["rounds"] * 2],
            TUNABLES["scan_chunk"].default,
        )
        chunk, _, _ = _sweep(
            "scan_chunk", chunks, fit_thunk, measure, repeats, timings,
            extra_override=tier_ov, real=real,
        )
        if chunk != TUNABLES["scan_chunk"].default:
            winners["scan_chunk"] = chunk
        if real:
            with override(mode="cache", **{**tier_ov, "scan_chunk": chunk}):
                clear_program_caches()
                model = fresh_estimator().fit(X, y, device=dev)

    # -- predict group: the predict chunk's cell budget ---------------------
    if "predict" in groups:
        if model is None and real:
            model = fresh_estimator().fit(X, y, device=dev)
        Xd = torch.as_tensor(X, device=dev)

        def predict_thunk():
            if not real:
                return lambda: None
            m = model

            def run():
                return m.predict(Xd)

            return run

        cells = _candidate_rows(
            list(TUNABLES["predict_fused_max_cells"].candidates),
            TUNABLES["predict_fused_max_cells"].default,
        )
        cell, _, _ = _sweep(
            "predict_fused_max_cells", cells, predict_thunk, measure,
            max(repeats * 3, 3), timings, real=real,
        )
        if cell != TUNABLES["predict_fused_max_cells"].default:
            winners["predict_fused_max_cells"] = cell

    # -- stream group: rows per chunk of the stream tier --------------------
    if "stream" in groups:
        def stream_thunk():
            if not real:
                return lambda: None
            est = DecisionTreeRegressor(
                max_depth=cfg["depth"], max_bins=cfg["bins"], hist="stream"
            )
            yr = (np.asarray(y, np.float32) - float(np.mean(y)))

            def run():
                return est.fit(X, yr, device=dev).params

            return run

        rows = _candidate_rows(
            [c for c in TUNABLES["stream_chunk_rows"].candidates if c <= 4 * n],
            TUNABLES["stream_chunk_rows"].default,
        )
        row, _, _ = _sweep(
            "stream_chunk_rows", rows, stream_thunk, measure, repeats,
            timings, real=real,
        )
        if row != TUNABLES["stream_chunk_rows"].default:
            winners["stream_chunk_rows"] = row

    # -- bucket group: mixed request sizes (the JAX package's bucket ladder;
    # its two tunables have no site in the port, whose predict is unpadded)
    if "bucket" in groups:
        if model is None and real:
            model = fresh_estimator().fit(X, y, device=dev)
        rng = np.random.default_rng(1)
        sizes = [int(s) for s in rng.integers(1, max(n // 4, 2), size=24)]
        reqs = [torch.as_tensor(X[:s], device=dev) for s in sizes]

        def bucket_thunk():
            if not real:
                return lambda: None
            m = model

            def run():
                out = None
                for r in reqs:
                    out = m.predict(r)
                return out

            return run

        for name in ("predict_bucket_pow2_exact",
                     "predict_bucket_octave_steps"):
            cands = _candidate_rows(
                list(TUNABLES[name].candidates), TUNABLES[name].default
            )
            won, _, _ = _sweep(
                name, cands, bucket_thunk, measure, repeats, timings,
                real=real,
            )
            if won != TUNABLES[name].default:
                winners[name] = won

    # -- pallas group: the CUDA level histograms under candidate plans (on
    # the card only: a CPU tensor runs the plain version, whose time the
    # plan does not touch) -------------------------------------------------
    if "pallas" in groups:
        if platform == "cuda" or not real:
            def pallas_thunk():
                if not real:
                    return lambda: None
                from spark_ensemble_tpu_torch.ops.hist_kernels import (
                    hist_level_pallas,
                    level_knobs,
                )

                knobs = level_knobs(2, n)  # the candidate's, resolved once

                rng = np.random.default_rng(2)
                Xb = torch.as_tensor(
                    rng.integers(0, cfg["bins"], size=(n, d), dtype=np.int32),
                    device=dev,
                )
                node = torch.as_tensor(
                    rng.integers(0, 8, size=(n, 4), dtype=np.int32), device=dev
                )
                vals = torch.as_tensor(
                    rng.standard_normal((n, 4, 3)).astype(np.float32), device=dev
                )

                def run():
                    return hist_level_pallas(
                        Xb, node, vals, n_nodes=8, max_bins=cfg["bins"],
                        knobs=knobs,
                    )

                return run

            cands = _candidate_rows(
                list(TUNABLES["pallas_block_rows"].candidates),
                TUNABLES["pallas_block_rows"].default,
            )
            br, _, _ = _sweep(
                "pallas_block_rows", cands, pallas_thunk, measure,
                repeats, timings, real=real,
            )
            if br != TUNABLES["pallas_block_rows"].default:
                winners["pallas_block_rows"] = br

            # one routed level over packed bins: a route launch, then the
            # histogram launch, as the fused tier runs every level
            def fused_thunk():
                if not real:
                    return lambda: None
                from spark_ensemble_tpu_torch.ops.binning import pack_bins, pack_width
                from spark_ensemble_tpu_torch.ops.hist_kernels import (
                    fused_round_level,
                    level_knobs,
                )

                knobs = level_knobs(3, n)
                bins = min(cfg["bins"], 256)  # fused packs B <= 256 only
                bits = pack_width(bins)
                rng = np.random.default_rng(3)
                cb = pack_bins(
                    torch.as_tensor(
                        rng.integers(0, bins, size=(n, d), dtype=np.int32),
                        device=dev,
                    ),
                    bins, bits,
                )
                node = torch.as_tensor(
                    rng.integers(0, 4, size=(n, 4), dtype=np.int32), device=dev
                )
                vals = torch.as_tensor(
                    rng.standard_normal((n, 4, 3)).astype(np.float32), device=dev
                )
                bf = torch.as_tensor(
                    rng.integers(0, d, size=(4, 4), dtype=np.int32), device=dev
                )
                bt = torch.as_tensor(
                    rng.integers(0, bins, size=(4, 4), dtype=np.int32), device=dev
                )

                def run():
                    return fused_round_level(
                        cb.packed, node, vals, bf, bt, n_nodes=8,
                        max_bins=bins, bits=bits, num_features=d, knobs=knobs,
                    )

                return run

            cands = _candidate_rows(
                list(TUNABLES["fused_block_rows"].candidates),
                TUNABLES["fused_block_rows"].default,
            )
            fbr, _, _ = _sweep(
                "fused_block_rows", cands, fused_thunk, measure,
                repeats, timings, real=real,
            )
            if fbr != TUNABLES["fused_block_rows"].default:
                winners["fused_block_rows"] = fbr
        else:
            logger.info("pallas group skipped: platform=%s (card only)", platform)

    result = {
        "winners": winners,
        "timings": timings,
        "platform": platform,
        "device_kind": device_kind,
        "shape_class": sc,
        "budget": budget,
        "shape": {"n": n, "d": d, "k": k, "rounds": cfg["rounds"]},
    }
    if save:
        cache = TuningCache.load(directory)
        meta = {
            "budget": budget,
            "shape": result["shape"],
            "cache_format": "autotune.search",
        }
        cache.put(platform, device_kind, sc, winners, meta)
        cache.put(platform, device_kind, "*", winners, meta)
        result["cache_path"] = cache.save(directory)
        reset()  # the published generation supersedes the memoized view
    if real:
        clear_program_caches()
    return result


def autotune_fit(
    estimator,
    X,
    y=None,
    *,
    budget: str = "smoke",
    measure: Optional[Callable] = None,
    save: bool = True,
    directory: Optional[str] = None,
    force: bool = False,
) -> Dict[str, Any]:
    """Make sure tuned winners exist for THIS device and this dataset's
    shape class, searching only on a miss.

    A cache hit returns at once (zero measurements) with ``{"cached":
    True, "params": {...}}``; ``force=True`` measures again.  Otherwise it
    returns the ``run_search`` result.  An entry for the shape class whose
    search kept every default is a hit too (the JAX package searches again
    there).  The estimator's hand-set params are never overridden: the
    sites consult the cache only for params left at their defaults."""
    platform, device_kind = _device_identity()
    n = int(X.shape[0]) if hasattr(X, "shape") else len(X)
    sc = shape_class(n)
    cache = TuningCache.load(directory)
    if not force:
        params = cache.lookup(platform, device_kind, sc)
        if params or entry_key(platform, device_kind, sc) in cache.entries:
            return {
                "cached": True,
                "params": params,
                "platform": platform,
                "device_kind": device_kind,
                "shape_class": sc,
            }
    # size the search off the data when it is smaller than the budget's
    # nominal shape (tuning must stay cheap next to the fit)
    cfg = dict(BUDGETS[budget])
    cfg["n"] = min(cfg["n"], max(n, 256))
    saved = BUDGETS[budget]
    BUDGETS[budget] = cfg
    try:
        return run_search(
            budget, measure=measure, save=save, directory=directory
        )
    finally:
        BUDGETS[budget] = saved
