"""Model-quality observability plane: on-device drift sketches, staged
attribution and shadow scoring (PyTorch port of ``telemetry/quality.py``;
docs/quality.md).

- **Feature-drift sketches** — the training-time quantile bins double as
  reference feature distributions: every GBM fit captures ``drift_ref_``
  (thresholds + per-feature training bin occupancy, counted on the device
  by ``ops/binning.bin_occupancy_ids``'s integer scatter), ``pack()``
  ships it in the :class:`PackedModel`'s ``quality`` sidecar, the serving
  engine's bucketed predict graphs ALSO count a per-feature bin histogram
  of the served rows (captured into the same CUDA graph: one replay, no
  extra capture), and :class:`DriftMonitor` accumulates those exact
  integer histograms host-side into rolling windows scored as PSI/KL per
  feature.
- **Staged attribution** — :func:`staged_attribution` decomposes a
  request over the ensemble prefixes the engine pre-warmed
  (``PackedModel.take(k)`` tiers): per-stage margins against the full
  model and a per-member-disagreement uncertainty score.
- **Shadow scoring** — :class:`ShadowScorer` leases a candidate model
  from a ``ModelRegistry`` and scores a sampled fraction of live
  traffic: prediction divergence immediately, label-delayed accuracy
  deltas when ``record_label`` is called.

Everything lands in the existing planes: ``drift_window`` /
``shadow_eval`` / ``quality_alert`` events through the JSONL sinks,
``quality/*`` sources + gauges in ``global_metrics()``, and the
watchdog's ``quality_psi_max`` / ``shadow_divergence`` rules
(``telemetry/watchdog.py``).

The sketch math here is host-side numpy over already-materialized
integer counts, the same float32 arithmetic as the JAX package's, so
window scores agree between the packages on the same counts.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "psi",
    "kl_divergence",
    "histogram_distribution",
    "coarsen_counts",
    "prediction_divergence",
    "drift_reference_from_ctx",
    "DriftMonitor",
    "ShadowScorer",
    "staged_attribution",
]


# ---------------------------------------------------------------------------
# sketch math: pure host-side functions over integer bin counts
# ---------------------------------------------------------------------------


def histogram_distribution(
    counts: np.ndarray, smoothing: float = 1e-3
) -> np.ndarray:
    """Laplace-smoothed probability distribution(s) from bin counts.

    Accepts ``[B]`` or ``[d, B]`` integer counts; smoothing adds
    ``smoothing`` pseudo-count per bin so empty bins never produce
    infinities in the log-ratio scores below (the standard PSI
    stabilizer)."""
    c = np.asarray(counts, np.float32) + float(smoothing)
    return c / np.sum(c, axis=-1, keepdims=True)


def psi(
    reference: np.ndarray, observed: np.ndarray, smoothing: float = 1e-3
) -> np.ndarray:
    """Population Stability Index between bin-count histograms.

    ``sum((p - q) * ln(p / q))`` with ``q`` the reference distribution
    and ``p`` the observed one, both Laplace-smoothed.  Accepts ``[B]``
    counts (returns a scalar array) or ``[d, B]`` per-feature counts
    (returns ``[d]``).  Conventional reading: < 0.1 stable, 0.1-0.25
    moderate shift, > 0.25 major shift (the default alert threshold)."""
    q = histogram_distribution(reference, smoothing)
    p = histogram_distribution(observed, smoothing)
    return np.sum((p - q) * np.log(p / q), axis=-1)


def kl_divergence(
    reference: np.ndarray, observed: np.ndarray, smoothing: float = 1e-3
) -> np.ndarray:
    """``KL(observed || reference)`` between bin-count histograms, same
    shapes/smoothing conventions as :func:`psi`."""
    q = histogram_distribution(reference, smoothing)
    p = histogram_distribution(observed, smoothing)
    return np.sum(p * np.log(p / q), axis=-1)


def coarsen_counts(counts: np.ndarray, groups: int) -> np.ndarray:
    """Sum adjacent bins into ``groups`` near-equal groups along the last
    axis.  The training bins are QUANTILE bins (equiprobable by
    construction), so adjacent grouping preserves the equal-mass property
    — this is how the monitor gets standard-practice 10-20-cell PSI out
    of a 64-bin sketch.  Scoring at full resolution would drown in
    sampling noise: for B equiprobable cells the null expectation is
    ``E[PSI] ~ B/N_window + B/N_reference``, so 64 cells at a 512-row
    window sit at ~0.25 — the alert threshold — while 16 groups sit at a
    quarter of it (docs/quality.md#windows)."""
    c = np.asarray(counts)
    B = c.shape[-1]
    g = max(1, min(int(groups), B))
    edges = np.linspace(0, B, g + 1).astype(int)
    return np.stack(
        [c[..., edges[i]: edges[i + 1]].sum(axis=-1) for i in range(g)],
        axis=-1,
    )


def prediction_divergence(
    primary: np.ndarray, shadow: np.ndarray, classification: bool
) -> float:
    """Scalar divergence between two prediction vectors for the same
    rows: label disagreement rate for classifiers, mean-absolute
    difference normalized by the primary's mean magnitude for
    regressors."""
    a = np.asarray(primary, np.float32).ravel()
    b = np.asarray(shadow, np.float32).ravel()
    if classification:
        return float(np.mean(a != b))
    scale = float(np.mean(np.abs(a)))
    return float(np.mean(np.abs(a - b)) / (scale + 1e-12))


def drift_reference_from_ctx(ctx: Any) -> Optional[Dict[str, Any]]:
    """Training-time drift reference from a binned fit context.

    The tree-family ``make_fit_ctx`` already computed the quantile
    thresholds and the binned matrix ``Xb``.  The reference occupancy is
    counted where ``Xb`` lives, by ``ops/binning.bin_occupancy_ids``'s
    exact integer scatter, and only the ``[d, max_bins]`` counts and the
    thresholds come back to the host: no host copy of ``Xb``.  Returns
    ``None`` for contexts without a binned representation (non-tree base
    learners)."""
    from spark_ensemble_tpu_torch.ops.binning import bin_occupancy_ids

    if not isinstance(ctx, dict):
        return None
    if "Xb" not in ctx or "thresholds" not in ctx:
        return None
    Xb, thr_t = ctx["Xb"], ctx["thresholds"]
    if Xb.dim() != 2 or thr_t.dim() != 2 or Xb.shape[1] != thr_t.shape[0]:
        return None
    max_bins = thr_t.shape[1] + 1
    occ = bin_occupancy_ids(Xb, max_bins).cpu().numpy()
    thr = thr_t.detach().cpu().numpy().astype(np.float32)
    return {
        "thresholds": thr,
        "occupancy": occ,
        "rows": int(Xb.shape[0]),
    }


# ---------------------------------------------------------------------------
# DriftMonitor: rolling-window PSI/KL scoring of served-row histograms
# ---------------------------------------------------------------------------


class DriftMonitor:
    """Accumulate per-feature bin-count histograms of served rows into
    tumbling row-count windows and score each window against the
    training reference (PSI + KL per feature).

    The engine hands over EXACT integer histograms (one per graph
    replay, padding-corrected here), so window scores are invariant
    to request batching order and to which shape bucket served each
    request — summing integer histograms commutes.  Each completed
    window emits a ``drift_window`` event, updates the
    ``quality/<stream>`` registry source + ``quality/psi_max`` gauge,
    and raise/clear transitions of ``psi_max`` across ``psi_threshold``
    emit ``quality_alert`` events (docs/quality.md)."""

    def __init__(
        self,
        thresholds: np.ndarray,
        reference: np.ndarray,
        *,
        window_rows: int = 2048,
        smoothing: float = 1e-3,
        psi_threshold: float = 0.25,
        score_groups: int = 16,
        max_windows: int = 64,
        top_n: int = 5,
        stream: str = "quality",
        telemetry_path: Optional[str] = None,
        registry=None,
    ):
        from spark_ensemble_tpu_torch.telemetry.events import global_metrics

        self.thresholds = np.asarray(thresholds, np.float32)
        self.reference = np.asarray(reference, np.int64)
        if (
            self.reference.ndim != 2
            or self.reference.shape[0] != self.thresholds.shape[0]
            or self.reference.shape[1] != self.thresholds.shape[1] + 1
        ):
            raise ValueError(
                f"reference occupancy shape {self.reference.shape} does not "
                f"match thresholds {self.thresholds.shape} "
                "(want [d, max_bins])"
            )
        self.window_rows = int(window_rows)
        self.smoothing = float(smoothing)
        self.psi_threshold = float(psi_threshold)
        self.score_groups = int(score_groups)
        self.top_n = int(top_n)
        # accumulation stays at full sketch resolution; scoring coarsens
        # both sides identically (see coarsen_counts for the noise math)
        self._reference_scored = coarsen_counts(
            self.reference, self.score_groups
        )
        self._stream = stream
        self._telemetry_path = telemetry_path
        self._registry = (
            registry if registry is not None else global_metrics()
        )
        d, B = self.reference.shape
        # padded rows are all-zero: they land in the bin holding 0.0 per
        # feature; the engine reports pad counts so they subtract out here
        self._zero_bin = np.array(
            [
                int(np.searchsorted(self.thresholds[f], 0.0, side="left"))
                for f in range(d)
            ],
            np.int64,
        )
        self._lock = threading.Lock()
        self._current = np.zeros((d, B), np.int64)
        self._current_rows = 0
        self._rows_total = 0
        self._windows = 0
        self._history: "collections.deque" = collections.deque(
            maxlen=int(max_windows)
        )
        self._last_psi: Optional[np.ndarray] = None
        self._last_kl: Optional[np.ndarray] = None
        self._alert_active = False
        self._closed = False
        self._source_name = f"quality/{stream}"
        self._registry.register_source(self._source_name, self.snapshot)

    # -- accumulation ------------------------------------------------------

    def observe(self, counts: np.ndarray, pad_rows: int = 0) -> None:
        """Fold one replay's histogram (``int[d, B]``) into the current
        window; ``pad_rows`` zero-rows the engine padded into the bucket
        are subtracted from each feature's zero bin, so the window holds
        the served rows exactly regardless of bucket size."""
        if self._closed:
            return
        c = np.asarray(counts, np.int64)
        if c.shape != self.reference.shape:
            raise ValueError(
                f"histogram shape {c.shape} does not match reference "
                f"{self.reference.shape}"
            )
        if pad_rows:
            c = c.copy()
            c[np.arange(c.shape[0]), self._zero_bin] -= int(pad_rows)
            np.maximum(c, 0, out=c)
        rows = int(c[0].sum())
        completed: List[Tuple[int, int, np.ndarray]] = []
        with self._lock:
            self._current += c
            self._current_rows += rows
            self._rows_total += rows
            while self._current_rows >= self.window_rows:
                self._windows += 1
                completed.append(
                    (self._windows, self._current_rows, self._current)
                )
                self._current = np.zeros_like(self.reference)
                self._current_rows = 0
        for idx, wrows, window in completed:
            self._score_window(idx, wrows, window)

    def _score_window(
        self, index: int, rows: int, window: np.ndarray
    ) -> None:
        from spark_ensemble_tpu_torch.telemetry.events import emit_event

        scored = coarsen_counts(window, self.score_groups)
        psi_f = psi(self._reference_scored, scored, self.smoothing)
        kl_f = kl_divergence(self._reference_scored, scored, self.smoothing)
        psi_max = float(np.max(psi_f))
        kl_max = float(np.max(kl_f))
        order = np.argsort(psi_f)[::-1][: self.top_n]
        top = {f"f{int(f)}": float(psi_f[f]) for f in order}
        with self._lock:
            self._last_psi = psi_f
            self._last_kl = kl_f
            self._history.append(
                {"index": index, "rows": rows, "psi_max": psi_max,
                 "kl_max": kl_max}
            )
            was_active = self._alert_active
            self._alert_active = psi_max > self.psi_threshold
            transition = (
                "raised" if self._alert_active and not was_active
                else "cleared" if was_active and not self._alert_active
                else None
            )
        self._registry.gauge("quality/psi_max").set(psi_max)
        self._registry.gauge("quality/kl_max").set(kl_max)
        self._registry.histogram("quality/window_psi_max").record(psi_max)
        self._registry.counter("quality/windows").inc()
        emit_event(
            "drift_window",
            path=self._telemetry_path,
            fit_id=self._stream,
            window=index,
            rows=rows,
            psi_max=psi_max,
            kl_max=kl_max,
            psi_mean=float(np.mean(psi_f)),
            drifted_features=int(np.sum(psi_f > self.psi_threshold)),
            top=top,
            alert=self._alert_active,
        )
        if transition is not None:
            self._registry.counter("quality/alerts_total").inc()
            emit_event(
                "quality_alert",
                path=self._telemetry_path,
                fit_id=self._stream,
                state=transition,
                metric="psi_max",
                value=psi_max,
                threshold=self.psi_threshold,
                window=index,
            )

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``quality/<stream>`` source payload: last-window scores,
        totals, alert state, top drifting features, read live through
        ``global_metrics().snapshot()``."""
        with self._lock:
            psi_f = self._last_psi
            out: Dict[str, Any] = {
                "kind": "drift",
                "rows_total": self._rows_total,
                "windows": self._windows,
                "window_rows": self.window_rows,
                "current_rows": self._current_rows,
                "psi_threshold": self.psi_threshold,
                "alert_active": self._alert_active,
            }
            if psi_f is not None:
                order = np.argsort(psi_f)[::-1][: self.top_n]
                out.update(
                    psi_max=float(np.max(psi_f)),
                    psi_mean=float(np.mean(psi_f)),
                    kl_max=float(np.max(self._last_kl)),
                    drifted_features=int(
                        np.sum(psi_f > self.psi_threshold)
                    ),
                    top={f"f{int(f)}": float(psi_f[f]) for f in order},
                )
            return out

    def feature_psi(self) -> Optional[np.ndarray]:
        """Per-feature PSI of the last completed window (``[d]``), or
        ``None`` before the first window closes."""
        with self._lock:
            return None if self._last_psi is None else self._last_psi.copy()

    def close(self) -> None:
        """Unregister the live source (owner shutdown)."""
        self._closed = True
        self._registry.unregister_source(self._source_name)


# ---------------------------------------------------------------------------
# staged attribution over pre-warmed ensemble-prefix tiers
# ---------------------------------------------------------------------------


def staged_attribution(
    engine,
    X,
    method: str = "predict",
    uncertainty_threshold: float = 0.5,
    full=None,
) -> Dict[str, Any]:
    """Per-request margin decomposition over the engine's pre-warmed
    ensemble prefixes (``PackedModel.take(k)`` tier graphs).

    For each configured tier ``k`` the request is re-served through the
    first-``k``-member prefix — every graph involved was captured at
    warmup, so this captures nothing (it does add one replay per tier,
    which is why a server runs it on a sampled fraction of requests).  ``margins[k]`` is the prefix's disagreement with the
    full model (label-disagreement rate for classifier ``predict``,
    normalized mean-absolute difference otherwise); ``uncertainty`` is
    the maximum disagreement across tiers — members past the smallest
    prefix still flipping the answer is exactly per-member disagreement,
    the cheap ensemble uncertainty score.  ``full`` short-circuits the
    full-model serve when the caller already holds the delivered answer
    (tiers are then the only extra replays)."""
    tiers = tuple(engine.prefix_tiers)
    if full is None:
        full = engine.predict(X, method=method)
    full_f = np.asarray(full, np.float32)
    classification = bool(
        engine.packed.is_classifier and method == "predict"
    )
    margins: Dict[str, float] = {}
    disagreements: List[float] = []
    for k in tiers:
        pk = engine.predict(X, method=method, tier=k)
        dis = prediction_divergence(full_f, pk, classification)
        margins[str(int(k))] = dis
        disagreements.append(dis)
    uncertainty = float(max(disagreements)) if disagreements else 0.0
    return {
        "tiers": [int(k) for k in tiers],
        "margins": margins,
        "uncertainty": uncertainty,
        "flagged": uncertainty > float(uncertainty_threshold),
    }


def _host_f32(x) -> np.ndarray:
    """A host float32 array of ``x`` (numpy, a list, or a tensor on any
    device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# ShadowScorer: registry-driven candidate evaluation on sampled traffic
# ---------------------------------------------------------------------------


class ShadowScorer:
    """Score a candidate model against live primary traffic.

    Every ``1/fraction``-th ``observe()`` call (deterministic counter —
    no RNG, so CI runs are reproducible) leases the candidate engine
    from the :class:`ModelRegistry` (pin-until-reply, so a hot-swap can
    never free it mid-score), predicts the same rows, and records the
    prediction divergence against the primary's served output.  When
    ground truth arrives later, :meth:`record_label` joins it back by
    request id and accumulates the label-delayed accuracy delta
    (candidate minus primary; positive = candidate better).

    Primary answers and labels may be numpy arrays or tensors on any
    device (copied to the host).  Emits one ``shadow_eval`` event per
    sampled request, keeps a rolling
    divergence over the last ``window`` evals in the
    ``quality/<stream>`` source + ``quality/shadow_divergence`` gauge
    (the watchdog's ``shadow_divergence`` rule), and raise/clear
    transitions across ``divergence_threshold`` emit ``quality_alert``
    events."""

    def __init__(
        self,
        registry,
        candidate: str,
        *,
        fraction: float = 0.25,
        method: str = "predict",
        classification: Optional[bool] = None,
        divergence_threshold: float = 0.25,
        window: int = 64,
        label_buffer: int = 1024,
        stream: str = "shadow",
        telemetry_path: Optional[str] = None,
        metrics=None,
    ):
        from spark_ensemble_tpu_torch.telemetry.events import global_metrics

        if not (0.0 < float(fraction) <= 1.0):
            raise ValueError(f"fraction must be in (0, 1]; got {fraction}")
        self._registry = registry
        self._candidate = candidate
        self._period = max(1, int(round(1.0 / float(fraction))))
        self._method = method
        self._classification = classification
        self._threshold = float(divergence_threshold)
        self._stream = stream
        self._telemetry_path = telemetry_path
        self._metrics = (
            metrics if metrics is not None else global_metrics()
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._evals = 0
        self._sampled_rows = 0
        self._errors = 0
        self._window: "collections.deque" = collections.deque(
            maxlen=int(window)
        )
        self._pending: "collections.OrderedDict" = collections.OrderedDict()
        self._label_buffer = int(label_buffer)
        self._labeled_rows = 0
        self._primary_score = 0.0
        self._shadow_score = 0.0
        self._alert_active = False
        self._closed = False
        self._source_name = f"quality/{stream}"
        self._metrics.register_source(self._source_name, self.snapshot)

    # -- live scoring ------------------------------------------------------

    def observe(
        self, X, primary, request_id: Optional[Any] = None
    ) -> Optional[Dict[str, Any]]:
        """Maybe shadow-score one served request: returns the eval record
        for sampled requests, ``None`` for the rest.  The primary's
        answer was already delivered to the caller — shadow scoring rides
        AFTER the reply, off the request's critical path."""
        with self._lock:
            if self._closed:
                return None
            self._seq += 1
            if (self._seq - 1) % self._period != 0:
                return None
        try:
            with self._registry.lease(self._candidate) as eng:
                classification = self._classification
                if classification is None:
                    classification = bool(
                        eng.packed.is_classifier
                        and self._method == "predict"
                    )
                shadow = eng.predict(X, method=self._method)
        except Exception:  # noqa: BLE001 - a sick candidate never breaks serving
            with self._lock:
                self._errors += 1
            return None
        primary_f = _host_f32(primary)
        shadow_f = _host_f32(shadow)
        div = prediction_divergence(primary_f, shadow_f, classification)
        rows = int(np.shape(primary_f)[0]) if primary_f.ndim else 1
        with self._lock:
            self._evals += 1
            self._sampled_rows += rows
            self._window.append(div)
            rolling = float(np.mean(self._window))
            evals = self._evals
            if request_id is not None:
                self._pending[request_id] = (
                    primary_f, shadow_f, classification,
                )
                while len(self._pending) > self._label_buffer:
                    self._pending.popitem(last=False)
            was_active = self._alert_active
            self._alert_active = rolling > self._threshold
            transition = (
                "raised" if self._alert_active and not was_active
                else "cleared" if was_active and not self._alert_active
                else None
            )
        self._metrics.gauge("quality/shadow_divergence").set(rolling)
        self._metrics.counter("quality/shadow_evals").inc()
        from spark_ensemble_tpu_torch.telemetry.events import emit_event

        record = {
            "candidate": self._candidate,
            "rows": rows,
            "divergence": div,
            "rolling_divergence": rolling,
            "evals": evals,
        }
        emit_event(
            "shadow_eval",
            path=self._telemetry_path,
            fit_id=self._stream,
            **record,
        )
        if transition is not None:
            self._metrics.counter("quality/alerts_total").inc()
            emit_event(
                "quality_alert",
                path=self._telemetry_path,
                fit_id=self._stream,
                state=transition,
                metric="shadow_divergence",
                value=rolling,
                threshold=self._threshold,
            )
        return record

    # -- label-delayed accuracy --------------------------------------------

    def record_label(self, request_id: Any, y_true) -> bool:
        """Join delayed ground truth back to a shadow-scored request;
        returns ``False`` when the id was never sampled (or already aged
        out of the buffer).  Scores: accuracy for classifiers, negative
        mean-absolute error for regressors — either way the delta is
        candidate minus primary, positive meaning the candidate wins."""
        with self._lock:
            entry = self._pending.pop(request_id, None)
        if entry is None:
            return False
        primary_f, shadow_f, classification = entry
        y = _host_f32(y_true).ravel()
        a = primary_f.ravel()[: y.size]
        b = shadow_f.ravel()[: y.size]
        if classification:
            p_score = float(np.mean(a == y))
            s_score = float(np.mean(b == y))
        else:
            p_score = -float(np.mean(np.abs(a - y)))
            s_score = -float(np.mean(np.abs(b - y)))
        with self._lock:
            self._labeled_rows += int(y.size)
            self._primary_score += p_score
            self._shadow_score += s_score
            n = max(
                1, self._labeled_rows // max(1, y.size)
            )  # per-request averaging
            delta = (self._shadow_score - self._primary_score) / n
        self._metrics.gauge("quality/shadow_accuracy_delta").set(delta)
        return True

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            rolling = (
                float(np.mean(self._window)) if self._window else None
            )
            n_req = max(
                1, self._evals
            )
            out: Dict[str, Any] = {
                "kind": "shadow",
                "candidate": self._candidate,
                "period": self._period,
                "requests_seen": self._seq,
                "evals": self._evals,
                "sampled_rows": self._sampled_rows,
                "errors": self._errors,
                "threshold": self._threshold,
                "alert_active": self._alert_active,
                "labeled_rows": self._labeled_rows,
            }
            if rolling is not None:
                out["divergence"] = rolling
            if self._labeled_rows:
                out["accuracy_delta"] = (
                    self._shadow_score - self._primary_score
                ) / n_req
            return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._metrics.unregister_source(self._source_name)
