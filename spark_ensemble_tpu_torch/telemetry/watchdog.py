"""Online perf watchdog (PyTorch port of ``telemetry/watchdog.py``, with
the same rules, thresholds, events and verdict): the
``tools/perf_sentinel.py`` thresholds applied to **live** metrics instead
of post-hoc bench records (docs/operator.md).

A :class:`Watchdog` evaluates a small rule table on a rolling cadence
against ``global_metrics().snapshot()`` — serving p99 and hedge rate
from the live ``fleet/*`` sources, steady-state compile count, the
host-blocked share and cost-model error gauges the fit ledger
publishes — and drives a two-state alert machine per rule: a rule must
breach for ``breach_for`` consecutive ticks to raise an ``slo_alert``
telemetry event, and then hold healthy for ``clear_for`` consecutive
ticks before the matching ``cleared`` event fires (hysteresis, so one
hedged request or one straggling round does not flap the verdict).

The verdict is what ``/healthz`` serves (503 while any alert is
active) and what :class:`~spark_ensemble_tpu_torch.serving.autopilot.
Autopilot` acts on.  Probes only read already-collected registry state:
no device values are fetched, no kernels launched, no host syncs.

Thresholds come from the repo's own sentinel when available: rule
defaults are derived from ``tools/perf_sentinel.py`` ``METRICS``
(direction + noise floors) joined with ``PERF_BASELINE.json``, exactly
the way the offline gate computes its allowance; metrics the baseline
does not pin fall back to the documented defaults below.  The sentinel is
read by path (it is stdlib-only); this module keeps its own copy of the
fallbacks.  ``host_blocked_share`` and ``cost_model_error_pct`` read the
``fit/*`` gauges every finished fit sets (``telemetry/events.py``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Rule", "Watchdog", "default_rules", "sentinel_thresholds",
           "probe_fleet_max", "probe_gauge", "probe_quality_max"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: metric -> (direction, threshold) used when neither the sentinel
#: module nor the committed baseline pins the metric.  Values are
#: deliberately loose — the watchdog is a tripwire for "clearly wrong",
#: the offline sentinel stays the precision gate (docs/operator.md).
FALLBACK_THRESHOLDS: Dict[str, tuple] = {
    "serving_p99_ms":        ("lower", 250.0),
    "hedge_rate":            ("lower", 0.5),
    "compiles_since_warmup": ("lower", 0.0),
    "host_blocked_share":    ("lower", 0.75),
    "cost_model_error_pct":  ("lower", 200.0),
    # model-quality plane (telemetry/quality.py, docs/quality.md): the
    # conventional PSI major-shift mark, and the shadow scorer's rolling
    # prediction-divergence ceiling (same number by design — both read
    # "a quarter of the signal moved")
    "quality_psi_max":       ("lower", 0.25),
    "shadow_divergence":     ("lower", 0.25),
}


def sentinel_thresholds(
    repo_root: str = _REPO,
) -> Dict[str, tuple]:
    """(direction, threshold) per watchdog metric, derived from the
    offline sentinel's ``METRICS`` floors + ``PERF_BASELINE.json`` the
    same way ``tools/perf_sentinel.py compare`` computes its allowance:
    for a "lower" metric with baseline ``b`` the live threshold is
    ``max(b * (1 + rel_floor), b + abs_floor)``.  Metrics absent from
    the baseline (or when the tools/ checkout is not present — installed
    wheels) keep :data:`FALLBACK_THRESHOLDS`."""
    out = dict(FALLBACK_THRESHOLDS)
    sentinel_path = os.path.join(repo_root, "tools", "perf_sentinel.py")
    baseline_path = os.path.join(repo_root, "PERF_BASELINE.json")
    if not os.path.exists(sentinel_path):
        return out
    try:
        spec = importlib.util.spec_from_file_location(
            "_se_torch_perf_sentinel", sentinel_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        metrics = dict(getattr(mod, "METRICS", {}))
    except Exception:  # noqa: BLE001 - sentinel drift never kills serving
        return out
    baseline: Dict[str, Any] = {}
    if os.path.exists(baseline_path):
        try:
            with open(baseline_path) as fh:
                baseline = json.load(fh)
        except (OSError, ValueError):
            baseline = {}
    for name, (direction, rel, floor) in metrics.items():
        if name not in out:
            continue  # offline-only metric (fit_seconds, throughput, ...)
        base = baseline.get(name)
        if not isinstance(base, (int, float)):
            continue  # baseline does not pin it: keep the fallback
        base = float(base)
        if direction == "lower":
            out[name] = ("lower", max(base * (1.0 + rel), base + floor))
        else:
            out[name] = ("higher", min(base * (1.0 - rel), base - floor))
    return out


# ---------------------------------------------------------------------------
# probes: read a registry snapshot, return the live value (or None)
# ---------------------------------------------------------------------------


def _source_values(
    snapshot: Dict[str, Any], prefix: str, key: str
) -> List[float]:
    vals: List[float] = []
    for name, snap in snapshot.items():
        if not name.startswith(prefix) or snap.get("type") != "source":
            continue
        value = snap.get("value")
        if isinstance(value, dict) and isinstance(
            value.get(key), (int, float)
        ):
            vals.append(float(value[key]))
    return vals


def _fleet_values(snapshot: Dict[str, Any], key: str) -> List[float]:
    return _source_values(snapshot, "fleet/", key)


def probe_fleet_max(key: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    def probe(snapshot: Dict[str, Any]) -> Optional[float]:
        vals = _fleet_values(snapshot, key)
        return max(vals) if vals else None
    return probe


def probe_quality_max(
    key: str,
) -> Callable[[Dict[str, Any]], Optional[float]]:
    """Max of ``key`` across the live ``quality/*`` sources (drift
    monitors publish ``psi_max``, shadow scorers ``divergence``) — one
    drifting stream degrades the process.  ``None`` (frozen rule) while
    no quality source is live or none has completed a window yet."""
    def probe(snapshot: Dict[str, Any]) -> Optional[float]:
        vals = _source_values(snapshot, "quality/", key)
        return max(vals) if vals else None
    return probe


def probe_gauge(name: str, absolute: bool = False):
    def probe(snapshot: Dict[str, Any]) -> Optional[float]:
        snap = snapshot.get(name)
        if not snap or snap.get("type") != "gauge":
            return None
        value = snap.get("value")
        if not isinstance(value, (int, float)):
            return None
        return abs(float(value)) if absolute else float(value)
    return probe


@dataclass
class Rule:
    """One watched SLO: a probe over the registry snapshot, a threshold
    with a direction, and the raise/clear hysteresis widths (ticks)."""

    name: str
    probe: Callable[[Dict[str, Any]], Optional[float]]
    threshold: float
    direction: str = "lower"       # "lower": value must stay <= threshold
    breach_for: int = 2            # consecutive breaching ticks to raise
    clear_for: int = 3             # consecutive healthy ticks to clear
    # mutable alert state (owned by the watchdog tick loop)
    active: bool = field(default=False, repr=False)
    breach_ticks: int = field(default=0, repr=False)
    ok_ticks: int = field(default=0, repr=False)
    last_value: Optional[float] = field(default=None, repr=False)

    def breaching(self, value: float) -> bool:
        if self.direction == "lower":
            return value > self.threshold
        return value < self.threshold


def default_rules(
    thresholds: Optional[Dict[str, tuple]] = None,
    breach_for: int = 2,
    clear_for: int = 3,
) -> List[Rule]:
    """The standard rule table (docs/operator.md): serving p99 + hedge
    rate + steady-state compiles from the live ``fleet/*`` sources
    (max across routers — one sick stream degrades the process), the
    fit ledger's host-blocked share, the absolute cost-model error, and
    the model-quality plane's per-feature PSI + shadow divergence."""
    th = thresholds or sentinel_thresholds()
    probes: Dict[str, Callable] = {
        "serving_p99_ms": probe_fleet_max("p99_ms"),
        "hedge_rate": probe_fleet_max("hedge_rate"),
        "compiles_since_warmup": probe_fleet_max("compiles_since_warmup"),
        "host_blocked_share": probe_gauge("fit/host_blocked_share"),
        "cost_model_error_pct": probe_gauge(
            "fit/cost_model_error_pct", absolute=True),
        # sustained feature drift or candidate divergence is a health
        # incident: same hysteresis as the systems rules (docs/quality.md)
        "quality_psi_max": probe_quality_max("psi_max"),
        "shadow_divergence": probe_quality_max("divergence"),
    }
    rules = []
    for name, probe in probes.items():
        direction, threshold = th.get(
            name, FALLBACK_THRESHOLDS.get(name, ("lower", 0.0)))
        rules.append(Rule(
            name=name, probe=probe, threshold=float(threshold),
            direction=direction, breach_for=breach_for,
            clear_for=clear_for,
        ))
    return rules


class Watchdog:
    """Rolling evaluator + alert state machine over the live registry.

    ``start()`` runs :meth:`evaluate_once` every ``interval_s`` on a
    daemon thread; tests drive the machine deterministically by calling
    :meth:`evaluate_once` themselves (no thread, no clock coupling).
    ``slo_alert`` events go through :func:`emit_event` (so they land in
    the same JSONL stream as ``fleet_slo`` rows and show up as instant
    markers in the exported Perfetto trace), and the registry carries
    ``watchdog/alerts_active`` / ``watchdog/alerts_total`` for scrapes.
    """

    def __init__(self, rules: Optional[List[Rule]] = None,
                 interval_s: float = 2.0,
                 telemetry_path: Optional[str] = None,
                 registry=None):
        from spark_ensemble_tpu_torch.telemetry.events import (
            global_metrics, serving_stream_id,
        )

        self.rules = list(rules) if rules is not None else default_rules()
        self.interval_s = float(interval_s)
        self._telemetry_path = telemetry_path
        self._registry = registry if registry is not None else global_metrics()
        self._stream = serving_stream_id("watchdog")
        self._lock = threading.Lock()
        self._ticks = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        self._gauge_active = self._registry.gauge("watchdog/alerts_active")
        self._gauge_active.set(0)
        self._counter_total = self._registry.counter("watchdog/alerts_total")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- alert plumbing ----------------------------------------------------

    def _emit(self, rule: Rule, state: str) -> None:
        from spark_ensemble_tpu_torch.telemetry.events import emit_event

        emit_event(
            "slo_alert",
            path=self._telemetry_path,
            stream=self._stream,
            state=state,
            metric=rule.name,
            value=rule.last_value,
            threshold=rule.threshold,
            direction=rule.direction,
            ticks=self._ticks,
        )

    def evaluate_once(
        self, snapshot: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """One tick: probe every rule, advance its hysteresis counters,
        raise/clear alerts.  Returns the per-rule readings (the shape
        ``/statusz`` embeds).  Safe to call concurrently with the
        background thread (one tick at a time under the lock)."""
        if snapshot is None:
            snapshot = self._registry.snapshot()
        with self._lock:
            self._ticks += 1
            readings: Dict[str, Any] = {}
            for rule in self.rules:
                value = None
                try:
                    value = rule.probe(snapshot)
                except Exception:  # noqa: BLE001 - a probe bug != an outage
                    value = None
                rule.last_value = value
                if value is None:
                    # nothing live to judge (no fleet running, no fit
                    # finished): freeze the state machine, don't clear
                    readings[rule.name] = {
                        "value": None, "threshold": rule.threshold,
                        "active": rule.active,
                    }
                    continue
                if rule.breaching(value):
                    rule.breach_ticks += 1
                    rule.ok_ticks = 0
                    if (not rule.active
                            and rule.breach_ticks >= rule.breach_for):
                        rule.active = True
                        self._counter_total.inc()
                        self._emit(rule, "raised")
                else:
                    rule.ok_ticks += 1
                    rule.breach_ticks = 0
                    if rule.active and rule.ok_ticks >= rule.clear_for:
                        rule.active = False
                        self._emit(rule, "cleared")
                readings[rule.name] = {
                    "value": value, "threshold": rule.threshold,
                    "active": rule.active,
                }
            self._gauge_active.set(
                sum(1 for r in self.rules if r.active))
            return readings

    def verdict(self) -> Dict[str, Any]:
        """The ``/healthz`` payload: ``ok`` unless any alert is active."""
        with self._lock:
            alerts = [
                {
                    "metric": r.name, "value": r.last_value,
                    "threshold": r.threshold, "direction": r.direction,
                }
                for r in self.rules if r.active
            ]
            return {
                "status": "degraded" if alerts else "ok",
                "alerts": alerts,
                "ticks": self._ticks,
                "interval_s": self.interval_s,
                "rules": {
                    r.name: {"threshold": r.threshold,
                             "direction": r.direction,
                             "value": r.last_value,
                             "active": r.active}
                    for r in self.rules
                },
            }

    # -- background loop ---------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception as e:  # noqa: BLE001 - the watchdog never crashes
                # the process it watches: its owner reads ``errors``
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"

    def start(self) -> "Watchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="se-torch-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
