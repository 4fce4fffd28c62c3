"""The port's online watchdog (``spark_ensemble_tpu_torch/telemetry/
watchdog.py``), case for case with ``tests/test_operator_plane.py``'s
watchdog cases and ``tests/test_quality.py``'s quality rules, plus parity
with the JAX package: the same sequence of registry snapshots through both
packages' ``Watchdog.evaluate_once`` gives EQUAL readings, alert
transitions and ``verdict()``, and ``sentinel_thresholds()`` gives equal
dicts (discrete state and host floats: equality, no tolerance)."""

import importlib.util
import json
import os

import numpy as np
import pytest

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.telemetry import record_fits as jax_record_fits
from spark_ensemble_tpu.telemetry import watchdog as jw
from spark_ensemble_tpu_torch.robustness.chaos import ChaosController, install
from spark_ensemble_tpu_torch.serving import FleetRouter, pack
from spark_ensemble_tpu_torch.telemetry import record_fits
from spark_ensemble_tpu_torch.telemetry.events import global_metrics
from spark_ensemble_tpu_torch.telemetry.quality import DriftMonitor
from spark_ensemble_tpu_torch.telemetry.watchdog import (
    FALLBACK_THRESHOLDS,
    Rule,
    Watchdog,
    default_rules,
    probe_fleet_max,
    probe_gauge,
    probe_quality_max,
    sentinel_thresholds,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(n=96, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


@pytest.fixture(autouse=True)
def _deterministic_chaos():
    install(ChaosController(seed=0, rate=0.0))
    yield
    install(None)


# ---------------------------------------------------------------------------
# thresholds
# ---------------------------------------------------------------------------


def _sentinel_repo(tmp_path):
    tools = tmp_path / "tools"
    tools.mkdir()
    (tools / "perf_sentinel.py").write_text(
        'METRICS = {"serving_p99_ms": ("lower", 0.25, 1.0),\n'
        '           "hedge_rate": ("lower", 0.5, 0.1)}\n'
    )
    (tmp_path / "PERF_BASELINE.json").write_text('{"serving_p99_ms": 100.0}\n')
    return str(tmp_path)


def test_sentinel_thresholds_derive_from_baseline(tmp_path):
    root = _sentinel_repo(tmp_path)
    th = sentinel_thresholds(repo_root=root)
    assert th["serving_p99_ms"] == ("lower", 125.0)
    assert th["hedge_rate"] == FALLBACK_THRESHOLDS["hedge_rate"]
    assert sentinel_thresholds(repo_root=str(tmp_path / "missing")) == FALLBACK_THRESHOLDS


@pytest.mark.parametrize("where", ["repo", "tmp", "missing"])
def test_sentinel_thresholds_equal_the_jax_package(tmp_path, where):
    root = {"repo": ROOT, "tmp": _sentinel_repo(tmp_path),
            "missing": str(tmp_path / "missing")}[where]
    assert sentinel_thresholds(repo_root=root) == jw.sentinel_thresholds(repo_root=root)
    assert FALLBACK_THRESHOLDS == jw.FALLBACK_THRESHOLDS


def test_default_rules_cover_the_slo_surface():
    rules = {r.name: r for r in default_rules()}
    assert set(rules) == set(FALLBACK_THRESHOLDS)
    assert all(r.direction == "lower" for r in rules.values())
    theirs = {r.name: r for r in jw.default_rules()}
    assert {n: (r.threshold, r.direction, r.breach_for, r.clear_for)
            for n, r in rules.items()} == {
        n: (r.threshold, r.direction, r.breach_for, r.clear_for)
        for n, r in theirs.items()}


def test_quality_rules_in_default_surface():
    assert FALLBACK_THRESHOLDS["quality_psi_max"] == ("lower", 0.25)
    assert FALLBACK_THRESHOLDS["shadow_divergence"] == ("lower", 0.25)


def test_probe_quality_max_scans_live_sources():
    probe = probe_quality_max("psi_max")
    assert probe({}) is None
    thr = np.array([[-1.0, 0.0, 1.0]], np.float32)
    ref = np.array([[100, 100, 100, 100]], np.int64)
    mon = DriftMonitor(thr, ref, window_rows=40, score_groups=4, stream="probe-test")
    try:
        mon.observe(np.array([[0, 0, 0, 40]]))
        value = probe(global_metrics().snapshot())
        assert value is not None and value > 0.25
    finally:
        mon.close()


def test_gauge_probes_read_the_fit_gauges():
    """``host_blocked_share`` and ``cost_model_error_pct`` read the
    ``fit/*`` gauges a finished (recorded) fit sets."""
    X, y = _data()
    with record_fits():
        st.GBMRegressor(num_base_learners=2).fit(X, y, device="cpu")
    snap = global_metrics().snapshot()
    share = probe_gauge("fit/host_blocked_share")(snap)
    assert share is not None and 0.0 <= share <= 1.0
    assert probe_gauge("fit/cost_model_error_pct", absolute=True)(
        {"fit/cost_model_error_pct": {"type": "gauge", "value": -12.5}}) == 12.5
    assert probe_gauge("x")({"x": {"type": "counter", "value": 3}}) is None


# ---------------------------------------------------------------------------
# the alert state machine
# ---------------------------------------------------------------------------


def test_watchdog_raises_and_clears_slo_alert(tmp_path):
    """replica_stall at rate 1.0 pushes the fleet's p99 past the rule's
    threshold, one tick raises the alert, the verdict degrades; a fast
    wash pushes the stalls out of the router's rolling window and two
    healthy ticks clear it; both transitions land as ``slo_alert`` events
    and as instants in the trace viewer's export."""
    X, y = _data()
    model = pack(st.GBMRegressor(num_base_learners=3).fit(X, y, device="cpu"))
    telemetry = tmp_path / "slo.jsonl"
    dog = Watchdog(
        rules=[Rule("serving_p99_ms", probe_fleet_max("p99_ms"),
                    threshold=50.0, breach_for=1, clear_for=2)],
        interval_s=3600.0, telemetry_path=str(telemetry),
    )
    with FleetRouter(model, replicas=2, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0, telemetry_path=str(telemetry)) as fleet:
        install(ChaosController(seed=7, rate=1.0, faults=("replica_stall",)))
        for _ in range(6):
            fleet.predict(X[:8])
        readings = dog.evaluate_once()
        assert readings["serving_p99_ms"]["active"] is True
        verdict = dog.verdict()
        assert verdict["status"] == "degraded"
        assert verdict["alerts"][0]["metric"] == "serving_p99_ms"

        install(ChaosController(seed=0, rate=0.0))
        for _ in range(300):
            fleet.predict(X[:8])
        dog.evaluate_once()
        assert dog.verdict()["status"] == "degraded"
        dog.evaluate_once()
        assert dog.verdict()["status"] == "ok"

    lines = [json.loads(line) for line in telemetry.read_text().splitlines()]
    alerts = [e for e in lines if e["event"] == "slo_alert"]
    assert [a["state"] for a in alerts] == ["raised", "cleared"]
    assert all(a["metric"] == "serving_p99_ms" for a in alerts)
    assert alerts[0]["value"] > alerts[0]["threshold"]

    spec = importlib.util.spec_from_file_location(
        "_viewer", os.path.join(ROOT, "tools", "trace_viewer.py"))
    viewer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(viewer)
    trace = viewer.to_trace_events(
        viewer.select_spans(lines),
        [e for e in lines if e.get("event") in viewer.INSTANT_EVENTS],
    )
    names = {ev.get("name") for ev in trace["traceEvents"] if ev.get("ph") == "i"}
    assert "slo_alert" in names


def test_watchdog_probe_freeze_never_clears():
    values = {"v": 100.0}
    rule = Rule("x", lambda snap: values["v"], threshold=10.0, breach_for=1, clear_for=1)
    dog = Watchdog(rules=[rule], interval_s=3600.0)
    dog.evaluate_once(snapshot={})
    assert dog.verdict()["status"] == "degraded"
    values["v"] = None
    dog.evaluate_once(snapshot={})
    assert dog.verdict()["status"] == "degraded"
    values["v"] = 1.0
    dog.evaluate_once(snapshot={})
    assert dog.verdict()["status"] == "ok"


def test_watchdog_hysteresis_widths():
    values = {"v": 0.0}
    rule = Rule("x", lambda snap: values["v"], threshold=10.0, breach_for=3, clear_for=2)
    dog = Watchdog(rules=[rule], interval_s=3600.0)
    values["v"] = 100.0
    dog.evaluate_once(snapshot={})
    dog.evaluate_once(snapshot={})
    assert dog.verdict()["status"] == "ok"
    dog.evaluate_once(snapshot={})
    assert dog.verdict()["status"] == "degraded"
    values["v"] = 0.0
    dog.evaluate_once(snapshot={})
    assert dog.verdict()["status"] == "degraded"
    dog.evaluate_once(snapshot={})
    assert dog.verdict()["status"] == "ok"


def test_watchdog_background_thread_ticks_and_stops():
    ticks = []
    rule = Rule("x", lambda snap: ticks.append(1) or 0.0, threshold=10.0)
    dog = Watchdog(rules=[rule], interval_s=0.01).start()
    try:
        deadline = 200
        while not ticks and deadline:
            import time

            time.sleep(0.01)
            deadline -= 1
    finally:
        dog.stop()
    assert ticks and dog.verdict()["status"] == "ok"


# ---------------------------------------------------------------------------
# parity: the same snapshots through both packages
# ---------------------------------------------------------------------------


def _snapshot(p99=1.0, hedge=0.0, psi=0.0, div=0.0, compiles=0.0, blocked=None):
    snap = {
        "fleet/x": {"type": "source", "value": {
            "p99_ms": p99, "hedge_rate": hedge, "compiles_since_warmup": compiles}},
        "quality/q": {"type": "source", "value": {"psi_max": psi, "divergence": div}},
    }
    if blocked is not None:
        snap["fit/host_blocked_share"] = {"type": "gauge", "value": blocked}
    return snap


SEQUENCE = [
    _snapshot(),
    _snapshot(p99=9999.0),
    _snapshot(p99=9999.0, hedge=0.9),
    _snapshot(psi=0.9, blocked=0.95),
    _snapshot(psi=0.9, div=0.6, compiles=3.0),
    {},
    _snapshot(div=0.6),
    _snapshot(),
    _snapshot(),
    _snapshot(blocked=0.1),
    _snapshot(),
]


@pytest.mark.parametrize("breach_for,clear_for", [(1, 1), (2, 3), (1, 2)])
def test_transitions_and_verdicts_equal_the_jax_watchdog(breach_for, clear_for):
    ours = Watchdog(rules=default_rules(breach_for=breach_for, clear_for=clear_for),
                    interval_s=3600.0)
    theirs = jw.Watchdog(rules=jw.default_rules(breach_for=breach_for, clear_for=clear_for),
                         interval_s=3600.0)
    with record_fits() as rec, jax_record_fits() as jrec:
        for snap in SEQUENCE:
            assert ours.evaluate_once(snap) == theirs.evaluate_once(snap)
            assert ours.verdict() == theirs.verdict()

    def transitions(events):
        return [(e["metric"], e["state"], e["value"], e["threshold"], e["ticks"])
                for e in events if e["event"] == "slo_alert"]

    a, b = transitions(rec.events), transitions(jrec.events)
    assert a == b and a  # something raised and cleared
    keys = {frozenset(e) for e in rec.events if e["event"] == "slo_alert"}
    jkeys = {frozenset(e) for e in jrec.events if e["event"] == "slo_alert"}
    assert keys == jkeys
