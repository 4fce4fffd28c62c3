"""The port's serving fleet (``spark_ensemble_tpu_torch/serving/fleet.py``)
and shadow scorer (``telemetry/quality.py::ShadowScorer``), case for case
with ``tests/test_fleet.py``'s engine-clone and fleet cases and
``tests/test_quality.py``'s fleet and shadow cases, on the CPU, plus parity
with the JAX package.

Tolerances: on the CPU the port's engine outputs are its model's own bit
for bit, so responses through the fleet (full model, ``take(k)`` tiers,
hedged and replayed requests) are held EQUAL to the port model's
predictions.  Against the JAX fleet over one artifact the contract is the
JAX engine's: rtol 1e-5, atol 1e-6 (tests/test_serving.py).  The shadow
scorer's sampled request ids and classification divergences are EQUAL to
the JAX scorer's; regression divergence and the accuracy delta are within
rtol 1e-5.  ``slo_snapshot()`` keys are EQUAL."""

import time

import numpy as np
import pytest

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.serving import FleetRouter as JaxFleet
from spark_ensemble_tpu.serving import ModelRegistry as JaxRegistry
from spark_ensemble_tpu.serving import load_packed as jax_load_packed
from spark_ensemble_tpu.telemetry.quality import ShadowScorer as JaxShadow
from spark_ensemble_tpu_torch.robustness.chaos import ChaosController, install
from spark_ensemble_tpu_torch.robustness.retry import RetryPolicy
from spark_ensemble_tpu_torch.serving import (
    FleetOverloadError,
    FleetResponse,
    FleetRouter,
    InferenceEngine,
    ModelRegistry,
    load_packed,
    pack,
)
from spark_ensemble_tpu_torch.telemetry import record_fits
from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot, global_metrics
from spark_ensemble_tpu_torch.telemetry.quality import ShadowScorer
from spark_ensemble_tpu_torch.telemetry.watchdog import Rule, Watchdog, probe_quality_max

ROUNDS = 5


def _data(n=96, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    X, y = _data()
    model = st.GBMRegressor(num_base_learners=ROUNDS).fit(X, y, device="cpu")
    return X, y, model


@pytest.fixture(scope="module")
def quality_model():
    """tests/test_quality.py's fixture: 256 x 6, depth 3, 4 rounds, with
    the fit-time drift reference."""
    X, y = _data(n=256, d=6)
    model = st.GBMRegressor(base_learner=st.DecisionTreeRegressor(max_depth=3),
                            num_base_learners=4).fit(X, y, device="cpu")
    return X, y, pack(model)


@pytest.fixture(autouse=True)
def _deterministic_chaos():
    install(ChaosController(seed=0, rate=0.0))
    yield
    install(None)


def _want(model, X):
    return model.predict(X).numpy()


# ---------------------------------------------------------------------------
# engine clones (tests/test_fleet.py)
# ---------------------------------------------------------------------------


def test_engine_clone_shares_programs(fitted):
    X, y, model = fitted
    p = pack(model)
    want, want3 = p.predict(X[:5]).numpy(), p.take(3).predict(X[:5]).numpy()
    with InferenceEngine(p, prefix_tiers=(3,), min_bucket=8, max_batch_size=16) as eng:
        c0, _ = compile_snapshot()
        clone = eng.clone("clone")
        try:
            np.testing.assert_array_equal(clone.predict(X[:5]), want)
            np.testing.assert_array_equal(clone.predict(X[:5], tier=3), want3)
            np.testing.assert_array_equal(clone.submit(X[:5]).result(timeout=30), want)
            assert compile_snapshot()[0] == c0
            assert clone.stats()["compiles_since_warmup"] == 0
            assert clone._compiled is eng._compiled
        finally:
            clone.stop()


# ---------------------------------------------------------------------------
# routing and SLO telemetry
# ---------------------------------------------------------------------------


def test_fleet_routes_and_zero_compiles(fitted):
    X, y, model = fitted
    sizes = (1, 4, 7, 16)
    want = {n: _want(model, X[:n]) for n in sizes}
    with record_fits() as rec:
        with FleetRouter(model, replicas=3, min_bucket=8, max_batch_size=16,
                         deadline_ms=30_000.0) as fleet:
            for i in range(8):
                n = sizes[i % len(sizes)]
                resp = fleet.predict(X[:n])
                assert isinstance(resp, FleetResponse)
                assert resp.tier == 0 and not resp.degraded
                np.testing.assert_array_equal(resp.value, want[n])
            futs = [fleet.submit(X[: sizes[i % len(sizes)]]) for i in range(24)]
            for i, f in enumerate(futs):
                np.testing.assert_array_equal(f.result(timeout=30).value,
                                              want[sizes[i % len(sizes)]])
            snap = fleet.slo_snapshot()
            assert snap["requests"] == 32
            assert snap["compiles_since_warmup"] == 0
            assert snap["shed"] == 0 and snap["crashes"] == 0
            assert sum(r["served"] for r in snap["replicas"].values()) >= 32
            busy = [r for r in snap["replicas"].values() if r["served"] > 0]
            assert len(busy) >= 2
            assert snap["p99_ms"] >= snap["p50_ms"] > 0
            assert fleet.stats()["fleet"]["requests"] == 32
    served = [e for e in rec.events if e["event"] == "fleet_request"]
    assert len(served) == 32
    assert all(e["latency_ms"] > 0 and not e["degraded"] for e in served)
    slo = [e for e in rec.events if e["event"] == "fleet_slo"]
    assert {e["replica"] for e in slo} >= {"*"}
    assert len(slo) == 4


def test_fleet_serves_one_row_and_tensor_requests(fitted):
    X, y, model = fitted
    import torch

    with FleetRouter(model, replicas=2, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0) as fleet:
        np.testing.assert_array_equal(fleet.predict(X[3]).value, _want(model, X[3:4])[0])
        np.testing.assert_array_equal(fleet.predict(torch.from_numpy(X[:6])).value,
                                      _want(model, X[:6]))


# ---------------------------------------------------------------------------
# chaos battery
# ---------------------------------------------------------------------------


def test_fleet_hedges_on_stalled_replica(fitted):
    X, y, model = fitted
    want = _want(model, X[:4])
    install(ChaosController(seed=7, rate=1.0, faults=("replica_stall",)))
    with FleetRouter(model, replicas=2, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0, hedge_init_ms=10.0) as fleet:
        resp = fleet.predict(X[:4])
        np.testing.assert_array_equal(resp.value, want)
        assert resp.hedged
        snap = fleet.slo_snapshot()
        assert snap["hedges_fired"] >= 1
        assert snap["crashes"] == 0


def test_fleet_kill_replica_drains_and_replays(fitted):
    X, y, model = fitted
    want = _want(model, X[:4])
    with FleetRouter(model, replicas=2, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0, shed_depth=10_000) as fleet:
        futs = [fleet.submit(X[:4]) for _ in range(40)]
        killed = fleet.kill_replica()
        futs += [fleet.submit(X[:4]) for _ in range(20)]
        responses = [f.result(timeout=60) for f in futs]
        assert len(responses) == 60
        for r in responses:
            np.testing.assert_array_equal(r.value, want)
        snap = fleet.slo_snapshot()
        assert snap["crashes"] == 1
        assert snap["replays"] >= 1
        assert snap["replicas"][killed]["state"] == "ejected"
        live = [r for r in snap["replicas"].values() if r["state"] != "ejected"]
        assert len(live) == 1 and live[0]["state"] in ("healthy", "degraded")


def test_fleet_chaos_crash_then_half_open_readmission(fitted):
    X, y, model = fitted
    want = _want(model, X[:4])
    install(ChaosController(seed=3, rate=1.0, faults=("replica_crash",)))
    backoff = RetryPolicy(max_retries=0, base_delay=0.05, max_delay=0.1, jitter=0.0)
    with FleetRouter(model, replicas=2, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0, breaker_backoff=backoff) as fleet:
        resp = fleet.predict(X[:4])
        np.testing.assert_array_equal(resp.value, want)
        assert resp.replays >= 1
        snap = fleet.slo_snapshot()
        assert snap["crashes"] == 1
        assert len([n for n, r in snap["replicas"].items() if r["state"] == "ejected"]) == 1
        time.sleep(0.2)
        for _ in range(8):
            np.testing.assert_array_equal(fleet.predict(X[:4]).value, want)
        snap = fleet.slo_snapshot()
        assert all(r["state"] == "healthy" for r in snap["replicas"].values())
        assert all(r["served"] > 0 for r in snap["replicas"].values())
        assert snap["requests"] == 9 and snap["crashes"] == 1


def test_fleet_stress_every_request_answered_once(fitted):
    """More client threads than cores, a short switch interval, a replica
    killed and one added mid-stream: every request resolves exactly once
    (one ``fleet_request`` event per request id) with its model's bits."""
    import sys
    import threading

    X, y, model = fitted
    want = {n: _want(model, X[:n]) for n in (1, 3, 8, 16, 40)}
    results, errors = [], []
    lock = threading.Lock()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with record_fits() as rec:
            with FleetRouter(model, replicas=3, min_bucket=8, max_batch_size=16,
                             deadline_ms=30_000.0, shed_depth=10_000,
                             hedge_init_ms=1.0) as fleet:

                def client(c):
                    for i in range(12):
                        n = (1, 3, 8, 16, 40)[(c + i) % 5]
                        try:
                            r = fleet.submit(X[:n]).result(timeout=60)
                        except Exception as e:  # noqa: BLE001 - collected, asserted empty
                            with lock:
                                errors.append(e)
                        else:
                            with lock:
                                results.append((n, r))

                threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
                for t in threads:
                    t.start()
                fleet.kill_replica()
                fleet.add_replica()
                for t in threads:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in threads)
                snap = fleet.slo_snapshot()
    finally:
        sys.setswitchinterval(prev)
    assert not errors and len(results) == 16 * 12
    for n, r in results:
        np.testing.assert_array_equal(r.value, want[n])
    seqs = [e["seq"] for e in rec.events if e["event"] == "fleet_request"]
    assert len(seqs) == len(set(seqs)) == snap["requests"] == 16 * 12
    assert snap["crashes"] == 1 and snap["scale_ups"] == 1


def test_fleet_slow_replies_degrade_then_recover(fitted):
    """``slow_reply`` marks a slow streak: the replica degrades (and stays
    in rotation with a depth penalty); fast serves re-promote it."""
    X, y, model = fitted
    install(ChaosController(seed=1, rate=1.0, faults=("slow_reply",)))
    with FleetRouter(model, replicas=1, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0, slow_ms=10.0, slow_streak_limit=2,
                     recover_after=2) as fleet:
        for _ in range(3):
            fleet.predict(X[:4])
        (rep,) = fleet.slo_snapshot()["replicas"].values()
        assert rep["state"] == "degraded"
        install(ChaosController(seed=0, rate=0.0))
        for _ in range(3):
            fleet.predict(X[:4])
        (rep,) = fleet.slo_snapshot()["replicas"].values()
        assert rep["state"] == "healthy"


# ---------------------------------------------------------------------------
# staged degradation and shedding
# ---------------------------------------------------------------------------


def test_fleet_degrades_to_prefix_under_deadline_pressure(fitted):
    X, y, model = fitted
    p = pack(model)
    want2, want_full = p.take(2).predict(X[:4]).numpy(), p.predict(X[:4]).numpy()
    with FleetRouter(model, replicas=2, prefix_tiers=(2,), min_bucket=8,
                     max_batch_size=16, deadline_ms=30_000.0, deadline_grace=1e6) as fleet:
        resp = fleet.predict(X[:4], deadline_ms=0.25)
        assert resp.degraded and resp.tier == 2
        np.testing.assert_array_equal(resp.value, want2)
        full = fleet.predict(X[:4])
        assert not full.degraded and full.tier == 0
        np.testing.assert_array_equal(full.value, want_full)
        snap = fleet.slo_snapshot()
        assert snap["degraded"] == 1
        assert 0.0 < snap["degraded_share"] < 1.0
        assert snap["compiles_since_warmup"] == 0


def test_fleet_sheds_past_depth_and_without_live_replicas(fitted):
    X, y, model = fitted
    with FleetRouter(model, replicas=1, min_bucket=8, max_batch_size=16, shed_depth=0) as fleet:
        with pytest.raises(FleetOverloadError, match="shed"):
            fleet.submit(X[:4])
        assert fleet.slo_snapshot()["shed"] == 1
    slow = RetryPolicy(max_retries=0, base_delay=60.0, max_delay=60.0)
    with FleetRouter(model, replicas=1, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0, breaker_backoff=slow) as fleet:
        fleet.predict(X[:4])
        killed = fleet.kill_replica()
        deadline = time.time() + 10.0
        while (fleet.slo_snapshot()["replicas"][killed]["state"] != "ejected"
               and time.time() < deadline):
            time.sleep(0.01)
        with pytest.raises(FleetOverloadError, match="no live replica"):
            fleet.submit(X[:4])


def test_fleet_rejects_malformed_requests_without_breaker_damage(fitted):
    X, y, model = fitted
    with FleetRouter(model, replicas=2, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0) as fleet:
        with pytest.raises(ValueError):
            fleet.submit(np.zeros((4, 3), np.float32))
        snap = fleet.slo_snapshot()
        assert all(r["state"] == "healthy" and r["failed"] == 0
                   for r in snap["replicas"].values())


def test_fleet_statusz_and_stop_is_idempotent(fitted):
    X, y, model = fitted
    fleet = FleetRouter(model, replicas=2, min_bucket=8, max_batch_size=16,
                        deadline_ms=30_000.0)
    fleet.predict(X[:4])
    sz = fleet.statusz()
    assert sz["model"] == {"num_members": ROUNDS, "num_features": 5}
    assert sz["requests"] == 1 and not sz["stopped"] and not sz["pinned"]
    fleet.stop()
    fleet.stop()
    assert fleet.statusz()["stopped"]
    with pytest.raises(RuntimeError, match="stopped"):
        fleet.submit(X[:4])


# ---------------------------------------------------------------------------
# the quality plane through the fleet (tests/test_quality.py)
# ---------------------------------------------------------------------------


def test_fleet_attribution_populates_response(quality_model):
    X, _, packed = quality_model
    with FleetRouter(packed, replicas=1, prefix_tiers=(1, 2), min_bucket=8,
                     max_batch_size=32, deadline_ms=30_000.0, drift=False,
                     attribution_fraction=1.0, uncertainty_threshold=-1.0) as fleet:
        resp = fleet.predict(X[:8])
        assert resp.uncertainty is not None
        assert set(resp.staged_margins) == {"1", "2"}
        assert resp.quality_flagged is True
        slo = fleet.stats()["fleet"]
        assert slo["attributed"] >= 1
        assert slo["quality_flagged"] >= 1


def test_fleet_stop_closes_owned_drift_source(quality_model):
    X, _, packed = quality_model
    fleet = FleetRouter(packed, replicas=2, min_bucket=8, max_batch_size=32,
                        deadline_ms=30_000.0, drift=True, drift_window=64)
    try:
        for i in range(4):
            fleet.predict(X[16 * i: 16 * (i + 1)])
        live = [k for k in global_metrics().snapshot()
                if k.startswith("quality/") and "warm" in k]
        assert live
    finally:
        fleet.stop()
    leaked = [k for k in global_metrics().snapshot()
              if k.startswith("quality/") and "warm" in k]
    assert leaked == [], leaked


def test_fleet_drift_arc_flips_verdict_and_clears(quality_model, tmp_path):
    """A covariate-shifted burst through a warmed drift-on fleet scores a
    window past the PSI threshold, lands ``quality_alert``, flips the
    watchdog verdict degraded through ``quality_psi_max``, and clears
    (clear_for=2) once traffic normalizes, with no capture after warmup.
    (The JAX test reads the verdict through the operator plane's /healthz,
    which the port does not have yet.)"""
    import json

    X, _, packed = quality_model
    telemetry = tmp_path / "quality.jsonl"
    dog = Watchdog(rules=[Rule("quality_psi_max", probe_quality_max("psi_max"),
                               threshold=0.25, breach_for=1, clear_for=2)],
                   interval_s=3600.0, telemetry_path=str(telemetry))
    with FleetRouter(packed, replicas=1, min_bucket=32, max_batch_size=64,
                     deadline_ms=30_000.0, drift=True, drift_window=256,
                     telemetry_path=str(telemetry)) as fleet:
        before = compile_snapshot()[0]
        for i in range(4):
            fleet.predict(X[64 * i: 64 * (i + 1)])
        dog.evaluate_once()
        assert dog.verdict()["status"] == "ok"
        for i in range(4):
            fleet.predict(X[64 * i: 64 * (i + 1)] + 3.0)
        dog.evaluate_once()
        verdict = dog.verdict()
        assert verdict["status"] == "degraded"
        assert verdict["alerts"][0]["metric"] == "quality_psi_max"
        for i in range(4):
            fleet.predict(X[64 * i: 64 * (i + 1)])
        dog.evaluate_once()
        assert dog.verdict()["status"] == "degraded"
        dog.evaluate_once()
        assert dog.verdict()["status"] == "ok"
        assert compile_snapshot()[0] == before
    events = [json.loads(line) for line in telemetry.read_text().splitlines()]
    windows = [e for e in events if e["event"] == "drift_window"]
    assert [w["window"] for w in windows] == [1, 2, 3]
    assert windows[0]["psi_max"] < 0.25 < windows[1]["psi_max"]
    assert windows[2]["psi_max"] < 0.25
    assert [a["state"] for a in events if a["event"] == "quality_alert"] == ["raised", "cleared"]
    slo = [e for e in events if e["event"] == "slo_alert"]
    assert [a["state"] for a in slo] == ["raised", "cleared"]


# ---------------------------------------------------------------------------
# shadow scoring (tests/test_quality.py)
# ---------------------------------------------------------------------------


def test_shadow_scorer_sampling_divergence_and_labels(quality_model):
    X, y, packed = quality_model
    registry = ModelRegistry()
    registry.register("candidate", packed, warm=True, min_bucket=8, max_batch_size=32)
    scorer = ShadowScorer(registry, "candidate", fraction=0.5, window=8)
    try:
        primary = packed.predict(X[:8])
        for i in range(4):
            scorer.observe(X[:8], primary, request_id=i)
        snap = scorer.snapshot()
        assert snap["requests_seen"] == 4
        assert snap["evals"] == 2
        # the same model both sides: on the CPU the engine is the model's
        # own bits, so no divergence at all
        assert snap["divergence"] == 0.0
        assert snap["errors"] == 0
        assert scorer.record_label(0, y[:8]) is True
        assert scorer.record_label(1, y[:8]) is False
        assert scorer.snapshot()["accuracy_delta"] == 0.0
    finally:
        scorer.close()
        registry.close()


def test_shadow_scorer_survives_sick_candidate(quality_model):
    X, _, packed = quality_model
    registry = ModelRegistry()
    scorer = ShadowScorer(registry, "never-registered", fraction=1.0)
    try:
        assert scorer.observe(X[:8], packed.predict(X[:8])) is None
        snap = scorer.snapshot()
        assert snap["errors"] == 1 and snap["evals"] == 0
    finally:
        scorer.close()
        registry.close()


def test_fleet_feeds_its_shadow_after_delivery(quality_model, tmp_path):
    """A fleet's shadow sees every delivered full-tier request; a
    divergent candidate raises the ``quality_alert`` and the
    ``shadow_divergence`` probe reads it."""
    X, y, packed = quality_model
    registry = ModelRegistry(min_bucket=8, max_batch_size=32)
    registry.register("cand", packed.take(1), warm=True)
    scorer = ShadowScorer(registry, "cand", fraction=1.0, divergence_threshold=0.01)
    try:
        with record_fits() as rec:
            with FleetRouter(packed, replicas=1, min_bucket=8, max_batch_size=32,
                             deadline_ms=30_000.0, drift=False, shadow=scorer) as fleet:
                for i in range(4):
                    fleet.predict(X[8 * i: 8 * (i + 1)])
                deadline = time.time() + 10.0
                while scorer.snapshot()["evals"] < 4 and time.time() < deadline:
                    time.sleep(0.005)
        snap = scorer.snapshot()
        assert snap["evals"] == 4 and snap["alert_active"]
        assert probe_quality_max("divergence")(global_metrics().snapshot()) >= snap["divergence"]
        evals = [e for e in rec.events if e["event"] == "shadow_eval"]
        assert len(evals) == 4
        alerts = [e for e in rec.events if e["event"] == "quality_alert"]
        assert [a["state"] for a in alerts] == ["raised"]
        assert alerts[0]["metric"] == "shadow_divergence"
    finally:
        scorer.close()
        registry.close()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _dyadic_data(n=256, d=6, seed=0):
    X, y = _data(n, d, seed)
    return X, (np.round(y * 16) / 16).astype(np.float32)


def _tree_arrays(members):
    return {f: np.asarray(getattr(members, f)) for f in st.ops.tree.Tree._fields}


def _convert(jm, kind):
    if kind == "classifier":
        arrays = dict(_tree_arrays(jm.params["members"]),
                      weights=np.asarray(jm.params["weights"]),
                      init_raw=np.asarray(jm.params["init_raw"]))
        return st.gbm_classifier_from_arrays(jm.get_params(), arrays,
                                             num_features=jm.num_features,
                                             num_classes=jm.num_classes, device="cpu")
    arrays = dict(_tree_arrays(jm.params["members"]),
                  weights=np.asarray(jm.params["weights"]),
                  init=np.asarray(jm.params["init"]["value"]))
    return st.gbm_regressor_from_arrays(jm.get_params(), arrays,
                                        num_features=jm.num_features, device="cpu")


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_shadow_scorer_equals_the_jax_scorer(kind):
    """JAX-fitted primary and candidate, converted with ``convert.py``; the
    same requests through both packages' scorers (fraction 0.25)."""
    X, y = _dyadic_data()
    tree = se.DecisionTreeRegressor(max_depth=3)
    if kind == "classifier":
        y = np.digitize(y, [-0.5, 0.5]).astype(np.float32)
        jp = se.GBMClassifier(base_learner=tree, num_base_learners=3).fit(X, y)
        jc = se.GBMClassifier(base_learner=tree, num_base_learners=1).fit(X, y)
    else:
        jp = se.GBMRegressor(base_learner=tree, num_base_learners=4).fit(X, y)
        jc = se.GBMRegressor(base_learner=tree, num_base_learners=2).fit(X, y)
    tp, tc = _convert(jp, kind), _convert(jc, kind)
    kw = dict(min_bucket=8, max_batch_size=32)
    reg, jreg = ModelRegistry(**kw), JaxRegistry(**kw)
    reg.register("cand", tc, warm=True)
    jreg.register("cand", jc, warm=True)
    ours = ShadowScorer(reg, "cand", fraction=0.25, stream="shadow-port")
    theirs = JaxShadow(jreg, "cand", fraction=0.25, stream="shadow-jax")
    try:
        sampled, jsampled = [], []
        for i in range(16):
            rows = X[16 * i: 16 * i + 5 + i]
            a = ours.observe(rows, tp.predict(rows), request_id=i)
            b = theirs.observe(rows, np.asarray(jp.predict(rows)), request_id=i)
            sampled += [i] if a is not None else []
            jsampled += [i] if b is not None else []
            if a is not None:
                assert a["rows"] == b["rows"] and a["evals"] == b["evals"]
                if kind == "classifier":
                    assert a["divergence"] == b["divergence"]
                else:
                    np.testing.assert_allclose(a["divergence"], b["divergence"], rtol=1e-5)
        assert sampled == jsampled == [0, 4, 8, 12]
        for i in range(16):
            rows = y[16 * i: 16 * i + 5 + i]
            assert ours.record_label(i, rows) == theirs.record_label(i, rows)
        a, b = ours.snapshot(), theirs.snapshot()
        assert set(a) == set(b)
        for k in ("requests_seen", "evals", "sampled_rows", "errors", "labeled_rows",
                  "period", "alert_active"):
            assert a[k] == b[k], k
        if kind == "classifier":
            assert a["divergence"] == b["divergence"]
            assert a["accuracy_delta"] == b["accuracy_delta"]
        else:
            np.testing.assert_allclose(a["divergence"], b["divergence"], rtol=1e-5)
            np.testing.assert_allclose(a["accuracy_delta"], b["accuracy_delta"], rtol=1e-5)
        assert a["divergence"] > 0.0
    finally:
        ours.close()
        theirs.close()
        reg.close()
        jreg.close()


def test_fleet_equals_the_jax_fleet_on_one_artifact(tmp_path):
    """Both fleets over one JAX-written artifact, full model and a prefix
    tier: within the engine contract of each other, and the port's EQUAL
    to its own model's predictions; ``slo_snapshot()`` and ``statusz()``
    keys equal the JAX fleet's."""
    X, y = _dyadic_data()
    jm = se.GBMRegressor(base_learner=se.DecisionTreeRegressor(max_depth=3),
                         num_base_learners=4).fit(X, y)
    path = str(tmp_path / "art")
    jm.pack().save(path)
    ours_packed = load_packed(path, device="cpu")
    kw = dict(replicas=2, prefix_tiers=(2,), min_bucket=8, max_batch_size=32,
              deadline_ms=30_000.0, deadline_grace=1e6)
    with FleetRouter(ours_packed, **kw) as ours, JaxFleet(jax_load_packed(path), **kw) as theirs:
        for n in (1, 5, 16, 40):
            a, b = ours.predict(X[:n]), theirs.predict(X[:n])
            np.testing.assert_allclose(a.value, np.asarray(b.value), rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(a.value, ours_packed.predict(X[:n]).numpy())
        a = ours.predict(X[:8], deadline_ms=0.25)
        b = theirs.predict(X[:8], deadline_ms=0.25)
        assert a.degraded and b.degraded and a.tier == b.tier == 2
        np.testing.assert_allclose(a.value, np.asarray(b.value), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(a.value, ours_packed.take(2).predict(X[:8]).numpy())
        sa, sb = ours.slo_snapshot(), theirs.slo_snapshot()
        assert set(sa) == set(sb)
        assert set(next(iter(sa["replicas"].values()))) == set(
            next(iter(sb["replicas"].values())))
        assert set(ours.statusz()) == set(theirs.statusz())
        assert set(ours.stats()) == set(theirs.stats())
