"""The port's closed serving loop (``spark_ensemble_tpu_torch/serving/
autopilot.py``, the fleet's hot swap and elastic width, the registry's
deferred ``remove()``, and the models' refresh hooks), case for case with
``tests/test_autopilot.py``, on the CPU, plus parity with the JAX package.

Pins: every response is computed by exactly ONE model version (its bits
equal that version's); a refresh (``fit_resume``) is BIT-identical to the
port's own uninterrupted longer fit; the JAX package's ``Autopilot`` fed
the same synthetic snapshots takes EQUAL actions (names, triggers,
statuses, models, member counts), and its refreshed model's predictions
are within rtol 1e-5 (atol 1e-6) of the port's on tie-free dyadic data."""

import threading
import time

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.robustness.chaos import ChaosController as JaxChaos
from spark_ensemble_tpu.robustness.chaos import install as jax_install
from spark_ensemble_tpu.serving import Autopilot as JaxAutopilot
from spark_ensemble_tpu.serving import FleetRouter as JaxFleet
from spark_ensemble_tpu.serving import ModelRegistry as JaxRegistry
from spark_ensemble_tpu.telemetry.watchdog import Watchdog as JaxWatchdog
from spark_ensemble_tpu.telemetry.watchdog import default_rules as jax_default_rules
from spark_ensemble_tpu_torch.models.base import tree_leaves
from spark_ensemble_tpu_torch.robustness.chaos import ChaosController, install
from spark_ensemble_tpu_torch.serving import Autopilot, FleetRouter, ModelRegistry
from spark_ensemble_tpu_torch.telemetry import record_fits
from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot
from spark_ensemble_tpu_torch.telemetry.watchdog import Watchdog, default_rules

ROUNDS = 4


def _data(n=96, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    X, y = _data()
    v1 = st.GBMRegressor(num_base_learners=ROUNDS, seed=0).fit(X, y, device="cpu")
    v2 = st.GBMRegressor(num_base_learners=2, seed=0).fit(X, y, device="cpu")
    return X, y, v1, v2


@pytest.fixture(autouse=True)
def _deterministic_chaos():
    install(ChaosController(seed=0, rate=0.0))
    yield
    install(None)


def _registry_fleet(fitted, replicas=3, capacity=4):
    X, y, v1, v2 = fitted
    reg = ModelRegistry(capacity=capacity, min_bucket=8, max_batch_size=16)
    reg.register("prod", v1, warm=True)
    reg.register("v2", v2, warm=True)
    fleet = FleetRouter.from_registry(reg, "prod", replicas=replicas, deadline_ms=30_000.0)
    return reg, fleet


def _snapshot(p99=1.0, hedge=0.0, psi=0.0, div=0.0):
    return {
        "fleet/x": {"type": "source", "value": {
            "p99_ms": p99, "hedge_rate": hedge, "compiles_since_warmup": 0.0}},
        "quality/q": {"type": "source", "value": {"psi_max": psi, "divergence": div}},
    }


def _watchdog():
    return Watchdog(rules=default_rules(breach_for=1, clear_for=1), interval_s=3600.0)


# ---------------------------------------------------------------------------
# torn-free rolling swap under live traffic (+ chaos swap_crash)
# ---------------------------------------------------------------------------


def test_swap_under_load_is_torn_free_and_zero_compile(fitted):
    X, y, v1, v2 = fitted
    Xq = X[:4]
    install(ChaosController(seed=5, rate=1.0, faults=("swap_crash",)))
    reg, fleet = _registry_fleet(fitted)
    try:
        want0 = np.asarray(fleet.predict(Xq).value)
        results, errors = [], []
        stop = threading.Event()

        def loadgen():
            while not stop.is_set():
                try:
                    r = fleet.predict(Xq)
                    results.append((r.version, np.asarray(r.value)))
                except Exception as e:  # noqa: BLE001 - collected, asserted empty
                    errors.append(e)

        threads = [threading.Thread(target=loadgen) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        c0, _ = compile_snapshot()
        info = fleet.swap_model("v2")
        time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        want1 = np.asarray(fleet.predict(Xq).value)

        assert not errors
        assert info["version"] == 1 and info["model"] == "v2"
        assert info["swap_compiles"] == 0
        assert info["swap_crashes"] == 1
        assert compile_snapshot()[0] == c0
        assert not np.array_equal(want0, want1)
        np.testing.assert_array_equal(want0, v1.predict(Xq).numpy())
        np.testing.assert_array_equal(want1, v2.predict(Xq).numpy())
        want = {0: want0, 1: want1}
        assert results and {v for v, _ in results} <= {0, 1}
        for version, value in results:
            np.testing.assert_array_equal(value, want[version])
        snap = fleet.slo_snapshot()
        assert snap["version"] == 1 and snap["swaps"] == 1
        assert all(r["version"] == 1 and r["state"] == "healthy"
                   for r in snap["replicas"].values())
    finally:
        fleet.stop()
        reg.close()


def test_swap_rejects_incompatible_width(fitted):
    X, y, v1, _ = fitted
    narrow = st.GBMRegressor(num_base_learners=2, seed=0).fit(X[:, :3], y, device="cpu")
    with FleetRouter(v1, replicas=1, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0) as fleet:
        with pytest.raises(ValueError, match="num_features"):
            fleet.swap_model(narrow)
        assert fleet.slo_snapshot()["version"] == 0


# ---------------------------------------------------------------------------
# elastic width (+ chaos scale_crash)
# ---------------------------------------------------------------------------


def test_elastic_scale_zero_drop_under_scale_crash(fitted):
    X, y, v1, _ = fitted
    want = v1.predict(X[:4]).numpy()
    install(ChaosController(seed=2, rate=1.0, faults=("scale_crash",)))
    with FleetRouter(v1, replicas=2, min_bucket=8, max_batch_size=16,
                     deadline_ms=30_000.0, shed_depth=10_000) as fleet:
        futs = [fleet.submit(X[:4]) for _ in range(30)]
        added = fleet.add_replica()
        futs += [fleet.submit(X[:4]) for _ in range(30)]
        removed = fleet.remove_replica(added)
        futs += [fleet.submit(X[:4]) for _ in range(10)]
        responses = [f.result(timeout=60) for f in futs]
        assert len(responses) == 70
        for r in responses:
            np.testing.assert_array_equal(r.value, want)
        assert removed == added
        snap = fleet.slo_snapshot()
        assert snap["crashes"] == 1
        assert snap["scale_ups"] == 1 and snap["scale_downs"] == 1
        assert len(snap["replicas"]) == 2
        assert snap["compiles_since_warmup"] == 0


def test_remove_last_replica_refused(fitted):
    X, y, v1, _ = fitted
    with FleetRouter(v1, replicas=1, min_bucket=8, max_batch_size=16) as fleet:
        with pytest.raises(ValueError, match="last replica"):
            fleet.remove_replica()


# ---------------------------------------------------------------------------
# autopilot: the deterministic scale/refresh/rollback drive
# ---------------------------------------------------------------------------


def test_autopilot_scales_refreshes_and_rolls_back(fitted):
    X, y, v1, v2 = fitted
    reg, fleet = _registry_fleet(fitted, replicas=2)
    pilot = Autopilot(fleet, _watchdog(), refresh_data=lambda: (X, y),
                      refresh_rounds=2, min_replicas=2, max_replicas=4,
                      calm_ticks=2, background_refresh=False)
    try:
        want_prod = np.asarray(fleet.predict(X[:4]).value)
        with record_fits() as rec:
            assert pilot.step(_snapshot()) == []
            a2 = pilot.step(_snapshot(p99=9999.0))
            assert [a["action"] for a in a2] == ["scale_up"]
            assert a2[0]["trigger"] == "serving_p99_ms"
            assert len(fleet.slo_snapshot()["replicas"]) == 3

            a3 = pilot.step(_snapshot(psi=0.9))
            assert [a["action"] for a in a3] == ["refresh"]
            ref = a3[0]
            assert ref["status"] == "ok"
            assert ref["model"] == "prod@v1" and "prod@v1" in reg
            assert ref["swap_compiles"] == 0
            assert ref["members"] == ROUNDS + 2
            assert fleet.predict(X[:4]).version == 1
            assert pilot.statusz()["rollback_pin"] == "prod"

            a4 = pilot.step(_snapshot(div=0.9))
            assert [a["action"] for a in a4] == ["rollback"]
            assert a4[0]["status"] == "ok" and a4[0]["target"] == "prod"
            assert fleet.predict(X[:4]).version == 2
            np.testing.assert_array_equal(np.asarray(fleet.predict(X[:4]).value), want_prod)
            assert pilot.statusz()["rollback_pin"] is None

            assert pilot.step(_snapshot()) == []
            a6 = pilot.step(_snapshot())
            assert [a["action"] for a in a6] == ["scale_down"]
            assert len(fleet.slo_snapshot()["replicas"]) == 2
        events = [e for e in rec.events if e["event"] == "fleet_action"]
        assert [e["action"] for e in events] == ["scale_up", "refresh", "rollback", "scale_down"]
        assert all(e["status"] == "ok" and e["flow"] and e["trigger"] for e in events)
        spans = [e for e in rec.events if e.get("name") == "fleet_action"]
        assert len(spans) == 4 and all(s.get("flow_out") for s in spans)
        st_ = pilot.statusz()
        assert st_["steps"] == 6 and st_["refresh_generation"] == 1
        assert not st_["refresh_inflight"]
    finally:
        pilot.stop()
        fleet.stop()
        reg.close()


def test_autopilot_respects_replica_bounds(fitted):
    reg, fleet = _registry_fleet(fitted, replicas=2)
    pilot = Autopilot(fleet, _watchdog(), min_replicas=2, max_replicas=2,
                      calm_ticks=1, background_refresh=False)
    try:
        assert pilot.step(_snapshot(p99=9999.0)) == []
        assert pilot.step(_snapshot()) == []
        assert pilot.step(_snapshot()) == []
        assert len(fleet.slo_snapshot()["replicas"]) == 2
    finally:
        pilot.stop()
        fleet.stop()
        reg.close()


def test_background_refresh_is_bit_identical_to_a_longer_fit(fitted):
    """``background_refresh=True`` (the default): the refresh runs on its
    own thread while requests keep flowing; the refreshed model equals an
    uninterrupted ``ROUNDS + 2``-round fit bit for bit, and the fleet rolls
    onto it."""
    X, y, v1, v2 = fitted
    full = st.GBMRegressor(num_base_learners=ROUNDS + 2, seed=0).fit(X, y, device="cpu")
    reg, fleet = _registry_fleet(fitted, replicas=2)
    pilot = Autopilot(fleet, _watchdog(), refresh_data=lambda: (X, y),
                      refresh_rounds=2, min_replicas=2, max_replicas=2)
    try:
        assert pilot.step(_snapshot(psi=0.9)) == []  # started, not awaited
        served = [fleet.predict(X[:4]) for _ in range(5)]
        assert pilot.join_refresh(timeout=120)
        assert [a["action"] for a in pilot.actions] == ["refresh"]
        assert pilot.actions[0]["status"] == "ok"
        refreshed = reg._entries["prod@v1"].packed.model()
        a, b = tree_leaves(refreshed.params), tree_leaves(full.params)
        assert len(a) == len(b) and all(torch.equal(p, q) for p, q in zip(a, b))
        resp = fleet.predict(X[:9])
        assert resp.version == 1
        np.testing.assert_array_equal(resp.value, full.predict(X[:9]).numpy())
        want = {0: v1.predict(X[:4]).numpy(), 1: full.predict(X[:4]).numpy()}
        for r in served:
            np.testing.assert_array_equal(r.value, want[r.version])
    finally:
        pilot.stop()
        fleet.stop()
        reg.close()


class _StreamPool:
    """PyTorch's CUDA stream pools as ``torch.cuda.Stream`` hands them out:
    32 streams per priority, round robin from a shared index; ``shared``
    is a card with no stream priorities, where both priorities draw from
    one pool."""

    def __init__(self, shared, size=32):
        self.shared, self.size, self.next = shared, size, {0: 0, -1: 0}

    def stream(self, device=None, priority=0):
        pool = 0 if self.shared else priority
        handle = 1000 * (1 - pool) + self.next[pool] % self.size
        self.next[pool] += 1
        return type("Stream", (), {"cuda_stream": handle, "priority": priority})()


@pytest.mark.parametrize("shared", [False, True], ids=["priorities", "one_pool"])
def test_refresh_stream_is_never_the_capture_stream(monkeypatch, shared):
    """A graph captured while a refresh fits takes in whatever is queued
    on the capture stream, so the refresh's stream must differ from it
    wherever the pool's round robin stands, and stays one stream across
    refreshes."""
    from spark_ensemble_tpu_torch.serving import engine as engine_mod

    dev = torch.device("cuda", 0)
    for gap in range(70):
        pool = _StreamPool(shared)
        monkeypatch.setattr(torch.cuda, "Stream", pool.stream)
        monkeypatch.setattr(engine_mod, "_CAPTURE_STREAMS", {})
        capture = engine_mod.capture_stream(dev)
        for _ in range(gap):  # graphs, prefetchers, other fits drawing streams
            pool.stream()
        pilot = Autopilot(type("Router", (), {})(), _watchdog())
        refresh = pilot.refresh_stream(dev)
        assert refresh.cuda_stream != capture.cuda_stream
        assert capture.priority == -1
        for _ in range(gap):
            pool.stream()
        assert pilot.refresh_stream(dev) is refresh
        assert engine_mod.capture_stream(dev) is capture
    assert pilot.refresh_stream(torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# chaos refresh_crash: untouched + retryable
# ---------------------------------------------------------------------------


def test_refresh_crash_leaves_serving_model_untouched_and_retries(fitted):
    X, y, v1, _ = fitted
    ctl = ChaosController(seed=11, rate=1.0, faults=("refresh_crash",))
    install(ctl)
    reg, fleet = _registry_fleet(fitted, replicas=2)
    pilot = Autopilot(fleet, _watchdog(), refresh_data=lambda: (X, y),
                      refresh_rounds=2, min_replicas=2, max_replicas=2,
                      background_refresh=False)
    try:
        base_before = fleet._base
        want = np.asarray(fleet.predict(X[:4]).value)
        a1 = pilot.step(_snapshot(psi=0.9))
        assert [a["action"] for a in a1] == ["refresh"]
        assert a1[0]["status"] == "failed"
        assert ctl.fired and ctl.fired[0][0] == "refresh_crash"
        assert ctl.fired[0][1].startswith("GBMRegressor:refresh_round:")
        assert fleet._base is base_before
        assert sorted(reg.names()) == ["prod", "v2"]
        resp = fleet.predict(X[:4])
        assert resp.version == 0
        np.testing.assert_array_equal(np.asarray(resp.value), want)
        assert not pilot.statusz()["refresh_inflight"]

        a2 = pilot.step(_snapshot(psi=0.9))
        assert [a["action"] for a in a2] == ["refresh"]
        assert a2[0]["status"] == "ok" and "prod@v1" in reg
        assert fleet.predict(X[:4]).version == 1
        assert pilot.statusz()["refresh_generation"] == 1
        full = st.GBMRegressor(num_base_learners=ROUNDS + 2, seed=0).fit(X, y, device="cpu")
        np.testing.assert_array_equal(fleet.predict(X[:8]).value, full.predict(X[:8]).numpy())
    finally:
        pilot.stop()
        fleet.stop()
        reg.close()


def _boosting_data():
    X, y = _data()
    yc = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.float32)
    yc[::7] = (yc[::7] + 1) % 3
    return X, yc


@pytest.mark.parametrize("family", ["gbm_cls", "samme", "drucker"])
def test_refresh_crash_sites_exist_only_on_refresh_fits(family):
    """The round loops of GBM and Boosting expose ``refresh_crash`` at
    ``<Family>:refresh_round:<i>`` only on a ``fit_resume`` (the JAX
    package's ``_is_refresh_fit``): a foreground fit under the same
    controller never fires."""
    X, y = _data()
    tree = st.DecisionTreeRegressor(max_depth=2)
    est = {
        "gbm_cls": lambda n: st.GBMClassifier(base_learner=tree, num_base_learners=n),
        "samme": lambda n: st.BoostingClassifier(
            base_learner=st.DecisionTreeClassifier(max_depth=2), num_base_learners=n),
        "drucker": lambda n: st.BoostingRegressor(base_learner=tree, num_base_learners=n),
    }[family]
    if family != "drucker":
        X, y = _boosting_data()
    ctl = ChaosController(seed=0, rate=1.0, faults=("refresh_crash",))
    install(ctl)
    short = est(2).fit(X, y, device="cpu")
    assert ctl.fired == [] and not est(2)._is_refresh_fit
    with pytest.raises(st.ChaosPreemption):
        short.fit_resume(X, y, 2)
    assert len(ctl.fired) == 1 and ":refresh_round:" in ctl.fired[0][1]
    resumed = short.fit_resume(X, y, 2)  # the site fires at most once
    full = est(4).fit(X, y, device="cpu")
    assert torch.equal(resumed.predict(X), full.predict(X))


# ---------------------------------------------------------------------------
# registry: remove() racing a live pin lease defers like _offload
# ---------------------------------------------------------------------------


def test_registry_remove_defers_until_pins_release(fitted):
    X, y, v1, v2 = fitted
    with ModelRegistry(capacity=4, min_bucket=8, max_batch_size=16) as reg:
        reg.register("a", v1)
        reg.register("b", v2)
        want = np.asarray(reg.predict("a", X[:4]))
        with reg.lease("a") as eng:
            reg.remove("a")
            st_ = reg.stats()["a"]
            assert st_["pending_remove"] and st_["pins"] == 1
            assert "a" in reg
            with pytest.raises(ValueError, match="already registered"):
                reg.register("a", v2)
            np.testing.assert_array_equal(np.asarray(eng.predict(X[:4])), want)
        assert "a" not in reg and len(reg) == 1

        want_b = np.asarray(reg.predict("b", X[:4]))
        fut = reg.submit("b", X[:4])
        reg.remove("b")
        np.testing.assert_array_equal(np.asarray(fut.result(timeout=30)), want_b)
        deadline = time.time() + 10.0
        while "b" in reg and time.time() < deadline:
            time.sleep(0.005)
        assert "b" not in reg and len(reg) == 0


def test_registry_remove_unpinned_is_immediate(fitted):
    X, y, v1, _ = fitted
    with ModelRegistry(capacity=2, min_bucket=8, max_batch_size=16) as reg:
        reg.register("a", v1, warm=True)
        reg.remove("a")
        assert "a" not in reg and len(reg) == 0
        with pytest.raises(KeyError):
            reg.engine("a")


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _dyadic_data(n=96, d=5, seed=0):
    X, y = _data(n, d, seed)
    return X, (np.round(y * 16) / 16).astype(np.float32)


SEQUENCE = [
    _snapshot(),
    _snapshot(p99=9999.0),
    _snapshot(hedge=0.9),
    _snapshot(psi=0.9),
    _snapshot(div=0.9),
    _snapshot(),
    _snapshot(),
    _snapshot(p99=9999.0, psi=0.9),
    _snapshot(),
    _snapshot(),
    _snapshot(),
]

#: the keys of an action record that must be equal between the packages
#: (flows are random ids, swap_ms a wall time)
_EQUAL_KEYS = ("action", "trigger", "status", "model", "members", "new_rounds",
               "target", "replicas", "queue_depth", "value", "threshold",
               "swap_version", "swap_model", "swap_replicas", "swap_compiles",
               "swap_crashes")


def _run(pkg, X, y, models, refresh_rounds=2):
    """One package's closed loop over SEQUENCE: the action records, the
    statusz, and predictions of every registered version."""
    if pkg == "jax":
        Reg, Fleet, Pilot, Dog, rules = (JaxRegistry, JaxFleet, JaxAutopilot,
                                         JaxWatchdog, jax_default_rules)
    else:
        Reg, Fleet, Pilot, Dog, rules = (ModelRegistry, FleetRouter, Autopilot,
                                         Watchdog, default_rules)
    reg = Reg(capacity=4, min_bucket=8, max_batch_size=16)
    reg.register("prod", models[0], warm=True)
    reg.register("v2", models[1], warm=True)
    fleet = Fleet.from_registry(reg, "prod", replicas=2, deadline_ms=30_000.0)
    pilot = Pilot(fleet, Dog(rules=rules(breach_for=1, clear_for=1), interval_s=3600.0),
                  refresh_data=lambda: (X, y), refresh_rounds=refresh_rounds,
                  min_replicas=2, max_replicas=3, calm_ticks=2,
                  background_refresh=False)
    try:
        steps = [[{k: a[k] for k in _EQUAL_KEYS if k in a} for a in pilot.step(s)]
                 for s in SEQUENCE]
        preds = {name: np.asarray(reg.predict(name, X)) for name in sorted(reg.names())}
        status = {k: v for k, v in pilot.statusz().items() if k != "actions"}
        return steps, status, preds, fleet.slo_snapshot()["version"]
    finally:
        pilot.stop()
        fleet.stop()
        reg.close()


def test_autopilot_actions_and_refresh_equal_the_jax_autopilot():
    X, y = _dyadic_data()
    jm = [se.GBMRegressor(num_base_learners=n, seed=0).fit(X, y) for n in (ROUNDS, 2)]
    tm = [st.GBMRegressor(num_base_learners=n, seed=0).fit(X, y, device="cpu")
          for n in (ROUNDS, 2)]
    install(ChaosController(seed=0, rate=0.0))
    jax_install(JaxChaos(seed=0, rate=0.0))
    try:
        ours = _run("torch", X, y, tm)
        theirs = _run("jax", X, y, jm)
    finally:
        jax_install(None)
    steps, status, preds, version = ours
    jsteps, jstatus, jpreds, jversion = theirs
    assert steps == jsteps
    # the hedge alert and the second p99 alert fall inside the scale
    # cooldown (calm_ticks), so they take no action
    assert [a["action"] for s in steps for a in s] == [
        "scale_up", "refresh", "rollback", "scale_down", "refresh"]
    assert status == jstatus and version == jversion
    assert sorted(preds) == sorted(jpreds) == ["prod", "prod@v1", "prod@v2", "v2"]
    for name in preds:
        np.testing.assert_allclose(preds[name], jpreds[name], rtol=1e-5, atol=1e-6)
    # each refresh equals the port's own uninterrupted longer fit, bit for bit
    full = st.GBMRegressor(num_base_learners=ROUNDS + 2, seed=0).fit(X, y, device="cpu")
    np.testing.assert_array_equal(preds["prod@v1"], full.predict(X).numpy())
    np.testing.assert_array_equal(preds["prod@v2"], full.predict(X).numpy())
