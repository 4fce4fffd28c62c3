"""The port's model registry (``spark_ensemble_tpu_torch/serving/
registry.py``), case for case with ``tests/test_serving.py``'s registry
cases and ``tests/test_fleet.py``'s pin-until-reply cases, on the CPU.

Eviction releases the engine (its graphs, static buffers and live models,
shared with every clone) and offloads the packed arrays; re-activation
re-warms and predicts BIT-identically (the same packed tensors, the same
model code).  Against the JAX registry: the ``stats()`` keys and the
``model_evicted`` event keys are EQUAL.  On the card ``chip_smoke.py``'s
``fleet`` phase holds ``torch.cuda.memory_allocated()`` falling by at
least the evicted entry's packed bytes."""

import time

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.serving import ModelRegistry as JaxRegistry
from spark_ensemble_tpu.telemetry import record_fits as jax_record_fits
from spark_ensemble_tpu_torch.serving import FleetRouter, ModelRegistry, pack
from spark_ensemble_tpu_torch.telemetry import record_fits


def _data(n=96, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    X, y = _data()
    yc = (y > np.median(y)).astype(np.float32)
    models = {
        "gbm_reg": st.GBMRegressor(num_base_learners=3).fit(X, y, device="cpu"),
        "gbm_reg2": st.GBMRegressor(num_base_learners=2, seed=1).fit(X, y, device="cpu"),
        "boosting_reg": st.BoostingRegressor(num_base_learners=3).fit(X, y, device="cpu"),
        "stacking_clf": st.StackingClassifier().fit(X, yc, device="cpu"),
    }
    return X, models


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# LRU device residency (tests/test_serving.py)
# ---------------------------------------------------------------------------


def test_registry_lru_evicts_and_reactivates(fitted):
    X, models = fitted
    with record_fits() as rec:
        with ModelRegistry(capacity=1, max_batch_size=128) as reg:
            reg.register("g", models["gbm_reg"])
            reg.register("b", models["boosting_reg"])
            assert sorted(reg.names()) == ["b", "g"]
            assert "g" in reg and len(reg) == 2
            want_g = reg.predict("g", X)
            assert reg.stats()["g"]["resident"]
            reg.predict("b", X)  # activates b -> evicts g (capacity 1)
            stats = reg.stats()
            assert stats["b"]["resident"] and not stats["g"]["resident"]
            again = reg.predict("g", X)
            assert np.array_equal(again, want_g)
            np.testing.assert_array_equal(again, _np(models["gbm_reg"].predict(X)))
            assert reg.stats()["g"]["activations"] == 2
    evicted = [e for e in rec.events if e["event"] == "model_evicted"]
    assert [e["model"] for e in evicted] == ["g", "b"]
    assert all(e["bytes_freed"] > 0 for e in evicted)


def test_registry_explicit_evict_remove_and_errors(fitted):
    X, models = fitted
    reg = ModelRegistry(capacity=2, max_batch_size=64)
    with pytest.raises(ValueError, match="capacity"):
        ModelRegistry(capacity=0)
    reg.register("m", models["stacking_clf"].pack())
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m", models["stacking_clf"])
    with pytest.raises(KeyError, match="no model"):
        reg.engine("missing")
    reg.predict("m", X)
    reg.evict("m")
    assert not reg.stats()["m"]["resident"]
    reg.remove("m")
    assert "m" not in reg
    reg.close()


def test_eviction_releases_the_engine_and_offloads(fitted):
    """The evicted engine (and a clone of it) drops its programs and live
    models, so nothing holds the packed tensors; the packed arrays are on
    the host; serving through the stale engine raises."""
    X, models = fitted
    with ModelRegistry(capacity=1, min_bucket=8, max_batch_size=16) as reg:
        reg.register("g", models["gbm_reg"], warm=True)
        eng = reg.engine("g")
        clone = eng.clone("g-clone")
        assert eng.stats()["compiled"]
        packed = reg._entries["g"].packed
        reg.register("h", models["gbm_reg2"], warm=True)  # evicts g
        assert not reg.stats()["g"]["resident"]
        assert eng._compiled == {} and eng._models == {}
        assert clone._compiled == {} and clone._models == {}
        assert packed._model is None
        assert all(t.device.type == "cpu" for t in packed._arrays.values())
        with pytest.raises(RuntimeError, match="released"):
            eng.predict(X[:4])
        with pytest.raises(RuntimeError, match="released"):
            clone.predict(X[:4])
        np.testing.assert_array_equal(reg.predict("g", X[:7]),
                                      _np(models["gbm_reg"].predict(X[:7])))


def test_entries_keep_the_model_device(fitted):
    X, models = fitted
    with ModelRegistry(capacity=2, min_bucket=8, max_batch_size=16) as reg:
        reg.register("g", models["gbm_reg"], warm=True)
        assert reg._entries["g"].packed.device == torch.device("cpu")
        assert reg.engine("g").packed.device == torch.device("cpu")


def test_stats_and_event_keys_equal_the_jax_registry(fitted, tmp_path):
    X, models = fitted
    jX, jy = _data()
    jm = se.GBMRegressor(num_base_learners=2).fit(jX, jy)
    with record_fits() as rec:
        with ModelRegistry(capacity=1, min_bucket=8, max_batch_size=16) as reg:
            reg.register("a", models["gbm_reg"])
            reg.register("b", models["gbm_reg2"])
            reg.predict("a", X[:4])
            reg.predict("b", X[:4])
            ours = reg.stats()
    with jax_record_fits() as jrec:
        with JaxRegistry(capacity=1, min_bucket=8, max_batch_size=16) as jreg:
            jreg.register("a", jm)
            jreg.register("b", jm.pack())
            jreg.predict("a", jX[:4])
            jreg.predict("b", jX[:4])
            theirs = jreg.stats()
    assert set(ours) == set(theirs)
    for name in ours:
        assert set(ours[name]) == set(theirs[name])
        assert ours[name]["resident"] == theirs[name]["resident"]
        assert ours[name]["activations"] == theirs[name]["activations"]

    def keyset(events, kind):
        return {frozenset(e) - {"ts"} for e in events if e["event"] == kind}

    assert keyset(rec.events, "model_evicted") == keyset(jrec.events, "model_evicted")


# ---------------------------------------------------------------------------
# pin-until-reply (tests/test_fleet.py)
# ---------------------------------------------------------------------------


def test_registry_pin_defers_eviction_until_release(fitted):
    X, models = fitted
    with ModelRegistry(capacity=1, min_bucket=8, max_batch_size=16) as reg:
        reg.register("g", models["gbm_reg"])
        reg.register("h", models["gbm_reg2"])
        want = np.asarray(reg.predict("g", X[:4]))
        with reg.lease("g") as eng:
            reg.engine("h")  # over capacity: would evict g, but it's pinned
            st_ = reg.stats()["g"]
            assert st_["resident"] and st_["pins"] == 1
            np.testing.assert_array_equal(np.asarray(eng.predict(X[:4])), want)
        st_ = reg.stats()["g"]
        assert st_["pins"] == 0 and not st_["resident"]

        reg.engine("g")  # reactivate (evicts h)
        fut = reg.submit("g", X[:4])
        reg.engine("h")  # races the queued request
        np.testing.assert_array_equal(np.asarray(fut.result(timeout=30)), want)
        deadline = time.time() + 10.0
        while reg.stats()["g"]["pins"] > 0 and time.time() < deadline:
            time.sleep(0.005)
        st_ = reg.stats()["g"]
        assert st_["pins"] == 0 and not st_["resident"]


def test_fleet_from_registry_pins_until_stop(fitted):
    X, models = fitted
    with ModelRegistry(capacity=1, min_bucket=8, max_batch_size=16) as reg:
        reg.register("g", models["gbm_reg"])
        reg.register("h", models["gbm_reg2"])
        fleet = FleetRouter.from_registry(reg, "g", replicas=2, deadline_ms=30_000.0)
        try:
            want = fleet.predict(X[:4]).value
            reg.engine("h")  # g stays pinned under the fleet
            st_ = reg.stats()["g"]
            assert st_["resident"] and st_["pins"] == 1
            resp = fleet.predict(X[:4])
            np.testing.assert_array_equal(np.asarray(resp.value), np.asarray(want))
            np.testing.assert_array_equal(resp.value, _np(models["gbm_reg"].predict(X[:4])))
        finally:
            fleet.stop()
        st_ = reg.stats()["g"]
        assert st_["pins"] == 0 and not st_["resident"]


def test_registry_predict_equals_the_jax_registry_on_one_artifact(fitted, tmp_path):
    """Both registries over one JAX-written artifact: within the engine
    contract (rtol 1e-5, atol 1e-6); the port's equals its own model bit
    for bit."""
    from spark_ensemble_tpu.serving import load_packed as jax_load_packed
    from spark_ensemble_tpu_torch.serving import load_packed

    X, y = _data()
    jm = se.GBMRegressor(num_base_learners=3).fit(X, y)
    path = str(tmp_path / "art")
    jm.pack().save(path)
    ours_packed = load_packed(path, device="cpu")
    with ModelRegistry(capacity=1, min_bucket=8, max_batch_size=16) as reg, \
            JaxRegistry(capacity=1, min_bucket=8, max_batch_size=16) as jreg:
        reg.register("m", ours_packed)
        jreg.register("m", jax_load_packed(path))
        for n in (1, 5, 16, 40):
            a, b = reg.predict("m", X[:n]), np.asarray(jreg.predict("m", X[:n]))
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(a, pack(ours_packed.model()).predict(X[:n]).numpy())
