"""The port's serving engine (``spark_ensemble_tpu_torch/serving/engine.py``)
against its own model and the JAX package's engine.

On the CPU the engine runs its padded-bucket path eagerly (a CUDA graph per
bucket is the card's path, which ``chip_smoke.py`` drives).  Tolerances:
the engine's outputs are the port model's own, BIT-identical on the CPU
(the GBM models sum their rounds by a reduction whose order does not
depend on the batch, so a request padded into a bucket predicts as it
does alone).  Against the JAX engine over the same artifact the contract
is the JAX engine's own: rtol 1e-5, atol 1e-6 (tests/test_serving.py).
Drift windows and event schemas are discrete: equal.
"""

import json

import numpy as np
import pytest

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.serving import InferenceEngine as JaxEngine
from spark_ensemble_tpu.serving import engine as jax_engine_mod
from spark_ensemble_tpu.serving import load_packed as jax_load_packed
from spark_ensemble_tpu.telemetry import record_fits as jax_record_fits
from spark_ensemble_tpu_torch.serving import InferenceEngine, load_packed, pack
from spark_ensemble_tpu_torch.serving import engine as engine_mod
from spark_ensemble_tpu_torch.telemetry import record_fits


def _data(n=300, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _tree():
    return st.DecisionTreeRegressor(max_depth=3, max_bins=16)


@pytest.fixture(scope="module")
def models():
    X, y = _data()
    yc = np.digitize(y, [-1.0, 0.5]).astype(np.float32)
    return X, {
        "gbm_reg": st.GBMRegressor(base_learner=_tree(), num_base_learners=5).fit(
            X, y, device="cpu"),
        "gbm_cls": st.GBMClassifier(base_learner=_tree(), num_base_learners=4).fit(
            X, yc, device="cpu"),
    }


@pytest.mark.parametrize("lo,hi", [(8, 4096), (1, 1), (5, 100), (16, 16)])
def test_buckets_equal_the_jax_package(lo, hi):
    assert engine_mod._pow2_buckets(lo, hi) == jax_engine_mod._pow2_buckets(lo, hi)


@pytest.mark.parametrize("name,method", [("gbm_reg", "predict"),
                                         ("gbm_cls", "predict_proba"),
                                         ("gbm_cls", "predict")])
def test_outputs_bit_identical_to_the_model(models, name, method):
    X, ms = models
    m = ms[name]
    with InferenceEngine(m, methods=(method,), max_batch_size=64) as eng:
        for n in (1, 3, 8, 17, 77, 96, 300):  # 77 and up: chunked, oversized
            out = eng.predict(X[:n], method=method)
            np.testing.assert_array_equal(out, getattr(m, method)(X[:n]).numpy())
        single = eng.predict(X[0], method=method)
        np.testing.assert_array_equal(single, getattr(m, method)(X[:1]).numpy()[0])


@pytest.mark.parametrize("name,method", [("gbm_reg", "predict"),
                                         ("gbm_cls", "predict_proba")])
def test_outputs_match_the_jax_engine(models, tmp_path, name, method):
    """Both engines over the same port-written artifact."""
    X, ms = models
    path = str(tmp_path / "art")
    pack(ms[name]).save(path)
    kw = dict(methods=(method,), max_batch_size=128)
    with InferenceEngine(load_packed(path, device="cpu"), **kw) as ours, \
            JaxEngine(jax_load_packed(path), **kw) as theirs:
        for n in (1, 3, 8, 17, 77, 96, 200):
            np.testing.assert_allclose(ours.predict(X[:n], method=method),
                                       theirs.predict(X[:n], method=method),
                                       rtol=1e-5, atol=1e-6)


def test_unwarmed_method_tier_and_bad_shape_raise(models):
    X, ms = models
    with InferenceEngine(ms["gbm_reg"], max_batch_size=16) as eng:
        with pytest.raises(ValueError, match="not configured"):
            eng.predict(X[:4], method="predict_raw")
        with pytest.raises(ValueError, match="prefix tier"):
            eng.predict(X[:4], tier=2)
        with pytest.raises(ValueError, match="num_features"):
            eng.predict(X[:4, :3])
    bag = st.BaggingRegressor(num_base_learners=2, base_learner=_tree()).fit(
        X, X[:, 0], device="cpu")  # no drift reference
    with pytest.raises(ValueError, match="drift=True"):
        InferenceEngine(bag, drift=True, warm=False)


def test_queue_coalesces_and_resolves_every_future(models):
    X, ms = models
    m = ms["gbm_reg"]
    want = m.predict(X).numpy()
    with record_fits() as rec:
        with InferenceEngine(m, max_batch_size=64, max_delay_ms=50.0) as eng:
            futs = [eng.submit(X[i:i + 3]) for i in range(0, 90, 3)]
            got = [f.result(timeout=30) for f in futs]
            assert eng.stats()["compiles_since_warmup"] == 0
    for i, g in zip(range(0, 90, 3), got):
        np.testing.assert_array_equal(g, want[i:i + 3])
    served = [e for e in rec.events if e["event"] == "request_served"]
    assert len(served) == 30 and all(e["source"] == "queue" for e in served)
    assert max(e["queue_depth"] for e in served) > 1  # requests coalesced


def test_no_captures_after_warmup_and_stats_keys_equal_the_jax_engine(models, tmp_path):
    X, ms = models
    path = str(tmp_path / "art")
    pack(ms["gbm_cls"]).save(path)
    kw = dict(methods=("predict", "predict_proba"), max_batch_size=32,
              prefix_tiers=(2,))
    with InferenceEngine(load_packed(path, device="cpu"), **kw) as ours, \
            JaxEngine(jax_load_packed(path), **kw) as theirs:
        for n in (1, 5, 31, 70):
            ours.predict(X[:n])
            ours.predict(X[:n], method="predict_proba", tier=2)
        a, b = ours.stats(), theirs.stats()
    assert sorted(a) == sorted(b)
    assert a["compiles_since_warmup"] == 0 and a["buckets"] == b["buckets"]
    assert sorted(a["compiled"]) == sorted(b["compiled"])
    assert sorted(a["drift"]) == sorted(b["drift"])
    assert a["donate"] is False  # the CPU path


def test_drift_windows_do_not_depend_on_request_cuts(models):
    """The same rows cut into different requests, served through different
    buckets and in another order within each window: identical window
    scores (exact integer sketches, pad rows subtracted)."""
    X, ms = models
    m = ms["gbm_reg"]
    histories = []
    rng = np.random.RandomState(0)
    for cuts, max_batch, shuffle in (
            ([100, 100, 100], 64, False),
            ([1] * 20 + [80, 100, 60, 40], 32, False),
            ([7, 64, 29, 13, 87, 100], 128, True),
            ([33, 33, 34, 50, 50, 99, 1], 8, True)):
        order = np.arange(300)
        if shuffle:  # permute the rows within each 100-row window
            order = np.concatenate([lo + rng.permutation(100) for lo in (0, 100, 200)])
        with InferenceEngine(m, max_batch_size=max_batch, drift_window=100) as eng:
            lo = 0
            for c in cuts:
                eng.predict(X[order[lo:lo + c]])
                lo += c
            histories.append((eng.stats()["drift"],
                              eng.drift_monitor.feature_psi().tolist()))
    assert all(h == histories[0] for h in histories[1:])
    assert histories[0][0]["windows"] == 3 and histories[0][0]["rows_total"] == 300


def test_tiers_equal_take(models):
    X, ms = models
    m = ms["gbm_cls"]
    with InferenceEngine(m, methods=("predict_proba",), prefix_tiers=(1, 3),
                         max_batch_size=32) as eng:
        for k in (1, 3):
            np.testing.assert_array_equal(
                eng.predict(X[:50], method="predict_proba", tier=k),
                m.take(k).predict_proba(X[:50]).numpy())


def test_serving_event_key_sets_equal_the_jax_engine(models, tmp_path):
    """The same artifact, the same requests: each serving event type (and
    each span) carries the JAX engine's keys."""
    X, ms = models
    path = str(tmp_path / "art")
    pack(ms["gbm_reg"]).save(path)

    def keys(events):
        out = {}
        for e in events:
            tag = e["event"] if e["event"] != "span" else f"span:{e['name']}"
            out.setdefault(tag, set()).update(e)
        return out

    kw = dict(max_batch_size=16, prefix_tiers=(2,), drift_window=20)
    with record_fits() as rec:
        with InferenceEngine(load_packed(path, device="cpu"), **kw) as eng:
            eng.predict(X[:40])
            eng.submit(X[:3]).result(timeout=30)
            pack(eng.packed.model())
    with jax_record_fits() as jrec:
        with JaxEngine(jax_load_packed(path), **kw) as eng:
            eng.predict(X[:40])
            eng.submit(X[:3]).result(timeout=30)
            from spark_ensemble_tpu.serving import pack as jax_pack

            jax_pack(eng.packed.model())
    ours, theirs = keys(rec.events), keys(jrec.events)
    assert set(ours) == set(theirs) >= {"engine_warmup", "request_served",
                                        "drift_window", "model_packed",
                                        "span:engine_warmup"}
    assert ours == theirs


def test_engine_streams_to_its_telemetry_path(models, tmp_path):
    X, ms = models
    path = str(tmp_path / "serve.jsonl")
    with InferenceEngine(ms["gbm_reg"], max_batch_size=16, telemetry_path=path) as eng:
        eng.predict(X[:20])
    with open(path) as f:
        kinds = [json.loads(line)["event"] for line in f]
    assert kinds.count("engine_warmup") == 2 and kinds.count("request_served") == 1
