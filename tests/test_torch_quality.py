"""The port's model-quality plane (``spark_ensemble_tpu_torch/telemetry/
quality.py``, ``ops/binning.bin_occupancy``) against the JAX package's:
the sketch math, the device occupancy count and the fit-time drift
reference, the ``quality`` sidecar across both packages' artifacts, the
``DriftMonitor`` window state machine, and staged attribution.

Tolerances: the sketch math is the same float32 numpy on both sides, and
counts are integers, so everything here is EQUAL (``assert_array_equal``
or ``==``), apart from the staged-attribution margins of a regressor,
which compare predictions each package sums in its own order: within
1e-5.
"""

import json

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.ops.binning import Bins as JaxBins
from spark_ensemble_tpu.ops.binning import bin_occupancy as jax_bin_occupancy
from spark_ensemble_tpu.serving import InferenceEngine as JaxEngine
from spark_ensemble_tpu.serving import load_packed as jax_load_packed
from spark_ensemble_tpu.serving import pack as jax_pack
from spark_ensemble_tpu.telemetry import quality as jq
from spark_ensemble_tpu_torch.ops.binning import bin_occupancy, compute_bins
from spark_ensemble_tpu_torch.serving import InferenceEngine, load_packed, pack
from spark_ensemble_tpu_torch.telemetry import quality as tq


def _data(n=256, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _tree(pkg):
    return pkg.DecisionTreeRegressor(max_depth=3, max_bins=16)


@pytest.fixture(scope="module")
def fitted():
    X, y = _data()
    kw = dict(num_base_learners=4, seed=0)
    return (X, y, se.GBMRegressor(base_learner=_tree(se), **kw).fit(X, y),
            st.GBMRegressor(base_learner=_tree(st), **kw).fit(X, y, device="cpu"))


# ---------------------------------------------------------------------------
# sketch math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_math_equals_the_jax_package(seed):
    rng = np.random.RandomState(seed)
    ref = rng.randint(0, 50, size=(5, 32))
    obs = rng.randint(0, 50, size=(5, 32))
    for fn in ("histogram_distribution",):
        np.testing.assert_array_equal(getattr(tq, fn)(ref), getattr(jq, fn)(ref))
    np.testing.assert_array_equal(tq.psi(ref, obs), jq.psi(ref, obs))
    np.testing.assert_array_equal(tq.kl_divergence(ref, obs), jq.kl_divergence(ref, obs))
    np.testing.assert_array_equal(tq.psi(ref[0], obs[0], smoothing=0.5),
                                  jq.psi(ref[0], obs[0], smoothing=0.5))
    for groups in (1, 7, 16, 40):
        np.testing.assert_array_equal(tq.coarsen_counts(ref, groups),
                                      jq.coarsen_counts(ref, groups))
    a, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    assert tq.prediction_divergence(a, b, False) == jq.prediction_divergence(a, b, False)
    la, lb = (a > 0).astype(np.float32), (b > 0).astype(np.float32)
    assert tq.prediction_divergence(la, lb, True) == jq.prediction_divergence(la, lb, True)


@pytest.mark.parametrize("n,max_bins", [(1, 8), (97, 16), (600, 64)])
def test_bin_occupancy_equals_the_jax_package(n, max_bins):
    rng = np.random.RandomState(n)
    X = rng.randn(n, 5).astype(np.float32)
    X[:, 2] = np.round(X[:, 2])  # ties onto thresholds
    bins = compute_bins(torch.as_tensor(X), max_bins)
    ours = bin_occupancy(torch.as_tensor(X), bins)
    theirs = jax_bin_occupancy(X, JaxBins(thresholds=bins.thresholds.numpy()))
    assert ours.dtype == torch.int32 and ours.shape == (5, max_bins)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # exact integers: any split of the rows sums to the whole
    if n > 1:
        parts = bin_occupancy(torch.as_tensor(X[: n // 3]), bins) + bin_occupancy(
            torch.as_tensor(X[n // 3:]), bins)
        assert torch.equal(parts, ours)


@pytest.mark.parametrize("cls", ["GBMRegressor", "GBMClassifier"])
def test_drift_reference_equals_the_jax_package(cls):
    X, y = _data()
    if cls == "GBMClassifier":
        y = (y > 0).astype(np.float32)
    jm = getattr(se, cls)(base_learner=_tree(se), num_base_learners=2).fit(X, y)
    tm = getattr(st, cls)(base_learner=_tree(st), num_base_learners=2).fit(X, y, device="cpu")
    for key in ("thresholds", "occupancy"):
        np.testing.assert_array_equal(tm.drift_ref_[key], jm.drift_ref_[key])
    assert tm.drift_ref_["rows"] == jm.drift_ref_["rows"] == len(y)
    assert tm.drift_ref_["occupancy"].sum(axis=1).tolist() == [len(y)] * X.shape[1]


def test_sweep_models_carry_the_drift_reference():
    X, y = _data()
    ests = [st.GBMRegressor(base_learner=_tree(st), num_base_learners=2, learning_rate=lr)
            for lr in (0.1, 0.3)]
    models = st.fit_sweep(ests, X, y, device="cpu")
    ref = st.GBMRegressor(base_learner=_tree(st), num_base_learners=2).fit(
        X, y, device="cpu").drift_ref_
    for m in models:
        np.testing.assert_array_equal(m.drift_ref_["occupancy"], ref["occupancy"])
        assert all(len(v) == 0 for v in m.fit_history_.values())


# ---------------------------------------------------------------------------
# the sidecar across both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_sidecar_crosses_both_ways(fitted, tmp_path, direction):
    X, _, jm, tm = fitted
    path = str(tmp_path / "art")
    if direction == "port_to_jax":
        pack(tm).save(path)
        src, dst = pack(tm).quality, jax_load_packed(path).quality
    else:
        jax_pack(jm).save(path)
        src, dst = jax_pack(jm).quality, load_packed(path, device="cpu").quality
    for key in ("thresholds", "occupancy", "rows"):
        np.testing.assert_array_equal(np.asarray(dst[key]), np.asarray(src[key]))
    np.testing.assert_array_equal(pack(tm).quality["occupancy"],
                                  jax_pack(jm).quality["occupancy"])


# ---------------------------------------------------------------------------
# DriftMonitor
# ---------------------------------------------------------------------------


def _monitors(tmp_path, **kw):
    thr = np.array([[-1.0, 0.0, 1.0], [-0.5, 0.5, 2.0]], np.float32)
    ref = np.array([[100, 100, 100, 100], [50, 150, 150, 50]], np.int64)
    kw.setdefault("window_rows", 40)
    kw.setdefault("score_groups", 4)
    out = []
    for mod, name in ((tq, "port"), (jq, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        out.append((mod.DriftMonitor(thr, ref, telemetry_path=path,
                                     stream="quality-test", **kw), path))
    return out


def test_drift_monitor_windows_equal_the_jax_monitor(tmp_path):
    """The same counts (pad rows included) through both monitors: the same
    windows, scores and alert raise/clear transitions."""
    (ours, p_ours), (theirs, p_theirs) = _monitors(tmp_path)
    uniform = np.array([[10, 10, 10, 10], [5, 15, 15, 5]])
    padded = uniform.copy()
    padded[0, 1] += 24  # zero bin of feature 0
    padded[1, 1] += 24  # zero bin of feature 1
    shifted = np.array([[0, 0, 0, 40], [0, 0, 0, 40]])
    feed = [(uniform, 0), (padded, 24), (shifted, 0), (shifted, 0),
            (uniform, 0), (np.array([[3, 3, 3, 3], [1, 5, 5, 1]]), 0)]
    try:
        for counts, pad in feed:
            ours.observe(counts, pad_rows=pad)
            theirs.observe(counts, pad_rows=pad)
        assert ours.snapshot() == theirs.snapshot()
        np.testing.assert_array_equal(ours.feature_psi(), theirs.feature_psi())
    finally:
        ours.close()
        theirs.close()

    def stream(path):
        with open(path) as f:
            evs = [json.loads(line) for line in f]
        for e in evs:
            e.pop("ts")
        return evs

    evs = stream(p_ours)
    assert evs == stream(p_theirs)
    windows = [e for e in evs if e["event"] == "drift_window"]
    alerts = [e for e in evs if e["event"] == "quality_alert"]
    assert [w["window"] for w in windows] == [1, 2, 3, 4, 5]
    assert windows[1]["psi_max"] == windows[0]["psi_max"]  # pads subtracted
    assert [a["state"] for a in alerts] == ["raised", "cleared"]


def test_drift_monitor_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="occupancy"):
        tq.DriftMonitor(np.zeros((2, 3), np.float32), np.zeros((2, 3)))
    mon = tq.DriftMonitor(np.zeros((1, 3), np.float32), np.ones((1, 4)))
    try:
        with pytest.raises(ValueError, match="histogram"):
            mon.observe(np.zeros((2, 4)))
    finally:
        mon.close()


# ---------------------------------------------------------------------------
# staged attribution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_staged_attribution_equals_the_jax_package(tmp_path, kind):
    """A JAX model converted through its artifact: both packages' engines
    serve it with the same prefix tiers, and the attributions agree."""
    X, y = _data()
    if kind == "classifier":
        y = (y > 0).astype(np.float32)
        jm = se.GBMClassifier(base_learner=_tree(se), num_base_learners=4).fit(X, y)
    else:
        jm = se.GBMRegressor(base_learner=_tree(se), num_base_learners=4).fit(X, y)
    path = str(tmp_path / "art")
    jax_pack(jm).save(path)
    kw = dict(methods=("predict",), prefix_tiers=(1, 2), min_bucket=8,
              max_batch_size=32)
    ours = InferenceEngine(load_packed(path, device="cpu"), **kw)
    theirs = JaxEngine(jax_load_packed(path), **kw)
    try:
        a = tq.staged_attribution(ours, X[:40])
        b = jq.staged_attribution(theirs, X[:40])
    finally:
        ours.stop()
        theirs.stop()
    assert a["tiers"] == b["tiers"] == [1, 2]
    if kind == "classifier":
        assert a == b
    else:
        for k in ("1", "2"):
            np.testing.assert_allclose(a["margins"][k], b["margins"][k], rtol=1e-5)
        assert a["flagged"] == b["flagged"]
