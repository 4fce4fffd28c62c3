"""The port's streaming fits (``spark_ensemble_tpu_torch/data/streaming.py``,
``GBMRegressor.fit_streaming`` / ``GBMClassifier.fit_streaming``), case for
case with tests/test_streaming.py, plus the cross-package check against
the JAX package's ``fit_streaming`` over the same store.

Tolerances:
- Port streaming vs port resident ``hist="stream"`` fits, at matched chunk
  rows: EQUAL (``torch.equal`` on every params tensor and prediction).
  Both run ``ops/tree.stream_forest`` over the same chunks, so they take
  the same f32 products on the same operands in the same order.
- A resumed streaming fit vs the uninterrupted one: EQUAL.
- Port vs JAX streaming: split tables array-equal after one round on
  tie-free dyadic fixtures (mirrored regression labels, a balanced
  uniform-init classifier: every f32 sum is exact in any order), leaves
  within 1e-6; after three rounds leaves within rtol 1e-5 and predictions
  within 1e-5 (probabilities) or 1e-5 of the label scale, where the two
  packages take their f32 sums in their own order.  The classifier runs
  fixed steps there: its K-dim step search has a flat valley in which
  the packages may pick different points of equal loss (ROADMAP queue 3).
"""

import json

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.data import ShardStore as JaxShardStore
from spark_ensemble_tpu_torch.autotune.resolve import override
from spark_ensemble_tpu_torch.data import write_shards
from spark_ensemble_tpu_torch.models.base import tree_leaves
from spark_ensemble_tpu_torch.robustness import chaos
from spark_ensemble_tpu_torch.robustness.chaos import ChaosController, ChaosPreemption

SPLITS = ("split_feature", "split_bin", "split_threshold")


def _data(n=157, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _cls_labels(X):
    return ((X[:, 0] + X[:, 1] > 0).astype(np.int32)
            + (X[:, 2] > 0.5).astype(np.int32)).astype(np.float32)


def _base(pkg=st, **kw):
    kw.setdefault("max_depth", 3)
    kw.setdefault("max_bins", 16)
    kw.setdefault("hist", "stream")
    return pkg.DecisionTreeRegressor(**kw)


def _store(tmp_path, X, shard_rows=64, max_bins=16):
    return write_shards(X, str(tmp_path / "store"), max_bins=max_bins,
                        shard_rows=shard_rows, device="cpu")


def _assert_equal_models(m1, m2):
    l1, l2 = tree_leaves(m1.params), tree_leaves(m2.params)
    assert len(l1) == len(l2)
    for a, b in zip(l1, l2):
        a, b = torch.as_tensor(a), torch.as_tensor(b)  # val_hist is numpy
        assert a.shape == b.shape and torch.equal(a, b)
    assert m1.num_members == m2.num_members


@pytest.fixture(autouse=True)
def _no_leaked_chaos():
    yield
    chaos.install(None)


class _FaultAt(ChaosController):
    """Fires ``preempt`` at one named site only."""

    def __init__(self, site):
        super().__init__(seed=0, rate=0.5, faults=("preempt",))
        self.site = site

    def _draw(self, fault, site):
        return 0.0 if site == self.site else 1.0


# ---------------------------------------------------------------------------
# bit identity with the resident stream tier, per family
# ---------------------------------------------------------------------------


def _reg_case(kw=None, validation=False):
    def run(tmp_path):
        X, y = _data()
        est = st.GBMRegressor(base_learner=_base(), **(kw or {}))
        store = _store(tmp_path, X)
        if not validation:
            return (est.fit(X, y, device="cpu"), est.fit_streaming(store, y, device="cpu"),
                    X)
        Xv, yv = _data(n=40, seed=9)
        vi = np.zeros(len(y) + len(yv), bool)
        vi[len(y):] = True
        res = est.fit(np.concatenate([X, Xv]), np.concatenate([y, yv]),
                      validation_indicator=vi, device="cpu")
        stm = est.fit_streaming(store, y, X_val=Xv, y_val=yv, device="cpu")
        np.testing.assert_array_equal(res.validation_history_, stm.validation_history_)
        return res, stm, X

    return run


def _cls_case(kw=None):
    def run(tmp_path):
        X, _ = _data(seed=1)
        y = _cls_labels(X)
        est = st.GBMClassifier(**{"base_learner": _base(), **(kw or {})})
        return (est.fit(X, y, device="cpu"),
                est.fit_streaming(_store(tmp_path, X), y, device="cpu"), X)

    return run


FAMILIES = {
    "regressor": _reg_case(dict(num_base_learners=5, seed=0)),
    "regressor_validation": _reg_case(dict(num_base_learners=6, seed=5), validation=True),
    "huber": _reg_case(dict(num_base_learners=3, seed=7, loss="huber")),
    "regressor_sampled": _reg_case(dict(num_base_learners=3, seed=2, subsample_ratio=0.7,
                                        subspace_ratio=0.6, sample_method="goss")),
    "classifier": _cls_case(dict(num_base_learners=4, seed=3)),
    "classifier_newton_default": _cls_case(dict(
        num_base_learners=3, seed=1, updates="newton",
        base_learner=_base(hist_precision="default"))),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_streaming_bit_identical_to_resident(tmp_path, family):
    with override(stream_chunk_rows=64, shard_rows=64):
        res, stm, X = FAMILIES[family](tmp_path)
    _assert_equal_models(res, stm)
    assert torch.equal(res.predict(X), stm.predict(X))
    if hasattr(res, "predict_proba"):
        assert torch.equal(res.predict_proba(X), stm.predict_proba(X))


def test_streaming_init_model_keeps_the_feature_count(tmp_path):
    """The init fit reads only the shape of a placeholder of the store's
    shape, so the model (init child included) is the resident one's."""
    X, y = _data()
    m = st.GBMRegressor(base_learner=_base(), num_base_learners=2).fit_streaming(
        _store(tmp_path, X), y, device="cpu")
    assert m.num_features == X.shape[1] and m.init_model.num_features == X.shape[1]


# ---------------------------------------------------------------------------
# against the JAX package's fit_streaming, over one store
# ---------------------------------------------------------------------------


def _mirrored(n=158, d=5, seed=11):
    """Dyadic regression labels in mirrored pairs: the mean is exactly 0,
    so every statistic of round 0 is exact in any summation order."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    h = rng.randint(-16, 17, size=n // 2).astype(np.float32) / 8.0
    y = np.concatenate([h, -h])[rng.permutation(n)]
    return X, y


def _balanced(n=160, d=5, k=4, seed=12):
    """Balanced labels for a uniform-init classifier: round 0's gradients
    are onehot - 1/k and their mean is exactly 0."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.repeat(np.arange(k), n // k)[rng.permutation(n)].astype(np.float32)
    return X, y


def _jax_fit(est, store_dir, y):
    return est.fit_streaming(JaxShardStore.open(store_dir), y)


@pytest.mark.parametrize("family", ["regressor", "classifier"])
def test_streaming_matches_the_reference(tmp_path, family):
    """One store, both packages' fit_streaming: round 0's split tables are
    array-equal on the dyadic fixture; after three rounds leaves agree to
    1e-6 and predictions to 1e-5."""
    if family == "regressor":
        X, y = _mirrored()
        kw = dict(learning_rate=0.5, seed=0)
        mk = lambda pkg, r: pkg.GBMRegressor(base_learner=_base(pkg), num_base_learners=r, **kw)
    else:
        X, y = _balanced()
        # fixed steps: the K-dim step search has a flat valley (the class
        # directions are dependent), where the packages may pick two points
        # of equal loss (ROADMAP queue 3)
        kw = dict(updates="gradient", init_strategy="uniform", seed=0,
                  optimized_weights=False, learning_rate=0.5)
        mk = lambda pkg, r: pkg.GBMClassifier(base_learner=_base(pkg), num_base_learners=r, **kw)
    store = _store(tmp_path, X)
    one_t = mk(st, 1).fit_streaming(store, y, device="cpu")
    one_j = _jax_fit(mk(se, 1), store.directory, y)
    tm, jm = one_t.params["members"], one_j.params["members"]
    for f in SPLITS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tm.leaf_value.numpy(), np.asarray(jm.leaf_value),
                               rtol=0, atol=1e-6)
    three_t = mk(st, 3).fit_streaming(store, y, device="cpu")
    three_j = _jax_fit(mk(se, 3), store.directory, y)
    np.testing.assert_allclose(three_t.params["members"].leaf_value.numpy(),
                               np.asarray(three_j.params["members"].leaf_value),
                               rtol=1e-5, atol=1e-6)
    if family == "regressor":
        np.testing.assert_allclose(three_t.predict(X).numpy(),
                                   np.asarray(three_j.predict(X)),
                                   rtol=0, atol=1e-5 * float(np.abs(y).max()))
    else:
        np.testing.assert_allclose(three_t.predict_proba(X).numpy(),
                                   np.asarray(three_j.predict_proba(X)), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------


def _ck_est(ckdir):
    return st.GBMRegressor(
        base_learner=_base(max_depth=2), num_base_learners=6, seed=0,
        scan_chunk=2, checkpoint_dir=ckdir, checkpoint_interval=1,
    )


@pytest.mark.parametrize("site", ["GBMRegressor:stream_round:2:level:1:shard:1",
                                  "GBMRegressor:stream_round:3:leaf:shard:2"])
def test_streaming_kill_and_resume_mid_shard(tmp_path, site):
    """A preemption between two shards of a sweep, after rounds were
    checkpointed: the refit resumes from the last round boundary and lands
    on the uninterrupted fit, bit for bit."""
    X, y = _data()
    with override(stream_chunk_rows=64, shard_rows=64):
        store = _store(tmp_path, X)
        ref = _ck_est(None).fit_streaming(store, y, device="cpu")
        ckdir = str(tmp_path / "ck")
        ctl = _FaultAt(site)
        chaos.install(ctl)
        with pytest.raises(ChaosPreemption):
            _ck_est(ckdir).fit_streaming(store, y, device="cpu")
        assert ctl.fired == [("preempt", site)]
        # ctl stays installed (spent) through the resume: the killed fit's
        # checkpoint writer may still resolve the controller
        m = _ck_est(ckdir).fit_streaming(store, y, device="cpu")
    _assert_equal_models(ref, m)


def test_streaming_resumes_a_resident_checkpoint(tmp_path):
    """Streaming and resident fits share checkpoint identity: a resident
    fit killed after round 1 resumes as a streaming fit and lands on the
    resident model."""
    X, y = _data()
    with override(stream_chunk_rows=64, shard_rows=64):
        store = _store(tmp_path, X)
        ref = _ck_est(None).fit(X, y, device="cpu")
        ckdir = str(tmp_path / "ck")
        chaos.install(_FaultAt("GBMRegressor:after_round:2"))
        with pytest.raises(ChaosPreemption):
            _ck_est(ckdir).fit(X, y, device="cpu")
        m = _ck_est(ckdir).fit_streaming(store, y, device="cpu")
    _assert_equal_models(ref, m)


def test_streaming_classifier_resumes_mid_shard(tmp_path):
    X, _ = _data(seed=1)
    y = _cls_labels(X)
    est = lambda ck: st.GBMClassifier(base_learner=_base(max_depth=2), num_base_learners=4,
                                      seed=3, checkpoint_dir=ck, checkpoint_interval=2)
    with override(stream_chunk_rows=64, shard_rows=64):
        store = _store(tmp_path, X)
        ref = est(None).fit(X, y, device="cpu")
        chaos.install(_FaultAt("GBMClassifier:stream_round:2:level:0:shard:2"))
        with pytest.raises(ChaosPreemption):
            est(str(tmp_path / "ck")).fit_streaming(store, y, device="cpu")
        m = est(str(tmp_path / "ck")).fit_streaming(store, y, device="cpu")
    _assert_equal_models(ref, m)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_fit_streaming_input_validation(tmp_path):
    X, y = _data()
    store = _store(tmp_path, X)
    cases = [
        (ValueError, "init_strategy", st.GBMRegressor(base_learner=_base(),
                                                      init_strategy="base"), y),
        (ValueError, "max_bins", st.GBMRegressor(base_learner=_base(max_bins=32)), y),
        (ValueError, "rows", st.GBMRegressor(base_learner=_base()), y[:-3]),
        (ValueError, "sampling", st.GBMRegressor(base_learner=_base(), sampling="goss"), y),
        (ValueError, "leaf_model", st.GBMRegressor(base_learner=_base(),
                                                   leaf_model="linear"), y),
        (ValueError, "DecisionTreeRegressor",
         st.GBMRegressor(base_learner=st.LinearRegression()), y),
    ]
    for exc, match, est, labels in cases:
        with pytest.raises(exc, match=match):
            est.fit_streaming(store, labels, device="cpu")
    # telemetry_path raised before the port had telemetry; it streams now
    path = str(tmp_path / "t.jsonl")
    st.GBMRegressor(base_learner=_base(), num_base_learners=1,
                    telemetry_path=path).fit_streaming(store, y, device="cpu")
    with open(path) as f:
        kinds = [json.loads(line)["event"] for line in f]
    assert kinds[:2] == ["fit_start", "streaming_config"] and kinds[-1] == "fit_end"
    assert "shard_load" in kinds and "shard_wait_us" in kinds
    for est in (st.GBMRegressor(base_learner=_base()), st.GBMClassifier(base_learner=_base())):
        with pytest.raises(NotImplementedError, match="item 29"):
            est.fit_streaming(store, _cls_labels(X), mesh=object(), device="cpu")


def test_fit_streaming_defaults_to_the_card(tmp_path):
    """Like every port entry point, fit_streaming runs on CUDA unless told
    otherwise: without a card it raises instead of falling back."""
    X, y = _data()
    store = _store(tmp_path, X)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        st.GBMRegressor(base_learner=_base()).fit_streaming(store, y)
