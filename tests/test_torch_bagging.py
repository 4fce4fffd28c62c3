"""PyTorch port parity: Bagging (``spark_ensemble_tpu_torch/models/
bagging.py`` vs ``models/bagging.py``).

Both packages draw the same member plan (tests/test_torch_random.py) and
fit every member in one forest fit.  Fixtures are tie-free and dyadic
(ROADMAP.md, "Fixtures for exact parity"): sample weights are multiples of
1/16 from a wide range, so the Poisson- or Bernoulli-weighted statistic
sums are exact in any order and no leaf's class weights tie; members'
split tables are then array-equal and predictions equal, on the scatter
and fused tiers."""

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st

SPLITS = ("split_feature", "split_bin", "split_threshold")


def _cls_data(seed=21, n=512, d=6, k=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T
                  + 0.5 * rng.randn(n, k), axis=1).astype(np.float32)
    w = (rng.randint(1, 64, n) / 16.0).astype(np.float32)
    return X, y, w


def _reg_data(seed=22, n=512, d=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (2.0 * X[:, 0] + np.sin(3.0 * X[:, 1]) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _tree(pkg, cls, hist):
    return getattr(pkg, cls)(hist=hist, max_depth=3, max_bins=16)


def _assert_same_members(tm, jm):
    for f in SPLITS:
        np.testing.assert_array_equal(getattr(tm.params["members"], f).numpy(),
                                      np.asarray(getattr(jm.params["members"], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tm.params["masks"].numpy(),
                                  np.asarray(jm.params["masks"]))


@pytest.mark.parametrize("hist", ["scatter", "fused"])
@pytest.mark.parametrize("replacement", [True, False])
@pytest.mark.parametrize("voting", ["hard", "soft"])
def test_bagging_classifier_matches(voting, replacement, hist):
    X, y, w = _cls_data()
    kw = dict(num_base_learners=4, subspace_ratio=0.5, voting_strategy=voting,
              replacement=replacement, subsample_ratio=1.0 if replacement else 0.7,
              seed=3)
    jm = se.BaggingClassifier(base_learner=_tree(se, "DecisionTreeClassifier", hist),
                              **kw).fit(X, y, sample_weight=w)
    tm = st.BaggingClassifier(base_learner=_tree(st, "DecisionTreeClassifier", hist),
                              **kw).fit(X, y, sample_weight=w, device="cpu")
    _assert_same_members(tm, jm)
    assert tm.num_members == jm.num_members == 4
    np.testing.assert_array_equal(tm.member_class_predictions(X).numpy(),
                                  np.asarray(jm.member_class_predictions(X)))
    np.testing.assert_array_equal(tm.predict(X).numpy(), np.asarray(jm.predict(X)))
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), rtol=0, atol=1e-6)
    assert tm.score(X, y) == pytest.approx(jm.score(X, y), abs=1e-6)


@pytest.mark.parametrize("hist", ["scatter", "fused"])
@pytest.mark.parametrize("replacement", [True, False])
def test_bagging_regressor_matches(replacement, hist):
    X, y = _reg_data()
    kw = dict(num_base_learners=3, subspace_ratio=0.5, replacement=replacement,
              subsample_ratio=0.8)
    jm = se.BaggingRegressor(base_learner=_tree(se, "DecisionTreeRegressor", hist),
                             **kw).fit(X, y)
    tm = st.BaggingRegressor(base_learner=_tree(st, "DecisionTreeRegressor", hist),
                             **kw).fit(X, y, device="cpu")
    _assert_same_members(tm, jm)
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.feature_importances_, jm.feature_importances_,
                               rtol=0, atol=1e-6)


def test_default_bagging_classifier_and_member_models():
    """Defaults (Poisson weights at ratio 1, no subspaces) and
    ``member(i)`` as a standalone model."""
    X, y, w = _cls_data(seed=23, n=256)
    jm = se.BaggingClassifier(base_learner=_tree(se, "DecisionTreeClassifier", "scatter"),
                              num_base_learners=3).fit(X, y)
    tm = st.BaggingClassifier(base_learner=_tree(st, "DecisionTreeClassifier", "scatter"),
                              num_base_learners=3).fit(X, y, device="cpu")
    _assert_same_members(tm, jm)
    one = tm.member(1)
    assert isinstance(one, st.DecisionTreeClassificationModel)
    np.testing.assert_array_equal(one.predict(X).numpy(), np.asarray(jm.member(1).predict(X)))
    with pytest.raises(IndexError):
        tm.member(3)


def test_carried_bagging_models_predict_the_same():
    X, y, w = _cls_data(seed=24, n=400)
    jm = se.BaggingClassifier(base_learner=_tree(se, "DecisionTreeClassifier", "scatter"),
                              num_base_learners=3, subspace_ratio=0.5).fit(X, y)
    arrays = {f: np.asarray(getattr(jm.params["members"], f))
              for f in st.ops.tree.Tree._fields}
    arrays["masks"] = np.asarray(jm.params["masks"])
    tm = st.bagging_classifier_from_arrays(jm.get_params(), arrays, num_features=6,
                                           num_classes=jm.num_classes, device="cpu")
    assert isinstance(tm.base_learner, st.DecisionTreeClassifier)
    Xq = np.random.RandomState(25).randn(200, 6).astype(np.float32)
    np.testing.assert_array_equal(tm.predict_proba(Xq).numpy(), np.asarray(jm.predict_proba(Xq)))
    Xr, yr = _reg_data(seed=26, n=300)
    jr = se.BaggingRegressor(base_learner=_tree(se, "DecisionTreeRegressor", "scatter"),
                             num_base_learners=2).fit(Xr, yr)
    arrays = {f: np.asarray(getattr(jr.params["members"], f))
              for f in st.ops.tree.Tree._fields}
    arrays["masks"] = np.asarray(jr.params["masks"])
    tr = st.bagging_regressor_from_arrays(jr.get_params(), arrays, num_features=6,
                                          device="cpu")
    np.testing.assert_allclose(tr.predict(Xr).numpy(), np.asarray(jr.predict(Xr)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "jcls,tcls",
    [(se.BaggingClassifier, st.BaggingClassifier),
     (se.BaggingRegressor, st.BaggingRegressor)],
)
def test_bagging_params_have_the_reference_names_and_defaults(jcls, tcls):
    jdefs, tdefs = jcls._param_defs(), tcls._param_defs()
    assert sorted(jdefs) == sorted(tdefs)
    for name, p in jdefs.items():
        assert tdefs[name].default == p.default, name


def test_bagging_mesh_unported_policies_and_missing_cuda_raise(monkeypatch):
    X, y, w = _cls_data(n=64)
    with pytest.raises(NotImplementedError, match="queue 1, item 18"):
        st.BaggingClassifier(num_base_learners=2).fit(X, y, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        st.BaggingRegressor(on_nonfinite="skip_round").fit(X, y, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.BaggingClassifier(num_base_learners=2).fit(X, y)
