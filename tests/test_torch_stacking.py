"""PyTorch port parity: Stacking (``spark_ensemble_tpu_torch/models/
stacking.py`` vs ``models/stacking.py``) over the tree, linear and naive
Bayes learners, and ``convert.py`` for every model this slice ports.

The same seeded numpy data go through both packages (trees on the scatter
tier, where the port sums in the JAX package's order).  Tolerances: class
meta-features and predictions equal; raw and proba meta-features within
1e-5 (raw ones centred per member: logits are defined up to a per-row
shift); probabilities within 1e-4 (the
stacker's Newton solve on meta-features that agree to ~1e-6); regression
within 1e-4·max|y|.  ``parallelism=2`` must give exactly the
``parallelism=1`` result; converted models predict within 1e-6 of the
fitted JAX model."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.ops import hist_kernels as hk


def _cls_data(n=500, d=6, k=3, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X[:, :3] @ rng.randn(3, k) + 0.5 * rng.randn(n, k), axis=1)
    return X, y.astype(np.float32)


def _reg_data(n=500, d=6, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    return X, (2.0 * X[:, 0] + np.sin(3.0 * X[:, 1]) + 0.1 * rng.randn(n)).astype(np.float32)


def _bases(pkg):
    """bench.py's Stacking config: DT + LR + GaussianNB."""
    return [pkg.DecisionTreeClassifier(max_depth=3, max_bins=16, hist="scatter"),
            pkg.LogisticRegression(reg_param=1e-2), pkg.GaussianNaiveBayes()]


@pytest.mark.parametrize("stack_method", ["class", "raw", "proba"])
def test_stacking_classifier_matches(stack_method):
    X, y = _cls_data()
    w = np.random.RandomState(5).uniform(0.5, 2.0, len(y)).astype(np.float32)
    kw = dict(stack_method=stack_method)
    jm = se.StackingClassifier(base_learners=_bases(se),
                               stacker=se.LogisticRegression(reg_param=1e-2), **kw
                               ).fit(X, y, sample_weight=w)
    tm = st.StackingClassifier(base_learners=_bases(st),
                               stacker=st.LogisticRegression(reg_param=1e-2), **kw
                               ).fit(X, y, sample_weight=w, device="cpu")
    meta_j = np.asarray(jm._meta_features(jm.base_models, jnp.asarray(X)))
    meta_t = tm._meta_features(tm.base_models, torch.as_tensor(X)).numpy()
    if stack_method == "class":
        np.testing.assert_array_equal(meta_t, meta_j)
    else:
        if stack_method == "raw":
            # a softmax's raw scores are defined up to a per-row shift (the
            # unpenalized intercepts' null direction): compare each member's
            # block centred
            meta_t, meta_j = (m.reshape(len(y), 3, 3) for m in (meta_t, meta_j))
            meta_t, meta_j = (m - m.mean(axis=2, keepdims=True) for m in (meta_t, meta_j))
        np.testing.assert_allclose(meta_t, meta_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-4)
    np.testing.assert_array_equal(tm.predict(X).numpy(), np.asarray(jm.predict(X)))


def test_default_stacking_regressor_matches():
    X, y = _reg_data()
    jm = se.StackingRegressor().fit(X, y)
    tm = st.StackingRegressor().fit(X, y, device="cpu")
    assert [type(m).__name__ for m in tm.base_models] == [
        "DecisionTreeRegressionModel", "LinearRegressionModel"]
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-4 * np.abs(y).max())


def test_default_stacking_classifier_matches():
    X, y = _cls_data(seed=6)
    jm = se.StackingClassifier().fit(X, y)
    tm = st.StackingClassifier().fit(X, y, device="cpu")
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-4)


@pytest.mark.parametrize("family", ["classifier", "regressor"])
def test_parallelism_two_equals_one(family):
    if family == "classifier":
        X, y = _cls_data(seed=7)
        make = lambda p: st.StackingClassifier(  # noqa: E731
            base_learners=_bases(st) + [st.GBMClassifier(num_base_learners=2)],
            stack_method="proba", parallelism=p)
        out = lambda m: m.predict_proba(X)  # noqa: E731
    else:
        X, y = _reg_data(seed=8)
        make = lambda p: st.StackingRegressor(  # noqa: E731
            base_learners=[st.DecisionTreeRegressor(), st.LinearRegression(),
                           st.GBMRegressor(num_base_learners=2, loss="huber")],
            parallelism=p)
        out = lambda m: m.predict(X)  # noqa: E731
    one = make(1).fit(X, y, device="cpu")
    two = make(2).fit(X, y, device="cpu")
    assert torch.equal(out(one), out(two))


def test_launch_counts_survive_threads():
    """The kernels' launch counters take a lock: 16 threads adding at a
    short switch interval lose no count."""
    hk.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [hk._count("leaf_sums") for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert hk.LAUNCHES["leaf_sums"] == 16 * 2000
    hk.reset_launch_counts()


class _NaNRegression(st.LinearRegression):
    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None):
        params = super().fit_from_ctx(ctx, y, w, feature_mask, key=key)
        params["coef"] = params["coef"] * float("nan")
        return params


def test_numeric_guard_unported_planes_and_bases_raise():
    X, y = _reg_data(n=64)
    bad = st.StackingRegressor(base_learners=[st.LinearRegression(), _NaNRegression()])
    with pytest.raises(FloatingPointError, match="member 1"):
        bad.fit(X, y, device="cpu")
    # with the guard off the NaN reaches the stacker's input check instead
    with pytest.raises(ValueError, match="NaN"):
        bad.set_params(on_nonfinite="off").fit(X, y, device="cpu")
    with pytest.raises(FloatingPointError, match="stacker"):
        st.StackingRegressor(stacker=_NaNRegression()).fit(X, y, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 29"):
        st.StackingRegressor().fit(X, y, mesh=object(), device="cpu")
    # ensembles over non-tree learners are members like any other
    for family in (st.BaggingRegressor, st.BoostingRegressor, st.GBMRegressor):
        model = st.StackingRegressor(base_learners=[
            family(base_learner=st.LinearRegression())]).fit(X, y, device="cpu")
        assert bool(torch.isfinite(model.predict(X)).all())


def _arrays(params, keys):
    return {k: np.asarray(params[k]) for k in keys}


def _convert(jmodel, num_features, num_classes):
    """A fitted JAX base model -> the port's, by its class."""
    name = type(jmodel).__name__
    p = jmodel.get_params()
    if name == "LinearRegressionModel":
        return st.linear_regression_from_arrays(
            p, _arrays(jmodel.params, ("coef", "intercept", "mask")),
            num_features=num_features, device="cpu")
    if name == "LogisticRegressionModel":
        return st.logistic_regression_from_arrays(
            p, _arrays(jmodel.params, ("coef", "intercept", "mask")),
            num_features=num_features, num_classes=num_classes, device="cpu")
    if name == "GaussianNaiveBayesModel":
        return st.gaussian_nb_from_arrays(
            p, _arrays(jmodel.params, ("mean", "var", "log_prior", "mask")),
            num_features=num_features, num_classes=num_classes, device="cpu")
    if name == "DecisionTreeClassificationModel":
        arrays = {f: np.asarray(getattr(jmodel.params, f)) for f in st.ops.tree.Tree._fields}
        return st.decision_tree_classifier_from_arrays(
            p, arrays, num_features=num_features, num_classes=num_classes, device="cpu")
    raise AssertionError(name)


def test_convert_round_trips_every_new_model():
    X, y = _cls_data(seed=9)
    Xq = np.random.RandomState(10).randn(200, X.shape[1]).astype(np.float32)
    for jcls in (se.LogisticRegression, se.GaussianNaiveBayes):
        jm = jcls().fit(X, y)
        tm = _convert(jm, X.shape[1], 3)
        np.testing.assert_allclose(tm.predict_proba(Xq).numpy(),
                                   np.asarray(jm.predict_proba(Xq)), rtol=1e-6, atol=1e-6)
    Xr, yr = _reg_data(seed=11)
    jl = se.LinearRegression(fit_intercept=False).fit(Xr, yr)
    tl = _convert(jl, Xr.shape[1], None)
    np.testing.assert_allclose(tl.predict(Xq).numpy(), np.asarray(jl.predict(Xq)),
                               rtol=1e-6, atol=1e-6)
    # Stacking: members and stacker converted one by one
    jm = se.StackingClassifier(base_learners=_bases(se), stack_method="proba").fit(X, y)
    tm = st.stacking_classifier_from_models(
        jm.get_params(), [_convert(m, X.shape[1], 3) for m in jm.base_models],
        _convert(jm.stack_model, 3 * 3, 3), num_features=X.shape[1], num_classes=3,
        device="cpu")
    assert [type(b).__name__ for b in tm.base_learners] == [
        "DecisionTreeClassifier", "LogisticRegression", "GaussianNaiveBayes"]
    np.testing.assert_allclose(tm.predict_proba(Xq).numpy(),
                               np.asarray(jm.predict_proba(Xq)), rtol=1e-6, atol=1e-6)
    jr = se.StackingRegressor(base_learners=[se.LinearRegression()]).fit(Xr, yr)
    tr = st.stacking_regressor_from_models(
        jr.get_params(), [_convert(m, Xr.shape[1], None) for m in jr.base_models],
        _convert(jr.stack_model, 1, None), num_features=Xr.shape[1], device="cpu")
    np.testing.assert_allclose(tr.predict(Xq).numpy(), np.asarray(jr.predict(Xq)),
                               rtol=1e-6, atol=1e-5)
