"""PyTorch port parity: the classifier tree (``DecisionTreeClassifier``,
``spark_ensemble_tpu_torch/models/tree.py`` vs ``models/tree.py``) and the
feature importances behind it.

Fixtures are tie-free and dyadic (ROADMAP.md, "Fixtures for exact
parity"): weights are multiples of 1/16 from a wide range, so every
statistic sum is exact in any order and no two candidate splits or leaf
classes tie.  Split tables are held array-equal per tier; leaf values,
probabilities and importances within 1e-6 (the centred targets are not
dyadic, so the tiers' sums differ in the last bit).  The single tree runs
on scatter, matmul and fused; matmul at "pallas" precision runs through
the forest path, and a single tree at "pallas" on the 'high' matmul tier,
as in the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st

SPLITS = ("split_feature", "split_bin", "split_threshold")


def _data(seed=3, n=640, d=6, k=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T
                  + 0.5 * rng.randn(n, k), axis=1).astype(np.float32)
    w = (rng.randint(1, 64, n) / 16.0).astype(np.float32)
    return X, y, w


def _tree(pkg, hist, hp="highest", depth=3):
    return pkg.DecisionTreeClassifier(hist=hist, hist_precision=hp,
                                      max_depth=depth, max_bins=16)


def _assert_same_trees(ttree, jtree):
    for f in SPLITS:
        np.testing.assert_array_equal(getattr(ttree, f).numpy(),
                                      np.asarray(getattr(jtree, f)), err_msg=f)
    np.testing.assert_allclose(ttree.leaf_value.numpy(), np.asarray(jtree.leaf_value),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ttree.split_gain.numpy(), np.asarray(jtree.split_gain),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hist", ["scatter", "matmul", "fused"])
def test_classifier_tree_matches_per_tier(hist):
    X, y, w = _data()
    jm = _tree(se, hist).fit(X, y, sample_weight=w)
    tm = _tree(st, hist).fit(X, y, sample_weight=w, device="cpu")
    assert isinstance(tm, st.DecisionTreeClassificationModel)
    assert tm.num_classes == jm.num_classes == 4
    _assert_same_trees(tm.params, jm.params)
    Xq = np.random.RandomState(4).randn(300, X.shape[1]).astype(np.float32)
    np.testing.assert_allclose(tm.predict_proba(Xq).numpy(),
                               np.asarray(jm.predict_proba(Xq)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.predict(Xq).numpy(), np.asarray(jm.predict(Xq)))
    np.testing.assert_allclose(tm.predict_raw(Xq).numpy(),
                               np.asarray(jm.predict_raw(Xq)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.feature_importances_, jm.feature_importances_,
                               rtol=0, atol=1e-6)
    assert tm.score(X, y, w) == pytest.approx(jm.score(X, y, w), abs=1e-6)


@pytest.mark.parametrize(
    "hist,hp",
    [("scatter", "highest"), ("matmul", "highest"), ("matmul", "pallas"),
     ("fused", "highest"), ("fused", "pallas")],
)
def test_classifier_forest_path_matches(hist, hp):
    """``fit_many_from_ctx``: three members with their own weights and
    feature masks in one forest fit (C = 1 + K statistics per row)."""
    X, y, w = _data(seed=6, n=512)
    rng = np.random.RandomState(7)
    ws = (rng.randint(0, 48, (512, 3)) / 16.0).astype(np.float32)
    masks = np.array([[1, 1, 1, 1, 1, 1], [1, 0, 1, 0, 1, 1], [0, 1, 1, 1, 0, 1]], bool)
    ys = np.repeat(y[:, None], 3, axis=1)
    jb, tb = _tree(se, hist, hp), _tree(st, hist, hp)
    jtrees = jb.fit_many_from_ctx(jb.make_fit_ctx(jnp.asarray(X), 4), jnp.asarray(ys),
                                  jnp.asarray(ws), jnp.asarray(masks), None)
    ttrees = tb.fit_many_from_ctx(tb.make_fit_ctx(torch.as_tensor(X), 4),
                                  torch.as_tensor(ys), torch.as_tensor(ws),
                                  torch.as_tensor(masks))
    _assert_same_trees(ttrees, jtrees)
    assert not (ttrees.split_feature.numpy()[1][ttrees.split_gain.numpy()[1] > 0]
                == 1).any()
    np.testing.assert_array_equal(tb.predict_many_fn(ttrees, torch.as_tensor(X)).numpy(),
                                  np.asarray(jb.predict_many_fn(jtrees, jnp.asarray(X))))
    np.testing.assert_allclose(
        tb.predict_proba_many_fn(ttrees, torch.as_tensor(X)).numpy(),
        np.asarray(jb.predict_proba_many_fn(jtrees, jnp.asarray(X))), rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("hist", ["scatter", "fused"])
def test_fit_and_proba_and_direction_reuse_the_fit_leaf_ids(hist):
    """SAMME.R's ``fit_and_proba`` and SAMME's ``fit_and_direction`` read
    the fitted rows' leaf values off the fit's leaf ids: equal to a predict
    on the same rows, and to the JAX package's."""
    X, y, w = _data(seed=8, n=400)
    jb, tb = _tree(se, hist), _tree(st, hist)
    jctx, tctx = jb.make_fit_ctx(jnp.asarray(X), 4), tb.make_fit_ctx(torch.as_tensor(X), 4)
    Xt, yt, wt = torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(w)
    tree, proba = tb.fit_and_proba(tctx, yt, wt, None, Xt)
    np.testing.assert_array_equal(proba.numpy(), tb.predict_proba_fn(tree, Xt).numpy())
    _, jproba = jb.fit_and_proba(jctx, jnp.asarray(y), jnp.asarray(w), None, None,
                                 jnp.asarray(X))
    np.testing.assert_allclose(proba.numpy(), np.asarray(jproba), rtol=0, atol=1e-6)
    tree, pred = tb.fit_and_direction(tctx, yt, wt, None, Xt)
    np.testing.assert_array_equal(pred.numpy(), tb.predict_fn(tree, Xt).numpy())


def test_single_tree_at_pallas_precision_raises():
    """It no longer raises: a single tree at "pallas" runs on the 'high'
    matmul tier with histogram subtraction, and equals the JAX package's."""
    X, y, w = _data(n=64)
    jm = _tree(se, "matmul", "pallas").fit(X, y, sample_weight=w)
    tm = _tree(st, "matmul", "pallas").fit(X, y, sample_weight=w, device="cpu")
    for f in SPLITS:
        np.testing.assert_array_equal(getattr(tm.params, f).numpy(),
                                      np.asarray(getattr(jm.params, f)), err_msg=f)
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), rtol=0, atol=1e-6)


def test_carried_classifier_tree_predicts_the_same():
    X, y, w = _data(seed=10)
    jm = _tree(se, "scatter", depth=4).fit(X, y)
    arrays = {f: np.asarray(getattr(jm.params, f)) for f in st.ops.tree.Tree._fields}
    tm = st.decision_tree_classifier_from_arrays(
        jm.get_params(), arrays, num_features=X.shape[1],
        num_classes=jm.num_classes, device="cpu",
    )
    Xq = np.random.RandomState(12).randn(300, X.shape[1]).astype(np.float32)
    np.testing.assert_array_equal(tm.predict_proba(Xq).numpy(),
                                  np.asarray(jm.predict_proba(Xq)))
    np.testing.assert_array_equal(tm.predict(Xq).numpy(), np.asarray(jm.predict(Xq)))


def test_regressor_tree_importances_and_score_match():
    rng = np.random.RandomState(13)
    X = rng.randn(500, 5).astype(np.float32)
    y = (2.0 * X[:, 0] + np.sin(3.0 * X[:, 3])).astype(np.float32)
    kw = dict(hist="scatter", max_depth=3, max_bins=16)
    jm = se.DecisionTreeRegressor(**kw).fit(X, y)
    tm = st.DecisionTreeRegressor(**kw).fit(X, y, device="cpu")
    np.testing.assert_allclose(tm.feature_importances_, jm.feature_importances_,
                               rtol=0, atol=1e-6)
    assert tm.score(X, y) == pytest.approx(jm.score(X, y), abs=1e-6)


def test_classifier_params_have_the_reference_names_and_defaults():
    jdefs, tdefs = se.DecisionTreeClassifier._param_defs(), st.DecisionTreeClassifier._param_defs()
    assert sorted(jdefs) == sorted(tdefs)
    for name, p in jdefs.items():
        assert tdefs[name].default == p.default, name
