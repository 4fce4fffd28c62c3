"""PyTorch port parity: linear-leaf trees and the leaf routing they use
(``spark_ensemble_tpu_torch/models/linear_tree.py``, ``ops/tree.py``'s
``leaf_one_hot``, ``leaf_one_hot_forest`` and ``predict_tree_binned``, vs
the JAX package's).

- The leaf one-hots and the binned predict are exactly equal to the JAX
  package's path-score matmuls, NaN/+-inf rows included (clamped as
  ``_F32_MAX``: NaN/+inf right at every real split, -inf left); depth 11
  raises ValueError on both sides.
- ``chol_solve_psd_lanes`` solves a batch within 1e-5 of the JAX package's
  vmapped ``chol_solve_psd`` (the sums of the Crout steps run in each
  library's order), and a lane that is not positive definite comes out
  non-finite in both, without raising.
- ``LinearTreeRegressor``'s leaf coefficients are within rtol 1e-3 /
  atol 1e-3 of the JAX package's (f32 normal equations, summed in another
  order; a leaf's system can be ill-conditioned), its tree array-equal,
  and predictions within 1e-4 of the label scale; the ``min_leaf_weight``
  fallback gives the constant tree in both.
- A 3-round ``leaf_model="linear"`` GBM matches at 1e-3 of the label
  scale; ``convert.py`` carries fitted JAX models across within 1e-5; a
  foreign base raises ValueError as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.ops import linesearch as jls
from spark_ensemble_tpu.ops import tree as jt
from spark_ensemble_tpu.ops.binning import bin_features, compute_bins
from spark_ensemble_tpu_torch.ops import linesearch as tls
from spark_ensemble_tpu_torch.ops import tree as tt

TREE_FIELDS = tt.Tree._fields


def _piecewise_linear(n=600, d=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.where(X[:, 0] > 0, 3.0 * X[:, 1] + 1.0, -2.0 * X[:, 1] + X[:, 2])
    return X, (y + 0.05 * rng.randn(n)).astype(np.float32)


def _forest(M, depth, seed=3, n=400, d=5, B=16):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    bins = compute_bins(jnp.asarray(X), B)
    Xb = bin_features(jnp.asarray(X), bins)
    Y = (rng.randint(-16, 17, size=(n, M, 1)) / 8.0).astype(np.float32)
    w = np.ones((n, M), np.float32)
    trees = jt.fit_forest(Xb, jnp.asarray(Y), jnp.asarray(w), bins.thresholds,
                          max_depth=depth, max_bins=B, hist="scatter")
    return X, np.asarray(Xb), trees


def _as_torch(trees):
    return tt.Tree(*(torch.as_tensor(np.asarray(a)) for a in trees))


def _query(d, seed=8):
    Xq = np.random.RandomState(seed).randn(300, d).astype(np.float32)
    Xq[0, :] = np.nan
    Xq[1, :] = np.inf
    Xq[2, :] = -np.inf
    Xq[3, 0] = np.nan
    Xq[4, 1] = -np.inf
    return Xq


@pytest.mark.parametrize("depth", [1, 3, 5])
@pytest.mark.parametrize("binned", [False, True])
def test_leaf_one_hot_forest_equals_the_reference(depth, binned):
    X, Xb, jtrees = _forest(3, depth)
    Xq = Xb[:300] if binned else _query(X.shape[1])
    want = np.asarray(jt.leaf_one_hot_forest(jtrees, jnp.asarray(Xq), binned=binned))
    got = tt.leaf_one_hot_forest(_as_torch(jtrees), torch.as_tensor(Xq), binned=binned)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("binned", [False, True])
def test_leaf_one_hot_and_binned_predict_equal_the_reference(binned):
    X, Xb, jtrees = _forest(2, 3, seed=4)
    jtree = jt.Tree(*(a[1] for a in jtrees))
    ttree = tt.Tree(*(torch.as_tensor(np.asarray(a)) for a in jtree))
    Xq = Xb[:300] if binned else _query(X.shape[1], seed=9)
    np.testing.assert_array_equal(
        tt.leaf_one_hot(ttree, torch.as_tensor(Xq), binned=binned).numpy(),
        np.asarray(jt.leaf_one_hot(jtree, jnp.asarray(Xq), binned=binned)),
    )
    if binned:
        np.testing.assert_array_equal(
            tt.predict_tree_binned(ttree, torch.as_tensor(Xq)).numpy(),
            np.asarray(jt.predict_tree_binned(jtree, jnp.asarray(Xq))),
        )


def test_leaf_one_hot_depth_gate_raises_as_the_reference():
    J = 2**11 - 1
    trees = tt.Tree(torch.zeros((1, J), dtype=torch.int32),
                    torch.zeros((1, J), dtype=torch.int32),
                    torch.zeros((1, J)), torch.zeros((1, J + 1, 1)),
                    torch.zeros((1, J)))
    X = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="depth <= 10"):
        tt.leaf_one_hot_forest(trees, X, binned=False)
    with pytest.raises(ValueError, match="depth <= 10"):
        tt.leaf_one_hot(tt.Tree(*(a[0] for a in trees)), X, binned=True)
    with pytest.raises(ValueError):
        jt.leaf_one_hot(jt.Tree(*(jnp.asarray(a[0].numpy()) for a in trees)),
                        jnp.asarray(X.numpy()), binned=True)
    with pytest.raises(ValueError):
        st.LinearTreeRegressor(max_depth=11)


def test_batched_cholesky_matches_the_reference():
    rng = np.random.RandomState(0)
    G = rng.randn(6, 9, 9).astype(np.float32)
    A = (G @ G.transpose(0, 2, 1) + np.eye(9, dtype=np.float32)).astype(np.float32)
    A[4] = -A[4]  # not positive definite
    b = rng.randn(6, 9).astype(np.float32)
    want = np.asarray(jax.vmap(jls.chol_solve_psd)(jnp.asarray(A), jnp.asarray(b)))
    got = tls.chol_solve_psd_lanes(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    ok = np.arange(6) != 4
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)
    assert not np.isfinite(got[4]).all() and not np.isfinite(want[4]).all()


def _both(X, y, **kw):
    jm = se.LinearTreeRegressor(**kw).fit(X, y)
    tm = st.LinearTreeRegressor(**kw).fit(X, y, device="cpu")
    return jm, tm


@pytest.mark.parametrize(
    "kw",
    [dict(max_depth=2, hist="scatter"), dict(max_depth=3, hist="scatter"),
     dict(max_depth=3, hist="fused", reg_param=0.1), dict(max_depth=2, hist="matmul"),
     dict(max_depth=3, hist="stream", min_leaf_weight=20.0)],
)
def test_linear_tree_matches_the_reference(kw):
    X, y = _piecewise_linear()
    jm, tm = _both(X, y, max_bins=16, **kw)
    for f in TREE_FIELDS[:3]:
        np.testing.assert_array_equal(getattr(tm.params["tree"], f).numpy(),
                                      np.asarray(getattr(jm.params["tree"], f)))
    for k in ("beta", "x_mu", "x_sd", "mask"):
        np.testing.assert_allclose(tm.params[k].numpy(), np.asarray(jm.params[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-4 * np.abs(y).max())
    Xq = _query(X.shape[1])
    got, want = tm.predict(Xq).numpy(), np.asarray(jm.predict(Xq))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(y).max())


def test_min_leaf_weight_fallback_is_the_constant_tree():
    """Leaves below min_leaf_weight keep the constant value: with a bar no
    leaf reaches, the model predicts exactly the constant-leaf tree, in
    both packages."""
    X, y = _piecewise_linear()
    jm, tm = _both(X, y, max_depth=3, max_bins=16, hist="scatter",
                   min_leaf_weight=1e6)
    beta = tm.params["beta"].numpy()
    assert (beta[:, :-1] == 0).all()
    np.testing.assert_array_equal(beta[:, -1], tm.params["tree"].leaf_value[:, 0].numpy())
    const = st.DecisionTreeRegressor(max_depth=3, max_bins=16, hist="scatter").fit(
        X, y, device="cpu")
    np.testing.assert_array_equal(tm.predict(X).numpy(), const.predict(X).numpy())
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               rtol=0, atol=1e-6)


def test_linear_leaves_beat_constant_leaves():
    """At equal depth the ridge leaves cut the training MSE (by 41% on
    this target, the same in both packages)."""
    X, y = _piecewise_linear()
    lin = st.LinearTreeRegressor(max_depth=2).fit(X, y, device="cpu")
    const = st.DecisionTreeRegressor(max_depth=2).fit(X, y, device="cpu")
    mse = [float(torch.mean((m.predict(X) - torch.as_tensor(y)) ** 2)) for m in (lin, const)]
    assert mse[0] < 0.75 * mse[1], mse
    jmse = float(np.mean((np.asarray(se.LinearTreeRegressor(max_depth=2).fit(X, y)
                                     .predict(X)) - y) ** 2))
    assert abs(mse[0] - jmse) <= 1e-4 * jmse


def test_fused_member_fit_and_predict_match_the_reference():
    """fit_many_from_ctx with per-member feature masks, then the fused
    member predict, against the JAX package's vmapped leaf stage."""
    X, y = _piecewise_linear(500)
    rng = np.random.RandomState(2)
    ys = np.stack([y, -y, 0.5 * y], axis=1).astype(np.float32)
    ws = (rng.randint(1, 4, size=(500, 3)) / 2).astype(np.float32)
    masks = np.array([[1, 1, 1, 1], [1, 1, 0, 1], [0, 1, 1, 1]], bool)
    kw = dict(max_depth=2, max_bins=16, hist="scatter")
    je, te = se.LinearTreeRegressor(**kw), st.LinearTreeRegressor(**kw)
    jctx = je.make_fit_ctx(jnp.asarray(X))
    jp = je.fit_many_from_ctx(jctx, jnp.asarray(ys), jnp.asarray(ws),
                              jnp.asarray(masks), None)
    tctx = te.make_fit_ctx(torch.as_tensor(X))
    tp = te.fit_many_from_ctx(tctx, torch.as_tensor(ys), torch.as_tensor(ws),
                              torch.as_tensor(masks))
    np.testing.assert_array_equal(tp["tree"].split_feature.numpy(),
                                  np.asarray(jp["tree"].split_feature))
    np.testing.assert_allclose(tp["beta"].numpy(), np.asarray(jp["beta"]),
                               rtol=1e-3, atol=1e-3)
    Xq = _query(4)
    np.testing.assert_allclose(te.predict_many_fn(tp, torch.as_tensor(Xq)).numpy(),
                               np.asarray(je.predict_many_fn(jp, jnp.asarray(Xq))),
                               atol=1e-3)


@pytest.mark.parametrize("hist", ["scatter", "fused"])
def test_linear_leaf_gbm_matches_the_reference(hist):
    X, y = _piecewise_linear()
    kw = dict(num_base_learners=3, learning_rate=0.3, leaf_model="linear")

    def tree(pkg):
        return pkg.DecisionTreeRegressor(hist=hist, max_depth=3, max_bins=16)

    jm = se.GBMRegressor(base_learner=tree(se), **kw).fit(X, y)
    tm = st.GBMRegressor(base_learner=tree(st), **kw).fit(X, y, device="cpu")
    assert isinstance(tm._base(), st.LinearTreeRegressor)
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-3 * np.abs(y).max())
    np.testing.assert_allclose(tm.feature_importances_, jm.feature_importances_,
                               atol=1e-4)


def test_linear_leaf_gbm_classifier_runs_as_the_reference():
    """GBMClassifier at leaf_model='linear' fits a linear-leaf tree per
    class dim (the members are dicts around a stacked Tree)."""
    X, y = _piecewise_linear(500)
    yc = (y > np.median(y)).astype(np.float32) + (y > np.percentile(y, 80))
    kw = dict(num_base_learners=2, learning_rate=0.3, leaf_model="linear",
              base_learner=None)
    jm = se.GBMClassifier(**kw).fit(X, yc)
    tm = st.GBMClassifier(**kw).fit(X, yc, device="cpu")
    assert tm.params["members"]["beta"].shape[:2] == (2, 3)
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-3)


def _linear_arrays(params):
    out = {f: np.asarray(getattr(params["tree"], f)) for f in TREE_FIELDS}
    out.update({k: np.asarray(params[k]) for k in ("beta", "x_mu", "x_sd", "mask")})
    return out


def test_convert_round_trips_linear_trees():
    X, y = _piecewise_linear()
    jm = se.LinearTreeRegressor(max_depth=3).fit(X, y)
    tm = st.linear_tree_regressor_from_arrays(
        jm.get_params(), _linear_arrays(jm.params), num_features=X.shape[1],
        device="cpu")
    assert isinstance(tm, st.LinearTreeRegressionModel)
    Xq = _query(X.shape[1])
    np.testing.assert_allclose(tm.predict(Xq).numpy(), np.asarray(jm.predict(Xq)),
                               rtol=1e-5, atol=1e-5)
    jg = se.GBMRegressor(num_base_learners=3, leaf_model="linear").fit(X, y)
    arrays = dict(_linear_arrays(jg.params["members"]),
                  weights=np.asarray(jg.params["weights"]),
                  init=np.asarray(jg.params["init"]["value"]))
    tg = st.gbm_regressor_from_arrays(jg.get_params(), arrays,
                                      num_features=X.shape[1], device="cpu")
    np.testing.assert_allclose(tg.predict(Xq).numpy(), np.asarray(jg.predict(Xq)),
                               rtol=1e-5, atol=1e-5)
    base = se.GBMRegressor(base_learner=se.LinearTreeRegressor(max_depth=2),
                           num_base_learners=2)
    jb = base.fit(X, y)
    arrays = dict(_linear_arrays(jb.params["members"]),
                  weights=np.asarray(jb.params["weights"]),
                  init=np.asarray(jb.params["init"]["value"]))
    tb = st.gbm_regressor_from_arrays(jb.get_params(), arrays,
                                      num_features=X.shape[1], device="cpu")
    assert isinstance(tb.base_learner, st.LinearTreeRegressor)
    np.testing.assert_allclose(tb.predict(Xq).numpy(), np.asarray(jb.predict(Xq)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("base", ["DecisionTreeClassifier", "LinearRegression"])
def test_foreign_base_raises_as_the_reference(base):
    X, y = _piecewise_linear(100)
    with pytest.raises(ValueError, match="leaf_model='linear'"):
        se.GBMRegressor(base_learner=getattr(se, base)(), leaf_model="linear").fit(X, y)
    with pytest.raises(ValueError, match="leaf_model='linear'"):
        st.GBMRegressor(base_learner=getattr(st, base)(), leaf_model="linear").fit(
            X, y, device="cpu")


def test_params_have_the_reference_names_and_defaults():
    jdefs, tdefs = se.LinearTreeRegressor._param_defs(), st.LinearTreeRegressor._param_defs()
    assert sorted(jdefs) == sorted(tdefs)
    for name, p in jdefs.items():
        assert tdefs[name].default == p.default, name


def test_other_ensembles_refuse_linear_leaves():
    """Bagging and Boosting over linear-leaf trees wait for the non-tree
    members (ROADMAP queue 1, item 14)."""
    X, y = _piecewise_linear(100)
    for est in (st.BaggingRegressor(base_learner=st.LinearTreeRegressor()),
                st.BoostingRegressor(base_learner=st.LinearTreeRegressor())):
        with pytest.raises(NotImplementedError, match="item 14"):
            est.fit(X, y, device="cpu")
