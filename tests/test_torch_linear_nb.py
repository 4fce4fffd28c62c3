"""PyTorch port parity: the linear learners and Gaussian naive Bayes
(``spark_ensemble_tpu_torch/models/{linear,naive_bayes}.py`` vs the JAX
package's), with feature masks, sample weights and ``fit_intercept=False``.

Tolerances: ridge predictions within 1e-4·max|y| (f32 normal equations,
sums in other orders); Newton probabilities within 1e-4 (the same
iterations, exact Hessians); L-BFGS probabilities within 1e-3 at the
optimum: the port's L-BFGS (strong-Wolfe steps) and optax's (zoom line
search) take different steps on the strictly convex objective (reg > 0)
and meet at its minimizer, not iterate by iterate.  Naive Bayes log
scores within rtol 1e-5 and probabilities within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.models import linear as tlin


def _data(n=600, d=7, k=3, seed=0):
    rng = np.random.RandomState(seed)
    scale = np.array([1.0, 10.0, 0.1, 1.0, 5.0, 1.0, 100.0][:d], np.float32)
    X = (rng.randn(n, d) * scale).astype(np.float32)
    X[:, 3] = (rng.rand(n) < 0.1).astype(np.float32)  # a rare binary column
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.rand(n) < 0.1] = 0.0  # out-of-bag rows
    y = (X / scale) @ rng.randn(d) + 0.1 * rng.randn(n)
    logits = (X / scale)[:, :3] @ rng.randn(3, k) + rng.randn(n, k)
    return X, w, y.astype(np.float32), np.argmax(logits, axis=1).astype(np.float32)


MASK = np.array([True, False, True, True, True, False, True])


def _fit_pair(jcls, tcls, kw, X, y, w, mask, num_classes=None):
    """Fit through the member protocol (masks enter there), then wrap the
    params as models on both sides."""
    jb, tb = jcls(**kw), tcls(**kw)
    jctx = jb.make_fit_ctx(jnp.asarray(X), num_classes)
    tctx = tb.make_fit_ctx(torch.as_tensor(X), num_classes)
    jm_mask = None if mask is None else jnp.asarray(mask)
    tm_mask = None if mask is None else torch.as_tensor(mask)
    jp = jb.fit_from_ctx(jctx, jnp.asarray(y), jnp.asarray(w), jm_mask,
                         jax.random.PRNGKey(0))
    tp = tb.fit_from_ctx(tctx, torch.as_tensor(y), torch.as_tensor(w), tm_mask)
    return (jb.model_from_params(jp, X.shape[1], num_classes),
            tb.model_from_params(tp, X.shape[1], num_classes, torch.device("cpu")))


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("mask", [None, MASK])
def test_linear_regression_matches(fit_intercept, mask):
    X, w, y, _ = _data()
    jm, tm = _fit_pair(se.LinearRegression, st.LinearRegression,
                       dict(fit_intercept=fit_intercept, reg_param=1e-3), X, y, w, mask)
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-4 * np.abs(y).max())
    np.testing.assert_array_equal(tm.params["mask"].numpy(), np.asarray(jm.params["mask"]))


@pytest.mark.parametrize("solver,tol", [("newton", 1e-4), ("lbfgs", 1e-3)])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("fit_intercept,mask", [(True, None), (False, MASK), (True, MASK)])
def test_logistic_regression_matches(solver, tol, k, fit_intercept, mask):
    X, w, _, y = _data(k=k, seed=k)
    kw = dict(solver=solver, fit_intercept=fit_intercept, reg_param=1e-2)
    jm, tm = _fit_pair(se.LogisticRegression, st.LogisticRegression, kw, X, y, w,
                       mask, num_classes=k)
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=tol)
    if not fit_intercept:
        assert not tm.params["intercept"].any()


def test_logistic_auto_picks_newton_below_the_parameter_ceiling():
    """``solver="auto"``: newton when (d+1)*k <= 1024, else lbfgs — the
    same fit as naming the solver."""
    X, w, _, y = _data(k=3, seed=1)
    auto = st.LogisticRegression(reg_param=1e-2).fit(X, y, sample_weight=w, device="cpu")
    newton = st.LogisticRegression(reg_param=1e-2, solver="newton").fit(
        X, y, sample_weight=w, device="cpu")
    assert torch.equal(auto.predict_proba(X), newton.predict_proba(X))
    wide = np.concatenate([X] * 40, axis=1)[:, :260]  # (260+1)*4 > 1024
    y4 = (y + (X[:, 0] > 0)).astype(np.float32)
    kw = dict(reg_param=1e-2, max_iter=5)
    auto = st.LogisticRegression(**kw).fit(wide, y4, device="cpu")
    lbfgs = st.LogisticRegression(solver="lbfgs", **kw).fit(wide, y4, device="cpu")
    assert (260 + 1) * 4 > tlin._NEWTON_MAX_PARAMS
    assert torch.equal(auto.predict_proba(wide), lbfgs.predict_proba(wide))
    jm = se.LogisticRegression(reg_param=1e-2).fit(X, y, sample_weight=w)
    np.testing.assert_allclose(newton.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-4)


@pytest.mark.parametrize("mask", [None, MASK])
def test_gaussian_nb_matches(mask):
    X, w, _, y = _data(k=4, seed=3)
    jm, tm = _fit_pair(se.GaussianNaiveBayes, st.GaussianNaiveBayes,
                       dict(var_smoothing=1e-4), X, y, w, mask, num_classes=4)
    np.testing.assert_allclose(tm.predict_raw(X).numpy(), np.asarray(jm.predict_raw(X)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm.predict(X).numpy(), np.asarray(jm.predict(X)))


def test_gaussian_nb_floor_counts_present_rows_only():
    """Zero-weight rows do not move the smoothing floor: adding far-away
    rows at weight 0 changes nothing."""
    X, w, _, y = _data(k=3, seed=4)
    far = np.full((50, X.shape[1]), 1e3, np.float32)
    X2, y2 = np.concatenate([X, far]), np.concatenate([y, np.zeros(50, np.float32)])
    w2 = np.concatenate([w, np.zeros(50, np.float32)])
    a = st.GaussianNaiveBayes().fit(X, y, sample_weight=w, device="cpu")
    b = st.GaussianNaiveBayes().fit(X2, y2, sample_weight=w2, num_classes=3, device="cpu")
    np.testing.assert_allclose(b.params["var"].numpy(), a.params["var"].numpy(), rtol=1e-5)


@pytest.mark.parametrize("jcls,tcls", [
    (se.LinearRegression, st.LinearRegression),
    (se.LogisticRegression, st.LogisticRegression),
    (se.GaussianNaiveBayes, st.GaussianNaiveBayes),
])
def test_params_have_the_reference_names_and_defaults(jcls, tcls):
    jdefs, tdefs = jcls._param_defs(), tcls._param_defs()
    assert sorted(jdefs) == sorted(tdefs)
    for name, p in jdefs.items():
        assert tdefs[name].default == p.default, name
