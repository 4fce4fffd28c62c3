"""PyTorch port parity: GBM over the seven losses ported after squared and
logloss, against the JAX package (``device="cpu"``, 3 rounds, depth 3,
n <= 600).

Tolerances: regressor predictions within 1e-3·max|y| and classifier
probabilities within 1e-3 (the JAX package's own pin for its tiers,
tests/test_pallas_hist.py::test_fused_gbm_letter_leg_parity).  Absolute
and quantile losses have sign-valued gradients, so their trees' split
gains tie exactly; only the scatter tier sums in the JAX package's order
and breaks those ties alike, so they are held there.  The smooth losses
run on matmul too.  Brent's step search stops on a bracket of
1e-6·|a| + 1e-6, and the two packages sum its objective in different
orders, so steps agree to about 1e-5 and validation losses (not
stationary at the training optimum) to rtol 1e-3.  For absolute and
quantile losses a row whose residual sits near zero can change sign with
such a step, which changes the next round's trees: there the first round
is held (tree array-equal, step rtol 1e-4) and the 3-round training loss
within 1%.  Huber's per-round delta equals the alpha-quantile of the
port's own predictions exactly, and the JAX package's within rtol 1e-3
(an adjacent order statistic).  The Dummy median and quantile, the inits
of absolute, huber and quantile, are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.utils.quantile import weighted_quantile as j_quantile
from spark_ensemble_tpu_torch.utils.quantile import weighted_quantile as t_quantile

SIGN_GRADIENT = ("absolute", "quantile")


def _reg_data(n=500, d=6, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = 2.0 * X[:, 0] + np.sin(3.0 * X[:, 1]) + 0.3 * rng.standard_t(3, n)
    return X, y.astype(np.float32)


def _bin_data(n=600, d=6, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 2] + 0.7 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _tree(pkg, hist):
    return pkg.DecisionTreeRegressor(hist=hist, max_depth=3, max_bins=16)


@pytest.mark.parametrize(
    "loss,hist",
    [("absolute", "scatter"), ("huber", "scatter"), ("quantile", "scatter"),
     ("logcosh", "scatter"), ("scaledlogcosh", "scatter"),
     ("huber", "matmul"), ("logcosh", "matmul"), ("scaledlogcosh", "matmul")],
)
def test_regressor_per_loss_matches(loss, hist):
    X, y = _reg_data()
    kw = dict(num_base_learners=3, learning_rate=0.5, loss=loss, alpha=0.8)
    jm = se.GBMRegressor(base_learner=_tree(se, hist), **kw).fit(X, y)
    tm = st.GBMRegressor(base_learner=_tree(st, hist), **kw).fit(X, y, device="cpu")
    init_t, init_j = float(tm.params["init"]["value"]), float(jm.params["init"]["value"])
    if loss in ("absolute", "huber", "quantile"):
        assert init_t == init_j  # the median or alpha-quantile: exact
    else:
        assert init_t == pytest.approx(init_j, rel=1e-6)  # a mean
    if loss in SIGN_GRADIENT:
        for f in ("split_feature", "split_bin"):
            np.testing.assert_array_equal(getattr(tm.member(0).params, f).numpy(),
                                          np.asarray(getattr(jm.member(0).params, f)))
        np.testing.assert_allclose(float(tm.params["weights"][0]),
                                   float(jm.params["weights"][0]), rtol=1e-4)
        lt = st.ops.losses.get_regression_loss(loss, quantile=0.8)
        yt = torch.as_tensor(y)[:, None]
        train_t = float(lt.loss(yt, tm.predict(X)[:, None]).mean())
        train_j = float(lt.loss(yt, torch.as_tensor(np.asarray(jm.predict(X)))[:, None]).mean())
        assert train_t == pytest.approx(train_j, rel=1e-2)
    else:
        np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                                   atol=1e-3 * np.abs(y).max())
    if loss == "huber":
        # round r's delta: the alpha-quantile of |y - pred| before round r,
        # pred rebuilt as the fit builds it
        yt, p = torch.as_tensor(y), tm.init_model.predict(X)
        own = []
        for r in range(3):
            own.append(t_quantile(torch.abs(yt - p), 0.8, weights=torch.ones_like(yt)))
            p = p + tm.params["weights"][r] * tm.member(r).predict(X)
        np.testing.assert_array_equal(tm.params["huber_delta"].numpy(), torch.stack(own).numpy())
        want = [float(j_quantile(jnp.abs(jnp.asarray(y) - jm.take(r).predict(X)), 0.8))
                for r in range(3)]
        np.testing.assert_allclose(tm.params["huber_delta"].numpy(), want, rtol=1e-3)
    else:
        assert tm.params["huber_delta"] is None


@pytest.mark.parametrize("loss", ["huber", "quantile", "logcosh"])
def test_regressor_validation_loss_per_loss(loss):
    """The early-stop validation loss (``_patience_step``) for each loss,
    huber at each round's delta; quantile on its first round (see the
    module docstring)."""
    X, y = _reg_data(seed=9)
    vi = np.zeros(len(y), bool)
    vi[::4] = True
    kw = dict(num_base_learners=3, learning_rate=0.5, loss=loss, num_rounds=3)
    jm = se.GBMRegressor(base_learner=_tree(se, "scatter"), **kw).fit(
        X, y, validation_indicator=vi)
    tm = st.GBMRegressor(base_learner=_tree(st, "scatter"), **kw).fit(
        X, y, validation_indicator=vi, device="cpu")
    rounds = 1 if loss in SIGN_GRADIENT else 3
    np.testing.assert_allclose(tm.validation_history_[:rounds],
                               jm.validation_history_[:rounds], rtol=1e-3)
    assert tm.num_members == jm.num_members


@pytest.mark.parametrize("loss,hist", [("bernoulli", "scatter"), ("bernoulli", "fused"),
                                       ("exponential", "scatter"), ("exponential", "fused")])
def test_binary_classifier_losses_match(loss, hist):
    X, y = _bin_data()
    kw = dict(num_base_learners=3, learning_rate=0.5, loss=loss, updates="newton")
    jm = se.GBMClassifier(base_learner=_tree(se, hist), **kw).fit(X, y)
    tm = st.GBMClassifier(base_learner=_tree(st, hist), **kw).fit(X, y, device="cpu")
    assert tm.dim == 1 and tm.params["weights"].shape == (3, 1)
    np.testing.assert_allclose(tm.params["init_raw"].numpy(),
                               np.asarray(jm.params["init_raw"]), rtol=1e-6)
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-3)
    raw = tm.predict_raw(X).numpy()
    np.testing.assert_array_equal(raw[:, 0], -raw[:, 1])
    np.testing.assert_array_equal(tm.predict(X).numpy(), np.asarray(jm.predict(X)))


@pytest.mark.parametrize("strategy,q", [("median", 0.5), ("quantile", 0.3),
                                        ("quantile", 0.9)])
def test_dummy_median_and_quantile_exact(strategy, q):
    rng = np.random.RandomState(11)
    X = rng.randn(301, 3).astype(np.float32)
    y = np.round(rng.randn(301) * 4).astype(np.float32)  # many ties
    w = rng.randint(0, 4, size=301).astype(np.float32)
    jm = se.DummyRegressor(strategy=strategy, quantile=q).fit(X, y, sample_weight=w)
    tm = st.DummyRegressor(strategy=strategy, quantile=q).fit(
        X, y, sample_weight=w, device="cpu")
    np.testing.assert_array_equal(tm.predict(X).numpy(), np.asarray(jm.predict(X)))


@pytest.mark.parametrize("loss", ["absolute", "huber", "quantile"])
def test_newton_falls_back_to_gradient_without_a_hessian(loss):
    X, y = _reg_data(seed=5)
    kw = dict(num_base_learners=3, learning_rate=0.5, loss=loss,
              base_learner=_tree(st, "scatter"))
    newton = st.GBMRegressor(updates="newton", **kw).fit(X, y, device="cpu")
    grad = st.GBMRegressor(updates="gradient", **kw).fit(X, y, device="cpu")
    np.testing.assert_array_equal(newton.predict(X).numpy(), grad.predict(X).numpy())
    assert not st.ops.losses.get_regression_loss(loss).has_hessian


def test_new_losses_carry_across_convert():
    """A fitted JAX GBM with a new loss predicts the same in the port: the
    loss and alpha travel in the params dict, the median init as its value."""
    X, y = _reg_data(seed=6)
    jm = se.GBMRegressor(num_base_learners=3, loss="huber", alpha=0.7,
                         base_learner=_tree(se, "scatter")).fit(X, y)
    arrays = {f: np.asarray(getattr(jm.params["members"], f))
              for f in st.ops.tree.Tree._fields}
    arrays.update(weights=np.asarray(jm.params["weights"]),
                  init=np.asarray(jm.params["init"]["value"]))
    tm = st.gbm_regressor_from_arrays(jm.get_params(), arrays,
                                      num_features=X.shape[1], device="cpu")
    assert (tm.loss, tm.alpha) == ("huber", 0.7)
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               rtol=1e-6, atol=1e-6)
    Xc, yc = _bin_data(seed=8)
    jc = se.GBMClassifier(num_base_learners=3, loss="bernoulli",
                          base_learner=_tree(se, "scatter")).fit(Xc, yc)
    arrays = {f: np.asarray(getattr(jc.params["members"], f))
              for f in st.ops.tree.Tree._fields}
    arrays.update(weights=np.asarray(jc.params["weights"]),
                  init_raw=np.asarray(jc.params["init_raw"]))
    tc = st.gbm_classifier_from_arrays(jc.get_params(), arrays,
                                       num_features=Xc.shape[1], num_classes=2,
                                       device="cpu")
    np.testing.assert_allclose(tc.predict_proba(Xc).numpy(),
                               np.asarray(jc.predict_proba(Xc)), rtol=1e-6, atol=1e-6)
    assert torch.equal(tc.predict(Xc), torch.as_tensor(np.asarray(jc.predict(Xc))))
