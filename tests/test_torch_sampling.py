"""PyTorch port parity: GBM's gradient-based row sampling
(``spark_ensemble_tpu_torch/models/gbm.py`` vs ``models/gbm.py``):
compacted GOSS/MVS (``sampling``) and the legacy weight-mask GOSS
(``sample_method="goss"``).

- ``_sample_pow2_bucket`` gives the JAX package's buckets.
- ``_sample_compact`` from the same key: GOSS's ``idx`` and ``mult`` are
  array-equal, with dead rows and tied scores.  MVS's ``idx`` is
  array-equal and its ``mult = mu / s`` within rtol 1e-6: ``mu`` comes
  from a bisection over an f32 sum, and the two libraries sum in their own
  order, which can flip a late bisection step when the sum lands within an
  ulp of ``k_rand`` (a shift of a few ulps in ``mu``).
- ``_goss_multiplier`` is array-equal.
- 3-round fits at ``sampling="goss"``, ``"mvs"`` and ``sample_method="goss"``
  (scatter tier) are held to the JAX package's pin: predictions within
  1e-3 of the label scale (regressor), probabilities within 1e-3
  (classifier).  The classifier's fixture is depth 2 with dyadic sample
  weights: a tree fitted on a gathered subset of a few hundred rows ties
  two features' partitions exactly more often at depth 3 (round 0's
  gradients are equal within a class), and each package breaks such a tie
  by its own rounding.
- ``sampling="none"`` never reaches the sampling code and is array-equal
  to a fit with the default Params.
- Mixing ``sampling`` with ``sample_method="goss"`` raises ValueError, as
  in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.models import gbm as jg
from spark_ensemble_tpu_torch.models import gbm as tg
from spark_ensemble_tpu_torch.utils import random as rnd


@pytest.mark.parametrize(
    "n,k,floor",
    [(600, 180, 256), (600, 180, 64), (100, 30, 256), (15000, 4500, 256),
     (15000, 15000, 256), (1, 1, 1), (5000, 0, 16), (4096, 1025, 256)],
)
def test_pow2_bucket_matches_the_reference(n, k, floor):
    assert tg._sample_pow2_bucket(n, k, floor) == jg._sample_pow2_bucket(n, k, floor)


def _scores(n, seed):
    """Gradient norms with a block of exact ties and 10% dead rows."""
    rng = np.random.RandomState(seed)
    score = np.abs(rng.randn(n)).astype(np.float32)
    score[10:40] = score[5]
    score[100:110] = 0.0
    return score, rng.rand(n) > 0.1


def _compact_both(method, score, alive, samp, m, seed):
    jsamp = (jnp.asarray(samp[0], jnp.int32), jnp.asarray(samp[1], jnp.int32),
             jnp.asarray(samp[2], jnp.float32), jnp.asarray(samp[3], jnp.float32))
    ji, jm = jg._sample_compact(method, jnp.asarray(score), jnp.asarray(alive),
                                jax.random.fold_in(jax.random.PRNGKey(seed), 11),
                                m, jsamp)
    ti, tm = tg._sample_compact(method, torch.as_tensor(score), torch.as_tensor(alive),
                                rnd.fold_in(rnd.PRNGKey(seed), 11), m, samp)
    return (np.asarray(ji), np.asarray(jm)), (ti.numpy(), tm.numpy())


@pytest.mark.parametrize("n,top,other,seed", [(600, 0.2, 0.1, 0), (700, 0.3, 0.2, 1),
                                              (257, 0.1, 0.5, 2)])
def test_goss_selection_equals_the_reference(n, top, other, seed):
    score, alive = _scores(n, seed)
    k_top, k_rand = int(np.ceil(top * n)), int(np.ceil(other * n))
    samp = (k_top, k_rand, (1.0 - top) / other, 0.0)
    m = tg._sample_pow2_bucket(n, k_top + k_rand, 64)
    (ji, jm), (ti, tm) = _compact_both("goss", score, alive, samp, m, seed)
    assert tm.dtype == np.float32 and ti.shape == (m,)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    # the top rows lead the buffer at weight 1; dead rows weigh 0
    assert (tm[:k_top] == 1.0).all()
    assert (tm[~alive[ti]] == 0.0).all()


@pytest.mark.parametrize("n,rate,lam,seed", [(600, 0.3, 0.1, 0), (700, 0.5, 0.0, 1),
                                             (257, 0.2, 1.0, 2)])
def test_mvs_selection_equals_the_reference(n, rate, lam, seed):
    score, alive = _scores(n, seed)
    samp = (0, int(np.ceil(rate * n)), 0.0, lam)
    m = tg._sample_pow2_bucket(n, samp[1], 64)
    (ji, jm), (ti, tm) = _compact_both("mvs", score, alive, samp, m, seed)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm > 0, jm > 0)  # the kept set
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)
    assert (tm[~alive[ti]] == 0.0).all()


@pytest.mark.parametrize("top,other", [(0.2, 0.1), (0.3, 0.5), (0.0, 0.4)])
def test_goss_multiplier_equals_the_reference(top, other):
    rng = np.random.RandomState(7)
    ng = rng.randn(500, 3).astype(np.float32)
    w = (rng.randint(1, 5, size=500) / 4).astype(np.float32)
    bag = (rng.rand(500) > 0.2).astype(np.float32)
    jm = jg._goss_multiplier(jnp.asarray(ng), jnp.asarray(w), jnp.asarray(bag),
                             jax.random.PRNGKey(5), top, other, None)
    tm = tg._goss_multiplier(torch.as_tensor(ng), torch.as_tensor(w),
                             torch.as_tensor(bag), rnd.PRNGKey(5), top, other)
    assert tm.dtype == torch.float32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _reg_data(n=600, d=6, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = 2.0 * X[:, 0] + np.sin(3.0 * X[:, 1]) + 0.1 * rng.randn(n)
    return X, y.astype(np.float32)


def _cls_data(n=700, d=6, k=3, seed=15):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T, axis=1).astype(np.float32)
    sw = (np.random.RandomState(3).randint(1, 64, size=n) / 16).astype(np.float32)
    return X, y, sw


SAMPLED = [dict(sampling="goss"), dict(sampling="mvs"), dict(sample_method="goss"),
           dict(sampling="goss", top_rate=0.3, other_rate=0.2),
           dict(sampling="mvs", mvs_lambda=1.0)]


@pytest.mark.parametrize("params", SAMPLED)
def test_sampled_regressor_matches_the_reference(params):
    X, y = _reg_data()
    kw = dict(num_base_learners=3, learning_rate=0.5, **params)

    def tree(pkg):
        return pkg.DecisionTreeRegressor(hist="scatter", max_depth=3, max_bins=16)

    jm = se.GBMRegressor(base_learner=tree(se), **kw).fit(X, y)
    tm = st.GBMRegressor(base_learner=tree(st), **kw).fit(X, y, device="cpu")
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-3 * np.abs(y).max())
    np.testing.assert_allclose(tm.params["weights"].numpy(),
                               np.asarray(jm.params["weights"]), rtol=1e-3)


@pytest.mark.parametrize("params", SAMPLED)
def test_sampled_classifier_matches_the_reference(params):
    X, y, sw = _cls_data()
    kw = dict(num_base_learners=3, learning_rate=0.3, updates="newton", **params)

    def tree(pkg):
        return pkg.DecisionTreeRegressor(hist="scatter", max_depth=2, max_bins=16)

    jm = se.GBMClassifier(base_learner=tree(se), **kw).fit(X, y, sample_weight=sw)
    tm = st.GBMClassifier(base_learner=tree(st), **kw).fit(X, y, sample_weight=sw,
                                                           device="cpu")
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-3)


@pytest.mark.parametrize("hist", ["fused", "matmul"])
def test_sampled_fit_on_the_kernel_tiers_matches(hist):
    """The fused tier repacks the gathered bins at the bucket's row count;
    at the pin size (regressor, goss) both tiers hold the JAX package's
    pin, as the scatter tier does."""
    X, y = _reg_data()
    kw = dict(num_base_learners=3, learning_rate=0.5, sampling="goss")

    def tree(pkg):
        return pkg.DecisionTreeRegressor(hist=hist, max_depth=3, max_bins=16)

    jm = se.GBMRegressor(base_learner=tree(se), **kw).fit(X, y)
    tm = st.GBMRegressor(base_learner=tree(st), **kw).fit(X, y, device="cpu")
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-3 * np.abs(y).max())


def test_sampled_fit_is_deterministic_and_differs_from_uniform():
    X, y = _reg_data()
    kw = dict(num_base_learners=3, learning_rate=0.5)
    a = st.GBMRegressor(sampling="mvs", **kw).fit(X, y, device="cpu").predict(X)
    b = st.GBMRegressor(sampling="mvs", **kw).fit(X, y, device="cpu").predict(X)
    c = st.GBMRegressor(**kw).fit(X, y, device="cpu").predict(X)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("estimator", ["regressor", "classifier"])
def test_none_is_the_unsampled_fit(monkeypatch, estimator):
    """sampling='none' (with sample_method='uniform' and constant leaves)
    never reaches the sampling code, and its fit is array-equal to a fit
    with the default Params."""
    def unreachable(*a, **k):
        raise AssertionError("the sampling code ran at sampling='none'")

    for name in ("_sample_compact", "_goss_multiplier", "_sample_pow2_bucket"):
        monkeypatch.setattr(tg, name, unreachable)
    explicit = dict(sampling="none", sample_method="uniform", leaf_model="constant")
    if estimator == "regressor":
        X, y = _reg_data()
        a = st.GBMRegressor(num_base_learners=3, **explicit).fit(X, y, device="cpu")
        b = st.GBMRegressor(num_base_learners=3).fit(X, y, device="cpu")
        assert torch.equal(a.predict(X), b.predict(X))
    else:
        X, y, _ = _cls_data()
        a = st.GBMClassifier(num_base_learners=3, **explicit).fit(X, y, device="cpu")
        b = st.GBMClassifier(num_base_learners=3).fit(X, y, device="cpu")
        assert torch.equal(a.predict_proba(X), b.predict_proba(X))


@pytest.mark.parametrize("sampling", ["goss", "mvs"])
def test_mixing_the_two_knobs_raises_as_the_reference(sampling):
    X, y = _reg_data(n=100)
    kw = dict(num_base_learners=1, sampling=sampling, sample_method="goss")
    with pytest.raises(ValueError, match="supersedes"):
        se.GBMRegressor(**kw).fit(X, y)
    with pytest.raises(ValueError, match="supersedes"):
        st.GBMRegressor(**kw).fit(X, y, device="cpu")
    with pytest.raises(ValueError, match="supersedes"):
        st.GBMClassifier(**kw).fit(X, (y > 0).astype(np.float32), device="cpu")


def test_dead_rows_never_survive(monkeypatch):
    """Rows of zero weight may fill the bucket only at weight 0: the
    sampled fit's gathered rows carry positive weight only where the row
    is alive."""
    X, y = _reg_data()
    sw = np.ones(600, np.float32)
    sw[:300] = 0.0
    seen = []
    real = tg._sample_compact

    def spy(method, score, alive, key, m, samp):
        idx, mult = real(method, score, alive, key, m, samp)
        seen.append((alive[idx], mult))
        return idx, mult

    monkeypatch.setattr(tg, "_sample_compact", spy)
    st.GBMRegressor(num_base_learners=2, sampling="goss").fit(
        X, y, sample_weight=sw, device="cpu")
    assert len(seen) == 2
    for alive_g, mult in seen:
        assert (mult[~alive_g] == 0).all()
        assert (mult[alive_g] > 0).any()
