"""PyTorch port parity: the fast precisions "high" and "default" on the
matmul tier, with histogram subtraction (``spark_ensemble_tpu_torch/ops/
tree.py`` vs ``ops/tree.py``).

JAX on the CPU ignores ``Precision``: its "high" and "default" compute in
f32 here, while the port's "default" rounds the statistic operands to
bf16.  So:

- "high" is held split-table array-equal to the JAX package on the
  tie-free dyadic fixture of tests/test_torch_tree.py (every f32 sum exact
  in any order), leaf values within rtol 1e-4 / atol 1e-5;
- "default" is held array-equal on a fixture whose statistics are
  bf16-exact: weights in {1, 2}, small-integer targets in mirrored pairs
  (mean exactly 0), and histogram cells below 256 in magnitude, so the
  rounding is the identity there;
- on generic data the port's "default" rounds: the rounding is bf16's
  round-to-nearest-even (bit-equal to the JAX package's f32 -> bf16
  cast), visible in the level-0 histogram within 2^-8 relative, and GBM
  at "default" is held to the port's "high" on accuracy (within 0.02);
- an empty right child on the subtraction path records no split and the
  fallback value, as in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.ops import tree as jt
from spark_ensemble_tpu.ops.binning import bin_features, compute_bins
from spark_ensemble_tpu_torch.ops import tree as tt

SPLITS = ("split_feature", "split_bin", "split_threshold")


def _binned(X, B):
    bins = compute_bins(jnp.asarray(X), B)
    return np.array(bin_features(jnp.asarray(X), bins)), np.array(bins.thresholds)


def _dyadic(seed, n, d, M, B):
    rng = np.random.RandomState(seed)
    Xb, thr = _binned(rng.randn(n, d).astype(np.float32), B)
    Y = (rng.randint(-16, 17, size=(n, M, 1)) / 8.0).astype(np.float32)
    w = (rng.randint(0, 3, size=(n, M)) / 2.0).astype(np.float32)
    return Xb, thr, Y, w


def _bf16_exact(seed, n, d, M, B):
    """Integer targets in mirrored pairs with paired weights in {1, 2}:
    the weighted mean is exactly 0 and every statistic a small integer."""
    rng = np.random.RandomState(seed)
    Xb, thr = _binned(rng.randn(n, d).astype(np.float32), B)
    h = n // 2
    v = rng.randint(-3, 4, size=(h, M, 1)).astype(np.float32)
    wv = rng.randint(1, 3, size=(h, M)).astype(np.float32)
    perm = rng.permutation(n)
    return Xb, thr, np.concatenate([v, -v])[perm], np.concatenate([wv, wv])[perm]


def _fit_both(fn, Xb, Y, w, thr, **kw):
    j = getattr(jt, fn)(jnp.asarray(Xb), jnp.asarray(Y), jnp.asarray(w),
                        jnp.asarray(thr), return_leaf=True, **kw)
    t = getattr(tt, fn)(torch.as_tensor(Xb), torch.as_tensor(Y), torch.as_tensor(w),
                        torch.as_tensor(thr), return_leaf=True, **kw)
    return j, t


def _assert_same(j, t):
    (jtree, jnode), (ttree, tnode) = j, t
    for f in SPLITS:
        np.testing.assert_array_equal(getattr(ttree, f).numpy(),
                                      np.asarray(getattr(jtree, f)), err_msg=f)
    for f in ("leaf_value", "split_gain"):
        np.testing.assert_allclose(getattr(ttree, f).numpy(),
                                   np.asarray(getattr(jtree, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))


@pytest.mark.parametrize(
    "fixture,hp,hist",
    [(_dyadic, "high", "matmul"), (_bf16_exact, "high", "matmul"),
     (_bf16_exact, "default", "matmul"), (_bf16_exact, "default", "fused"),
     (_dyadic, "high", "fused")],
)
def test_fit_forest_fast_tiers_match(fixture, hp, hist):
    Xb, thr, Y, w = fixture(2, 600, 6, 3, 16)
    kw = dict(max_depth=3, max_bins=16, hist=hist, hist_precision=hp)
    _assert_same(*_fit_both("fit_forest", Xb, Y, w, thr, **kw))


@pytest.mark.parametrize("fixture,hp", [(_dyadic, "high"), (_bf16_exact, "default")])
def test_fit_tree_fast_tiers_match(fixture, hp):
    """The single tree, with a feature mask; ``fit_tree`` is the JAX
    package's own single-tree loop, not its forest."""
    Xb, thr, Y, w = fixture(5, 500, 5, 1, 16)
    mask = np.array([True, True, False, True, True])
    kw = dict(max_depth=3, max_bins=16, hist="matmul", hist_precision=hp)
    j = jt.fit_tree(jnp.asarray(Xb), jnp.asarray(Y[:, 0]), jnp.asarray(w[:, 0]),
                    jnp.asarray(thr), jnp.asarray(mask), return_leaf=True, **kw)
    t = tt.fit_tree(torch.as_tensor(Xb), torch.as_tensor(Y[:, 0]),
                    torch.as_tensor(w[:, 0]), torch.as_tensor(thr),
                    torch.as_tensor(mask), return_leaf=True, **kw)
    _assert_same(j, t)


@pytest.mark.parametrize("hp", ["high", "default"])
def test_empty_right_child_on_the_subtraction_path(hp):
    """Feature 0 splits the root; the left child is pure, so it does not
    split and its right child (level 2) is empty: derived as parent - left,
    it must record no split (bin B-1, +inf, gain 0) and the fallback value."""
    rng = np.random.RandomState(3)
    n, B = 512, 16
    left = np.arange(n) < n // 2
    X = rng.randn(n, 4).astype(np.float32)
    X[:, 0] = np.where(left, -1.0, 1.0)
    Xb, thr = _binned(X, B)
    # left rows -1, right rows 0 and 2 in equal numbers: the weighted mean
    # is exactly 0 and no histogram cell exceeds 256, so every statistic
    # is bf16-exact
    zeros = rng.permutation(np.arange(n // 2, n))[: n // 4]
    Y = np.where(left, -1.0, 2.0).astype(np.float32)
    Y[zeros] = 0.0
    w = np.ones(n, np.float32)
    kw = dict(max_depth=3, max_bins=B, hist="matmul", hist_precision=hp)
    j, t = _fit_both("fit_tree", Xb, Y[:, None], w, thr, **kw)
    _assert_same(j, t)
    tree = t[0]
    assert int(tree.split_feature[0]) == 0 and float(tree.split_gain[1]) == 0.0
    empty = 4  # heap index of level 2's node 1: the left child's right child
    assert int(tree.split_bin[empty]) == B - 1
    assert float(tree.split_threshold[empty]) == float("inf")
    assert float(tree.split_gain[empty]) == 0.0
    assert float(tree.leaf_value[2, 0]) == pytest.approx(-1.0)


def test_bf16_rounding_is_the_reference_cast():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.randint(-3, 4, size=4096)).astype(np.float32)
    x[:4] = [1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8), 0.0]  # ties to even
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(tt._bf16_round(torch.as_tensor(x)).numpy(), want)


def test_default_rounding_is_visible_and_bounded():
    """On generic statistics the 'default' level-0 histogram differs from
    the 'high' one, by at most 2^-8 of the cell's own magnitude (one bf16
    rounding of each row's statistic)."""
    rng = np.random.RandomState(1)
    n, d, B = 700, 5, 16
    Xb, _ = _binned(rng.randn(n, d).astype(np.float32), B)
    Xb = torch.as_tensor(Xb)
    vals = torch.as_tensor(np.stack([rng.rand(n, 2), rng.randn(n, 2)], axis=2)
                           .astype(np.float32))
    node = torch.zeros((n, 2), dtype=torch.int32)
    oh = tt._bin_one_hot(Xb, B)
    high = tt._level_hist("matmul", Xb, oh, node, vals, 1, B)
    default = tt._level_hist("matmul", Xb, oh, node, tt._bf16_round(vals), 1, B)
    absolute = tt._level_hist("matmul", Xb, oh, node, vals.abs(), 1, B)
    gap = (default - high).abs()
    assert float(gap.max()) > 0.0
    assert bool((gap <= 2.0**-8 * absolute + 1e-6).all())


def _gbm(pkg, hp, **kw):
    return pkg.GBMClassifier(
        num_base_learners=3, learning_rate=0.3, updates="newton",
        base_learner=pkg.DecisionTreeRegressor(hist="matmul", hist_precision=hp,
                                               max_depth=3, max_bins=16), **kw,
    )


def _cls_data(n=600, d=8, k=4, seed=15):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T, axis=1)
    return X, y.astype(np.float32)


def test_gbm_at_high_matches_the_reference():
    X, y = _cls_data()
    jm = _gbm(se, "high").fit(X, y)
    tm = _gbm(st, "high").fit(X, y, device="cpu")
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-3)


def test_gbm_at_default_holds_accuracy_against_high():
    X, y = _cls_data(seed=16)
    high = _gbm(st, "high").fit(X, y, device="cpu")
    default = _gbm(st, "default").fit(X, y, device="cpu")
    acc = [float((m.predict(X).numpy() == y).mean()) for m in (high, default)]
    assert abs(acc[0] - acc[1]) <= 0.02
    assert not torch.equal(high.predict_proba(X), default.predict_proba(X))


@pytest.mark.parametrize("hp", ["high", "default"])
def test_trees_accept_the_fast_precisions(hp):
    X, y = _cls_data(n=300, seed=17)
    for cls in (st.DecisionTreeClassifier, st.DecisionTreeRegressor):
        model = cls(hist="matmul", hist_precision=hp, max_depth=3).fit(X, y, device="cpu")
        assert bool(torch.isfinite(model.predict(X)).all())
