"""PyTorch port parity: histogram forest fit and predict
(``spark_ensemble_tpu_torch/ops/tree.py`` vs ``ops/tree.py``).

Fixtures are tie-free dyadic rationals (the recipe of
tests/test_pallas_hist.py): every f32 sum is exact in any order and the
bf16 splits of the kernel tiers are exact, so split tables and leaf ids are
array-equal per tier; leaf values are held to rtol 1e-4 / atol 1e-5 (the
JAX package's own pin).  The pallas tier's JAX counterpart runs its kernel
in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_ensemble_tpu.ops import tree as jt
from spark_ensemble_tpu.ops.binning import bin_features, compute_bins
from spark_ensemble_tpu_torch.ops import tree as tt

TREE_FIELDS = ("split_feature", "split_bin", "split_threshold")


def _fixture(seed, n, d, M, k, B):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    bins = compute_bins(jnp.asarray(X), B)
    Xb = np.array(bin_features(jnp.asarray(X), bins))
    Y = (rng.randint(-16, 17, size=(n, M, k)) / 8.0).astype(np.float32)
    w = (rng.randint(0, 3, size=(n, M)) / 2.0).astype(np.float32)
    return X, Xb, np.array(bins.thresholds), Y, w


def _assert_same_forest(jtree, ttree):
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(
            getattr(ttree, f).numpy(), np.asarray(getattr(jtree, f)), err_msg=f
        )
    np.testing.assert_allclose(
        ttree.leaf_value.numpy(), np.asarray(jtree.leaf_value),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        ttree.split_gain.numpy(), np.asarray(jtree.split_gain),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize(
    "hist,hist_precision",
    [("scatter", "highest"), ("matmul", "highest"), ("matmul", "pallas"),
     ("fused", "highest"), ("fused", "pallas")],
)
def test_fit_forest_matches_per_tier(hist, hist_precision):
    X, Xb, thr, Y, w = _fixture(2, 600, 6, 3, 1, 16)
    kw = dict(max_depth=3, max_bins=16, hist=hist,
              hist_precision=hist_precision, return_leaf=True)
    jtree, jnode = jt.fit_forest(jnp.asarray(Xb), jnp.asarray(Y),
                                 jnp.asarray(w), jnp.asarray(thr), **kw)
    ttree, tnode = tt.fit_forest(torch.as_tensor(Xb), torch.as_tensor(Y),
                                 torch.as_tensor(w), torch.as_tensor(thr), **kw)
    _assert_same_forest(jtree, ttree)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))


@pytest.mark.parametrize("hist", ["scatter", "matmul", "fused"])
def test_fit_tree_matches_single_tree(hist):
    """The regressor's single tree: fit_forest with M=1, k=1, and a
    feature mask."""
    X, Xb, thr, Y, w = _fixture(5, 500, 5, 1, 1, 16)
    mask = np.array([True, False, True, True, True])
    kw = dict(max_depth=3, max_bins=16, hist=hist, return_leaf=True)
    jtree, jnode = jt.fit_tree(jnp.asarray(Xb), jnp.asarray(Y[:, 0]),
                               jnp.asarray(w[:, 0]), jnp.asarray(thr),
                               jnp.asarray(mask), **kw)
    ttree, tnode = tt.fit_tree(torch.as_tensor(Xb), torch.as_tensor(Y[:, 0]),
                               torch.as_tensor(w[:, 0]), torch.as_tensor(thr),
                               torch.as_tensor(mask), **kw)
    _assert_same_forest(jtree, ttree)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))
    assert not (ttree.split_feature.numpy() == 1).any()


def test_split_choice_takes_the_first_of_planted_ties():
    """Equal gains planted at several (feature, bin) candidates: both
    packages pick the first over the flat (d, B-1) axis; a node whose best
    gain does not beat min_info_gain stores the sentinel bin B-1 and an
    infinite threshold."""
    M, n_nodes, C, d, B = 2, 2, 2, 3, 4
    H = np.zeros((M, n_nodes, C, d, B), np.float32)
    for f in range(d):  # identical histograms in every feature -> ties
        H[0, 0, 0, f] = [1, 1, 1, 1]
        H[0, 0, 1, f] = [2, -2, 2, -2]
        H[1, 0, 0, f] = [2, 0, 0, 2]
        H[1, 0, 1, f] = [1, 0, 0, -1]
    H[:, 1, 0] = 1.0  # node 1: no gain anywhere -> no split
    mask = np.ones((M, d), bool)
    floor = np.full((M, n_nodes), 1e-12, np.float32)
    thr = np.arange(d * (B - 1), dtype=np.float32).reshape(d, B - 1)
    j = jt._level_split_tables(
        jnp.asarray(H), jnp.asarray(mask), jnp.asarray(floor), 0.0,
        jnp.asarray(thr), B, jax_highest(), "matmul",
    )
    t = tt._level_split_tables(
        torch.as_tensor(H), torch.as_tensor(mask), torch.as_tensor(floor), 0.0,
        torch.as_tensor(thr), B, False,
    )
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    best_f, best_t, thr_out, do_split = (x.numpy() for x in t[:4])
    assert best_f[0, 0] == 0 and best_f[1, 0] == 0  # first of the tied features
    assert not do_split[:, 1].any()
    assert (best_t[:, 1] == B - 1).all() and np.isinf(thr_out[:, 1]).all()


def jax_highest():
    import jax

    return jax.lax.Precision.HIGHEST


def test_predict_forest_matches_exactly_with_non_finite_rows():
    X, Xb, thr, Y, w = _fixture(7, 400, 5, 4, 2, 16)
    kw = dict(max_depth=3, max_bins=16, hist="scatter")
    jtree = jt.fit_forest(jnp.asarray(Xb), jnp.asarray(Y), jnp.asarray(w),
                          jnp.asarray(thr), **kw)
    ttree = tt.Tree(*(torch.as_tensor(np.asarray(a)) for a in jtree))
    Xq = np.random.RandomState(8).randn(300, 5).astype(np.float32)
    Xq[0, :] = np.nan
    Xq[1, :] = np.inf
    Xq[2, :] = -np.inf
    want = np.asarray(jt.predict_forest(jtree, jnp.asarray(Xq)))
    got = tt.predict_forest(ttree, torch.as_tensor(Xq)).numpy()
    np.testing.assert_array_equal(got, want)
    one = tt.Tree(*(a[1] for a in ttree))
    np.testing.assert_array_equal(
        tt.predict_tree(one, torch.as_tensor(Xq)).numpy(),
        np.asarray(jt.predict_tree(jt.Tree(*(a[1] for a in jtree)), jnp.asarray(Xq))),
    )


@pytest.mark.parametrize(
    "hist,hist_precision,n,B,exc",
    [
        ("fused", "highest", 100, 300, ValueError),
        ("stream", "highest", 100, 16, NotImplementedError),
        ("stream", "high", 100, 16, NotImplementedError),
        ("stream", "default", 100, 16, NotImplementedError),
    ],
)
def test_unported_tiers_raise(hist, hist_precision, n, B, exc):
    with pytest.raises(exc):
        tt.resolve_forest_tier(hist, hist_precision, "cpu", n, 4, B)


def test_tier_resolution_follows_the_reference():
    r = tt.resolve_forest_tier
    assert r("auto", "highest", "cpu", 100, 4, 16) == "scatter"
    assert r("auto", "pallas", "cpu", 100, 4, 16) == "pallas"
    assert r("matmul", "pallas", "cpu", 100, 4, 16) == "pallas"
    assert r("fused", "pallas", "cpu", 100, 4, 256) == "fused"
    assert r("scatter", "pallas", "cpu", 100, 4, 16) == "scatter"


def test_single_tree_pallas_precision_raises():
    """It no longer raises: a single tree at "pallas" runs on the 'high'
    matmul tier (histogram subtraction), as the JAX package's fit_tree."""
    X, Xb, thr, Y, w = _fixture(9, 64, 3, 1, 1, 8)
    kw = dict(max_depth=2, max_bins=8, hist="matmul", hist_precision="pallas")
    jtree = jt.fit_tree(jnp.asarray(Xb), jnp.asarray(Y[:, 0]),
                        jnp.asarray(w[:, 0]), jnp.asarray(thr), **kw)
    ttree = tt.fit_tree(torch.as_tensor(Xb), torch.as_tensor(Y[:, 0]),
                        torch.as_tensor(w[:, 0]), torch.as_tensor(thr), **kw)
    _assert_same_forest(jtree, ttree)
