"""PyTorch port parity: the random draws (``spark_ensemble_tpu_torch/
utils/random.py`` vs ``jax.random`` and ``spark_ensemble_tpu/utils/
random.py``), the sampling plans built on them, and GBM with uniform row
and feature sampling.

Every draw is held array-equal to jax's on the same key: keys, 32-bit
bits, float32 uniforms, Bernoulli masks, randint and Poisson counts, at
several seeds, shapes of odd length and a fold_in data word past 2^31.
The sampled GBM fits are held to tests/test_torch_gbm.py's pins."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.utils import random as jr
from spark_ensemble_tpu_torch.utils import random as tr

SEEDS = [0, 7, -1, 2**31 + 5]
SHAPES = [(), (1,), (7,), (3, 5), (1001,)]


def _np(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for data in (0, 1, 12345, 2**31 + 3, 2**32 - 1):
        np.testing.assert_array_equal(tr.fold_in(tk, data).numpy(),
                                      _np(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(tr.split(tk, 5).numpy(), _np(jax.random.split(jk, 5)))
    np.testing.assert_array_equal(tr.member_keys(seed, 3).numpy(),
                                  _np(jr.member_keys(seed, 3)))
    # partitionable threefry: fold_in(key, i) is split(key, n)[i]
    np.testing.assert_array_equal(tr.fold_in(tk, 1).numpy(), tr.split(tk, 2)[1].numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli_randint_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(tr.random_bits(tk, shape).numpy(),
                                  _np(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(tr.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        tr.uniform(tk, shape, -2.0, 3.5).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.5)),
    )
    for p in (0.3, 0.5, 1.0):
        np.testing.assert_array_equal(tr.bernoulli(tk, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(jk, p, shape)))
    for lo, hi in ((0, 16), (0, 7), (-5, 100005), (3, 3)):
        np.testing.assert_array_equal(
            tr.randint(tk, shape, lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, shape, lo, hi)),
        )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lam", [0.3, 0.5, 1.0])
def test_poisson_equal_jax(seed, lam):
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    for shape in ((7,), (3, 5), (4097,)):
        np.testing.assert_array_equal(tr.poisson(tk, lam, shape).numpy(),
                                      np.asarray(jax.random.poisson(jk, lam, shape)))


def test_batched_keys_draw_as_jax_vmap():
    """Leading key axes batch a draw as jax's vmap does; the Poisson loop
    keeps running for the slowest key without moving the others."""
    jkeys = jax.random.split(jax.random.PRNGKey(3), 6)
    tkeys = torch.as_tensor(_np(jkeys))
    np.testing.assert_array_equal(
        tr.poisson(tkeys, 1.0, (333,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.poisson(k, 1.0, (333,)))(jkeys)),
    )
    np.testing.assert_array_equal(
        tr.uniform(tkeys, (2, 3)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2, 3)))(jkeys)),
    )


@pytest.mark.parametrize("ratio", [0.5, 0.05, 1.0])
def test_bootstrap_weights_and_subspace_masks_equal_jax(ratio):
    key = jax.random.PRNGKey(11)
    tkey = tr.PRNGKey(11)
    for repl in (True, False):
        np.testing.assert_array_equal(
            tr.bootstrap_weights(tkey, 501, repl, ratio).numpy(),
            np.asarray(jr.bootstrap_weights(key, 501, repl, ratio)),
        )
    for seed in range(6):  # ratio 0.05 on 9 features: the empty-draw fallback
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            tr.subspace_mask(tr.PRNGKey(seed), 9, ratio).numpy(),
            np.asarray(jr.subspace_mask(k, 9, ratio)),
        )


@pytest.mark.parametrize(
    "replacement,subsample_ratio,subspace_ratio",
    [(True, 1.0, 0.5), (True, 0.6, 1.0), (False, 0.7, 0.3)],
)
def test_bagging_member_plan_equals_jax(replacement, subsample_ratio, subspace_ratio):
    kw = dict(num_base_learners=5, replacement=replacement, seed=4,
              subsample_ratio=subsample_ratio, subspace_ratio=subspace_ratio)
    w = (np.random.RandomState(0).randint(1, 5, 301) / 4.0).astype(np.float32)
    jw, jm, jk = se.BaggingClassifier(**kw)._member_plan(301, 7, jnp.asarray(w))
    tw, tm, tk = st.BaggingClassifier(**kw)._member_plan(301, 7, torch.as_tensor(w))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tk.numpy(), _np(jk))


@pytest.mark.parametrize("replacement", [False, True])
def test_gbm_sampling_plan_equals_jax(replacement):
    kw = dict(num_base_learners=4, subsample_ratio=0.7, subspace_ratio=0.5,
              replacement=replacement, seed=9)
    est = se.GBMClassifier(**kw)
    bag_keys, masks = est._sampling_plan(257, 6)
    bags = np.asarray(est._make_bag_many_fn(257, 257)(bag_keys))
    sample = st.GBMClassifier(**kw)._sampling_plan(257, 6, torch.device("cpu"))
    for i in range(4):
        bag_w, mask = sample(i)
        np.testing.assert_array_equal(bag_w.numpy(), bags[i])
        np.testing.assert_array_equal(mask.numpy(), np.asarray(masks[i]))


def _cls_data(n=600, d=8, k=4, seed=15):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T, axis=1)
    return X, y.astype(np.float32)


@pytest.mark.parametrize("replacement", [False, True])
@pytest.mark.parametrize("hist", ["scatter", "fused"])
def test_sampled_gbm_classifier_matches(replacement, hist):
    """The pins of tests/test_torch_gbm.py: probabilities within 1e-3,
    train accuracy within 0.02, step sizes within rtol 1e-3."""
    X, y = _cls_data()
    kw = dict(num_base_learners=3, learning_rate=0.3, updates="newton",
              subsample_ratio=0.7, subspace_ratio=0.5, replacement=replacement)

    def tree(pkg):
        return pkg.DecisionTreeRegressor(hist=hist, max_depth=3, max_bins=16)

    jm = se.GBMClassifier(base_learner=tree(se), **kw).fit(X, y)
    tm = st.GBMClassifier(base_learner=tree(st), **kw).fit(X, y, device="cpu")
    np.testing.assert_array_equal(tm.params["members"].split_feature.numpy(),
                                  np.asarray(jm.params["members"].split_feature))
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-3)
    acc_j = np.mean(np.asarray(jm.predict(X)) == y)
    assert abs(np.mean(tm.predict(X).numpy() == y) - acc_j) < 0.02
    np.testing.assert_allclose(tm.params["weights"].numpy(),
                               np.asarray(jm.params["weights"]), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("replacement", [False, True])
def test_sampled_gbm_regressor_matches(replacement):
    rng = np.random.RandomState(4)
    X = rng.randn(500, 6).astype(np.float32)
    y = (2.0 * X[:, 0] + np.sin(3.0 * X[:, 1]) + 0.1 * rng.randn(500)).astype(np.float32)
    kw = dict(num_base_learners=3, learning_rate=0.5, subsample_ratio=0.7,
              subspace_ratio=0.5, replacement=replacement)

    def tree(pkg):
        return pkg.DecisionTreeRegressor(hist="scatter", max_depth=3, max_bins=16)

    jm = se.GBMRegressor(base_learner=tree(se), **kw).fit(X, y)
    tm = st.GBMRegressor(base_learner=tree(st), **kw).fit(X, y, device="cpu")
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-3 * np.abs(y).max())


NEW_MODULES = ["utils/random.py", "utils/quantile.py", "evaluation.py",
               "models/bagging.py", "models/boosting.py", "models/tree.py",
               "convert.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_the_jax_package(module):
    src = (Path(st.__file__).parent / module).read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(n.split(".")[0] in ("jax", "jaxlib", "spark_ensemble_tpu")
                       for n in names), (module, names)
