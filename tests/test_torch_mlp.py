"""PyTorch port parity: the MLP base learners
(``spark_ensemble_tpu_torch/models/mlp.py`` vs the JAX package's).

- Initial weights: array-equal (Glorot-uniform through the port's
  ``utils/random.py``, one ``split`` per layer as in the JAX package).
- After a few full-batch Adam steps: classifier probabilities within
  1e-5, regressor predictions within 1e-5 of the label scale.  The two
  autodiff codes sum the gradients in their own orders, and Adam's
  normalized steps carry those last bits on; 50 steps on these fixtures
  stay inside the bound (about 2e-7 measured).
- The batched member fit (``fit_many_from_ctx``, one ``torch.bmm`` chain
  for every member) against one fit per member: within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.utils.random import PRNGKey


def _data(n=300, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * np.array([1.0, 10.0, 0.1, 1.0, 3.0, 1.0][:d])).astype(np.float32)
    y_cls = (np.digitize(X[:, 0] + 0.1 * X[:, 1], [-0.5, 0.6])).astype(np.float32)
    y_reg = (3.0 * X[:, 0] + 0.05 * X[:, 1] ** 2 + rng.randn(n)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.rand(n) < 0.1] = 0.0
    return X, y_cls, y_reg, w


@pytest.mark.parametrize("sizes", [(6, 16, 3), (6, 8, 5, 1), (4, 64, 26)])
@pytest.mark.parametrize("seed", [0, 7])
def test_init_weights_equal_the_reference(sizes, seed):
    jl = se.MLPClassifier()._init_net(jax.random.PRNGKey(seed), sizes)
    tl = st.MLPClassifier()._init_nets(PRNGKey(seed)[None], sizes)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b["W"][0].numpy(), np.asarray(a["W"]))
        np.testing.assert_array_equal(b["b"][0].numpy(), np.asarray(a["b"]))


@pytest.mark.parametrize("steps", [1, 50])
@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_classifier_probabilities_match(steps, activation):
    X, y, _, w = _data()
    kw = dict(hidden_layer_sizes=(16,), max_iter=steps, activation=activation, seed=3)
    jm = se.MLPClassifier(**kw).fit(X, y, sample_weight=w)
    tm = st.MLPClassifier(**kw).fit(X, y, sample_weight=w, device="cpu")
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-5)
    np.testing.assert_allclose(tm.predict_raw(X).numpy(),
                               np.asarray(jm.predict_raw(X)), atol=1e-4)


@pytest.mark.parametrize("hidden", [(16,), (8, 8)])
def test_regressor_predictions_match(hidden):
    X, _, y, w = _data()
    kw = dict(hidden_layer_sizes=hidden, max_iter=50, reg_param=1e-3)
    jm = se.MLPRegressor(**kw).fit(X, y, sample_weight=w)
    tm = st.MLPRegressor(**kw).fit(X, y, sample_weight=w, device="cpu")
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-5 * np.abs(y).max())
    for k in ("y_mu", "y_sd"):
        np.testing.assert_allclose(float(tm.params[k]), float(jm.params[k]), rtol=1e-6)


def test_member_protocol_with_mask_and_key_matches():
    """``fit_from_ctx`` with a feature mask and an explicit key, as an
    ensemble calls it."""
    X, y, _, w = _data()
    mask = np.array([True, False, True, True, False, True])
    kw = dict(hidden_layer_sizes=(8,), max_iter=20)
    jb, tb = se.MLPClassifier(**kw), st.MLPClassifier(**kw)
    jp = jb.fit_from_ctx(jb.make_fit_ctx(jnp.asarray(X), 3), jnp.asarray(y),
                         jnp.asarray(w), jnp.asarray(mask), jax.random.PRNGKey(11))
    tp = tb.fit_from_ctx(tb.make_fit_ctx(torch.as_tensor(X), 3), torch.as_tensor(y),
                         torch.as_tensor(w), torch.as_tensor(mask), key=PRNGKey(11))
    np.testing.assert_array_equal(tp["mask"].numpy(), np.asarray(jp["mask"]))
    np.testing.assert_allclose(tb.predict_proba_fn(tp, torch.as_tensor(X)).numpy(),
                               np.asarray(jb.predict_proba_fn(jp, jnp.asarray(X))),
                               atol=1e-5)


@pytest.mark.parametrize("cls", ["MLPClassifier", "MLPRegressor"])
def test_batched_members_match_one_fit_per_member(cls):
    X, y_cls, y_reg, w = _data(n=200)
    y = y_cls if cls == "MLPClassifier" else y_reg
    rng = np.random.RandomState(1)
    M = 4
    ys = torch.as_tensor(np.repeat(y[:, None], M, axis=1))
    ws = torch.as_tensor((w[:, None] * rng.randint(0, 3, (len(y), M))).astype(np.float32))
    masks = torch.as_tensor(rng.rand(M, X.shape[1]) < 0.7)
    keys = PRNGKey(5)[None].repeat(M, 1) + torch.arange(M)[:, None]
    learner = getattr(st, cls)(hidden_layer_sizes=(8,), max_iter=20)
    ctx = learner.make_fit_ctx(torch.as_tensor(X), 3)
    batched = learner.fit_many_from_ctx(ctx, ys, ws, masks, keys=keys)
    Xt = torch.as_tensor(X)
    many = learner.predict_many_fn(batched, Xt)
    for m in range(M):
        one = learner.fit_from_ctx(ctx, ys[:, m].contiguous(), ws[:, m].contiguous(),
                                   masks[m], key=keys[m])
        np.testing.assert_allclose(many[m].numpy(), learner.predict_fn(one, Xt).numpy(),
                                   atol=1e-5 * float(np.abs(y).max() + 1))


def test_params_names_defaults_and_cuda_default(monkeypatch):
    for name in ("MLPClassifier", "MLPRegressor"):
        jdefs, tdefs = getattr(se, name)._param_defs(), getattr(st, name)._param_defs()
        assert sorted(jdefs) == sorted(tdefs)
        for k, p in jdefs.items():
            assert tdefs[k].default == p.default, k
    with pytest.raises(ValueError):
        st.MLPClassifier(hidden_layer_sizes=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, _, _ = _data(n=40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.MLPClassifier(max_iter=1).fit(X, y)


def test_converted_mlp_models_predict_as_the_reference():
    X, y_cls, y_reg, _ = _data(n=200)
    jc = se.MLPClassifier(hidden_layer_sizes=(8, 4), max_iter=10).fit(X, y_cls)
    arrays = jax.tree_util.tree_map(np.asarray, jc.params)
    tc = st.mlp_classifier_from_arrays(jc.get_params(), arrays, num_features=6,
                                       num_classes=3, device="cpu")
    np.testing.assert_allclose(tc.predict_proba(X).numpy(),
                               np.asarray(jc.predict_proba(X)), atol=1e-6)
    jr = se.MLPRegressor(max_iter=10).fit(X, y_reg)
    tr = st.mlp_regressor_from_arrays(jr.get_params(),
                                      jax.tree_util.tree_map(np.asarray, jr.params),
                                      num_features=6, device="cpu")
    np.testing.assert_allclose(tr.predict(X).numpy(), np.asarray(jr.predict(X)),
                               atol=1e-5 * np.abs(y_reg).max())
