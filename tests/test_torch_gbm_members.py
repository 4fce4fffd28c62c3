"""PyTorch port parity: ``GBMClassificationModel.member(i, dim)`` and
``Tree.depth``/``num_outputs`` against the JAX package (``device="cpu"``).

Each model is fitted in the JAX package (3 rounds, depth 3, scatter tier,
n = 512 rows of dyadic features) and carried across with
``convert.gbm_classifier_from_arrays``, so both packages hold the same
trees: a 3-class and a binary ``logloss`` model (one class dim per class)
and a binary ``bernoulli`` model (one class dim).  A member's predict is
one tree's leaf lookup, with no float sum, so it is held array-equal.  The identity ``init_raw[d] + sum_i
weights[i, d] * member(i, d).predict(X) == raw[:, d]`` adds three f32
products in round order where ``predict_raw`` adds them through its own
weighted round sum: it is held to 1e-5 absolute plus 1e-6 relative.  For
the binary one-dimension losses (bernoulli, exponential) the class-dim
column is ``raw[:, 1]`` (``predict_raw`` is ``(-f, f)``)."""

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.utils import persist as jpersist

ROUNDS = 3


def _data(num_classes, n=512, d=6, seed=11):
    rng = np.random.RandomState(seed)
    X = (rng.randint(-64, 64, size=(n, d)) / 16.0).astype(np.float32)
    score = X[:, 0] - 0.5 * X[:, 2] + 0.75 * rng.randn(n)
    if num_classes == 2:
        return X, (score > 0).astype(np.float32)
    cuts = np.quantile(score, [1 / 3, 2 / 3])
    return X, np.digitize(score, cuts).astype(np.float32)


def _jax_fit(num_classes, loss="logloss"):
    X, y = _data(num_classes)
    jm = se.GBMClassifier(
        num_base_learners=ROUNDS, learning_rate=0.5, loss=loss,
        base_learner=se.DecisionTreeRegressor(hist="scatter", max_depth=3, max_bins=16),
    ).fit(X, y)
    return X, y, jm


def _arrays(jm):
    arrays = {f: np.asarray(getattr(jm.params["members"], f))
              for f in st.ops.tree.Tree._fields}
    arrays.update(weights=np.asarray(jm.params["weights"]),
                  masks=np.asarray(jm.params["masks"]),
                  init_raw=np.asarray(jm.params["init_raw"]))
    return arrays


def _convert(jm, X, num_classes):
    return st.gbm_classifier_from_arrays(
        jm.get_params(), _arrays(jm), num_features=X.shape[1],
        num_classes=num_classes, device="cpu",
    )


@pytest.fixture(scope="module", params=[(3, "logloss"), (2, "logloss"), (2, "bernoulli")],
                ids=["3class", "binary", "bernoulli"])
def pair(request):
    num_classes, loss = request.param
    X, y, jm = _jax_fit(num_classes, loss)
    return X, y, jm, _convert(jm, X, num_classes), num_classes


def _raw_column(model, X, d):
    raw = model.predict_raw(X)
    raw = torch.as_tensor(np.array(raw))
    return raw[:, 1] if model.dim == 1 and model.num_classes == 2 else raw[:, d]


def test_member_predict_equals_the_jax_package(pair):
    X, _, jm, tm, num_classes = pair
    assert tm.dim == jm.dim == (num_classes if tm.loss == "logloss" else 1)
    for i in range(ROUNDS):
        for d in range(tm.dim):
            tmem, jmem = tm.member(i, dim=d), jm.member(i, dim=d)
            assert type(tmem).__name__ == type(jmem).__name__ == "DecisionTreeRegressionModel"
            np.testing.assert_array_equal(tmem.predict(X).numpy(),
                                          np.asarray(jmem.predict(X)))


def test_members_add_up_to_predict_raw(pair):
    X, _, jm, tm, _ = pair
    for d in range(tm.dim):
        total = tm.params["init_raw"][d].expand(X.shape[0]).clone()
        for i in range(ROUNDS):
            total = total + tm.params["weights"][i, d] * tm.member(i, d).predict(X)
        raw = _raw_column(tm, X, d)
        torch.testing.assert_close(total, raw, rtol=1e-6, atol=1e-5)
        # the JAX package's own identity on the same trees
        torch.testing.assert_close(total, _raw_column(jm, X, d), rtol=1e-6, atol=1e-5)


def test_member_index_errors(pair):
    X, y, jm, tm, _ = pair
    for model in (tm, jm):
        with pytest.raises(IndexError):
            model.member(ROUNDS, 0)
        with pytest.raises(IndexError):
            model.member(0, dim=99)
        with pytest.raises(IndexError):
            model.member(-1, 0)
    with pytest.raises(IndexError, match="zero members"):
        tm.take(0).member(0, 0)
    arrays = {**_arrays(jm), "weights": np.zeros((0, tm.dim), np.float32)}
    empty = st.gbm_classifier_from_arrays(
        jm.get_params(), arrays, num_features=X.shape[1],
        num_classes=tm.num_classes, device="cpu",
    )
    with pytest.raises(IndexError, match="zero members"):
        empty.member(0, 0)
    tree = st.DecisionTreeClassifier(max_depth=2).fit(X, y, device="cpu")
    with pytest.raises(AttributeError):
        tree.member(0)


def _same_member(a, b):
    for fa, fb in zip(a.params, b.params):
        assert torch.equal(fa, fb)


def test_take_and_save_keep_the_members(pair, tmp_path):
    X, _, jm, tm, _ = pair
    for k in (1, ROUNDS):
        sub = tm.take(k)
        for d in range(tm.dim):
            _same_member(sub.member(k - 1, d), tm.member(k - 1, d))
    tm.save(str(tmp_path / "port"))
    loaded = st.load(str(tmp_path / "port"), device="cpu")
    jpersist.save(jm, str(tmp_path / "jax"))
    from_jax = st.load(str(tmp_path / "jax"), device="cpu")
    for i in range(ROUNDS):
        for d in range(tm.dim):
            ref = tm.member(i, d)
            _same_member(loaded.member(i, d), ref)
            _same_member(from_jax.member(i, d), ref)
            np.testing.assert_array_equal(from_jax.member(i, d).predict(X).numpy(),
                                          ref.predict(X).numpy())


def test_member_of_a_port_fit_and_its_resume():
    X, y = _data(3)
    est = st.GBMClassifier(
        num_base_learners=2, learning_rate=0.5,
        base_learner=st.DecisionTreeRegressor(hist="scatter", max_depth=3, max_bins=16),
    )
    tm = est.fit(X, y, device="cpu")
    resumed = tm.fit_resume(X, y, 1, device="cpu")
    for model, rounds in ((tm, 2), (resumed, 3)):
        for d in range(model.dim):
            total = model.params["init_raw"][d].expand(X.shape[0]).clone()
            for i in range(rounds):
                m = model.member(i, d)
                assert m.device == model.device
                assert all(t.device.type == "cpu" for t in m.params)
                total = total + model.params["weights"][i, d] * m.predict(X)
            torch.testing.assert_close(total, model.predict_raw(X)[:, d],
                                       rtol=1e-6, atol=1e-5)
    for d in range(tm.dim):
        _same_member(resumed.member(1, d), tm.member(1, d))


def test_tree_depth_and_num_outputs(pair):
    X, y, jm, tm, _ = pair
    jt, tt = jm.params["members"], tm.params["members"]
    assert (tt.depth, tt.num_outputs) == (jt.depth, jt.num_outputs) == (3, 1)
    for i, d in ((0, 0), (ROUNDS - 1, tm.dim - 1)):
        jone, tone = jm.member(i, d).params, tm.member(i, d).params
        assert (tone.depth, tone.num_outputs) == (jone.depth, jone.num_outputs) == (3, 1)
    jc = se.DecisionTreeClassifier(max_depth=2).fit(X, y)
    tc = st.decision_tree_classifier_from_arrays(
        jc.get_params(), {f: np.asarray(getattr(jc.params, f)) for f in st.ops.tree.Tree._fields},
        num_features=X.shape[1], num_classes=tm.num_classes, device="cpu",
    )
    assert (tc.params.depth, tc.params.num_outputs) == (jc.params.depth, jc.params.num_outputs)
    assert tc.params.num_outputs == tm.num_classes


def test_regressor_member_equals_the_jax_package():
    """``GBMRegressionModel.member(i)`` (rounds only) stays as it was."""
    X, _ = _data(2)
    y = (X[:, 0] - X[:, 3] + 0.25 * X[:, 1] * X[:, 2]).astype(np.float32)
    jm = se.GBMRegressor(
        num_base_learners=ROUNDS,
        base_learner=se.DecisionTreeRegressor(hist="scatter", max_depth=3, max_bins=16),
    ).fit(X, y)
    arrays = {f: np.asarray(getattr(jm.params["members"], f))
              for f in st.ops.tree.Tree._fields}
    arrays.update(weights=np.asarray(jm.params["weights"]),
                  init=np.asarray(jm.params["init"]["value"]))
    tm = st.gbm_regressor_from_arrays(jm.get_params(), arrays,
                                      num_features=X.shape[1], device="cpu")
    for i in range(ROUNDS):
        np.testing.assert_array_equal(tm.member(i).predict(X).numpy(),
                                      np.asarray(jm.member(i).predict(X)))
    with pytest.raises(TypeError):
        tm.member(0, dim=0)
    assert tm.take(2).num_members == 2
    assert tuple(tm.take(2).params["masks"].shape) == (2, X.shape[1])
