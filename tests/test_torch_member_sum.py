"""Boosting's and Bagging's sums over their members do not depend on how
many rows share a call: every member sum runs through the fixed pairwise
tree of ``ops/collective.pairwise_sum`` (SAMME's weighted votes, SAMME.R's
decisions, Drucker's weighted mean and its median's running sum, the
Bagging regressor's mean, soft and hard votes).  A row predicted alone
equals row 0 of a 4096-row batch bit for bit (the card's check is in
``chip_smoke.py``), and the predictions stay allclose to the JAX
package's, on JAX-fitted models carried across by ``convert.py`` (the
bars of ``tests/test_torch_boosting.py`` and ``test_torch_bagging.py``)."""

import numpy as np
import pytest

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st


def _data(n=512, d=6, k=4, seed=40):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y_cls = np.argmax(X @ rng.randn(d, k).astype(np.float32)
                      + 0.5 * rng.randn(n, k), axis=1).astype(np.float32)
    y_reg = (X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y_cls, y_reg


def _queries(n=4096, d=6):
    return np.random.RandomState(41).randn(n, d).astype(np.float32)


def _tree_arrays(members):
    return {f: np.asarray(getattr(members, f)) for f in st.ops.tree.Tree._fields}


def _carried(kind, **kw):
    X, y_cls, y_reg = _data()
    tree = {"cls": "DecisionTreeClassifier", "reg": "DecisionTreeRegressor"}
    if kind.startswith("boosting"):
        is_cls = kind == "boosting_cls"
        jm = (se.BoostingClassifier if is_cls else se.BoostingRegressor)(
            base_learner=getattr(se, tree["cls" if is_cls else "reg"])(max_depth=3),
            num_base_learners=8, **kw,
        ).fit(X, y_cls if is_cls else y_reg)
        arrays = dict(_tree_arrays(jm.params["members"]),
                      weights=np.asarray(jm.params["weights"]))
        if is_cls:
            return jm, st.boosting_classifier_from_arrays(
                jm.get_params(), arrays, num_features=6, num_classes=jm.num_classes,
                device="cpu")
        return jm, st.boosting_regressor_from_arrays(jm.get_params(), arrays,
                                                     num_features=6, device="cpu")
    is_cls = kind == "bagging_cls"
    jm = (se.BaggingClassifier if is_cls else se.BaggingRegressor)(
        base_learner=getattr(se, tree["cls" if is_cls else "reg"])(max_depth=3),
        num_base_learners=7, subspace_ratio=0.8, **kw,
    ).fit(X, y_cls if is_cls else y_reg)
    arrays = dict(_tree_arrays(jm.params["members"]), masks=np.asarray(jm.params["masks"]))
    if is_cls:
        return jm, st.bagging_classifier_from_arrays(
            jm.get_params(), arrays, num_features=6, num_classes=jm.num_classes,
            device="cpu")
    return jm, st.bagging_regressor_from_arrays(jm.get_params(), arrays,
                                                num_features=6, device="cpu")


CASES = {
    # name: (kind, estimator kwargs, method, tolerance against the JAX package)
    "samme": ("boosting_cls", dict(algorithm="discrete"), "predict_proba", 1e-5),
    "samme_r": ("boosting_cls", dict(algorithm="real"), "predict_proba", 1e-5),
    "drucker_median": ("boosting_reg", dict(voting_strategy="median"), "predict", 0.0),
    "drucker_mean": ("boosting_reg", dict(voting_strategy="mean"), "predict", 1e-6),
    "bagging_soft": ("bagging_cls", dict(voting_strategy="soft"), "predict_proba", 1e-6),
    "bagging_hard": ("bagging_cls", dict(voting_strategy="hard"), "predict_proba", 0.0),
    "bagging_reg": ("bagging_reg", dict(), "predict", 1e-6),
}


@pytest.fixture(scope="module")
def carried():
    return {name: _carried(kind, **kw) for name, (kind, kw, _, _) in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_row_equals_row_zero_of_a_batch(carried, name):
    _, tm = carried[name]
    method = CASES[name][2]
    Xq = _queries()
    batch = getattr(tm, method)(Xq)
    for i in (0, 1, 4095):
        one = getattr(tm, method)(Xq[i:i + 1])
        assert np.array_equal(one.numpy()[0], batch.numpy()[i]), i


@pytest.mark.parametrize("name", sorted(CASES))
def test_predictions_stay_allclose_to_the_jax_package(carried, name):
    jm, tm = carried[name]
    method, tol = CASES[name][2], CASES[name][3]
    Xq = _queries()
    got, want = getattr(tm, method)(Xq).numpy(), np.asarray(getattr(jm, method)(Xq))
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
