"""PyTorch port parity: Bagging, Boosting, GBM and Stacking over the
non-tree learners (linear, naive Bayes, the MLP, Dummy), and feature
metadata.

Each ensemble is fitted by both packages on the same seeded data, with
the JAX package's keys (Bagging's ``fold_in(root, i)`` per member,
Boosting's per round, GBM's round bag key shared by a classifier's class
dims), so the draws and the MLPs' initial weights are equal.  Tolerances:
regression predictions within 1e-5 of the label scale; class
probabilities within 1e-4, and 2e-4 for members that are
LogisticRegressions (their solvers meet at the optimum, not iterate by
iterate; measured 6.7e-5).  The gaps measured on these fixtures were
1e-8..5e-6.
"""

import json

import jax
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st


def _data(n=400, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * np.array([1.0, 10.0, 0.1, 1.0, 3.0, 1.0][:d])).astype(np.float32)
    y_cls = np.digitize(X[:, 0] + 0.3 * rng.randn(n), [-0.5, 0.6]).astype(np.float32)
    y_reg = (3.0 * X[:, 0] + 0.05 * X[:, 1] ** 2 + rng.randn(n)).astype(np.float32)
    return X, y_cls, y_reg


def _mlp(pkg, cls):
    return getattr(pkg, cls)(max_iter=20, hidden_layer_sizes=(8,))


_BASES = {
    "linear": lambda pkg: pkg.LinearRegression(),
    "logistic": lambda pkg: pkg.LogisticRegression(reg_param=1e-2),
    "nb": lambda pkg: pkg.GaussianNaiveBayes(),
    "mlp_reg": lambda pkg: _mlp(pkg, "MLPRegressor"),
    "mlp_cls": lambda pkg: _mlp(pkg, "MLPClassifier"),
    "dummy_reg": lambda pkg: pkg.DummyRegressor(),
    "dummy_cls": lambda pkg: pkg.DummyClassifier(),
}

_BAG = dict(num_base_learners=3, subsample_ratio=0.8, subspace_ratio=0.7)
_CASES = [
    ("BaggingRegressor", _BAG, "linear"),
    ("BaggingRegressor", _BAG, "mlp_reg"),
    ("BaggingRegressor", _BAG, "dummy_reg"),
    ("BaggingClassifier", dict(_BAG, voting_strategy="soft"), "logistic"),
    ("BaggingClassifier", dict(_BAG, voting_strategy="soft"), "nb"),
    ("BaggingClassifier", dict(_BAG, voting_strategy="soft"), "mlp_cls"),
    ("BaggingClassifier", dict(_BAG, voting_strategy="soft"), "dummy_cls"),
    ("BoostingClassifier", dict(num_base_learners=3), "nb"),
    ("BoostingClassifier", dict(num_base_learners=3, algorithm="real"), "nb"),
    ("BoostingClassifier", dict(num_base_learners=3), "mlp_cls"),
    ("BoostingRegressor", dict(num_base_learners=3), "linear"),
    ("BoostingRegressor", dict(num_base_learners=3), "mlp_reg"),
    ("GBMRegressor", dict(num_base_learners=3, learning_rate=0.5), "linear"),
    ("GBMRegressor", dict(num_base_learners=3, learning_rate=0.5), "mlp_reg"),
    ("GBMRegressor", dict(num_base_learners=3, learning_rate=0.5, loss="huber"), "dummy_reg"),
    ("GBMClassifier", dict(num_base_learners=3, learning_rate=0.5), "linear"),
    ("GBMClassifier", dict(num_base_learners=3, learning_rate=0.5, subsample_ratio=0.8),
     "mlp_reg"),
]


@pytest.mark.parametrize("family,kw,base", _CASES,
                         ids=[f"{f}-{b}-{i}" for i, (f, _, b) in enumerate(_CASES)])
def test_ensemble_over_non_tree_members_matches(family, kw, base):
    X, y_cls, y_reg = _data()
    classify = "Classifier" in family
    y = y_cls if classify else y_reg
    jm = getattr(se, family)(base_learner=_BASES[base](se), **kw).fit(X, y)
    tm = getattr(st, family)(base_learner=_BASES[base](st), **kw).fit(X, y, device="cpu")
    assert tm.num_members == jm.num_members if hasattr(jm, "num_members") else True
    if classify:
        atol = 2e-4 if base == "logistic" else 1e-4
        np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                                   np.asarray(jm.predict_proba(X)), atol=atol)
    else:
        np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                                   atol=1e-5 * np.abs(y).max())


def test_stacking_with_an_mlp_member_matches():
    """``docs/stacking.md``'s stack (a tree, AdaBoost, an MLP and a
    logistic regression under a logistic stacker, raw meta-features), at
    a small size, on the scatter tier."""
    X, y, _ = _data(n=512)

    def stack(pkg, **fit):
        return pkg.StackingClassifier(
            base_learners=[
                pkg.DecisionTreeClassifier(max_depth=3, hist="scatter"),
                pkg.BoostingClassifier(
                    num_base_learners=2,
                    base_learner=pkg.DecisionTreeClassifier(max_depth=2, hist="scatter")),
                pkg.MLPClassifier(hidden_layer_sizes=(8,), max_iter=20),
                pkg.LogisticRegression(reg_param=1e-2),
            ],
            stacker=pkg.LogisticRegression(reg_param=1e-2),
            stack_method="raw",
        ).fit(X, y, **fit)

    jm, tm = stack(se), stack(st, device="cpu")
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=2e-4)


def test_feature_metadata_and_member_feature_names_equal():
    X, _, y = _data(n=200)
    names = [f"col{i}" for i in range(6)]
    kw = dict(num_base_learners=4, subspace_ratio=0.5, feature_names=names)
    jm = se.BaggingRegressor(base_learner=se.LinearRegression(), **kw).fit(X, y)
    tm = st.BaggingRegressor(base_learner=st.LinearRegression(), **kw).fit(
        X, y, device="cpu")
    assert tm.feature_metadata == st.FeatureMetadata(names)
    assert tm.feature_metadata.names == jm.feature_metadata.names
    for i in range(4):
        assert tm.member_feature_names(i) == jm.member_feature_names(i)
    gk = dict(num_base_learners=3, subspace_ratio=0.5)
    jg = se.GBMRegressor(**gk).fit(X, y)
    tg = st.GBMRegressor(base_learner=st.DecisionTreeRegressor(hist="scatter"), **gk).fit(
        X, y, device="cpu")
    assert tg.feature_metadata.names == [f"f{i}" for i in range(6)]
    for i in range(3):
        assert tg.member_feature_names(i) == jg.member_feature_names(i)
    # the port's own copy of the metadata record
    meta = st.FeatureMetadata.resolve(None, 3)
    assert meta.names == ["f0", "f1", "f2"] and len(meta) == 3
    assert meta.select(np.array([2, 0])).names == ["f2", "f0"]
    with pytest.raises(ValueError):
        st.FeatureMetadata.resolve(["a"], 2)
    with pytest.raises(AttributeError):
        st.LinearRegression().fit(X, y, device="cpu").member_feature_names(0)


def test_converted_ensembles_over_non_tree_members_predict_as_the_reference():
    X, y_cls, y_reg = _data(n=200)
    jb = se.BaggingClassifier(base_learner=_mlp(se, "MLPClassifier"), **_BAG).fit(X, y_cls)
    arrays = {"members": jax.tree_util.tree_map(np.asarray, jb.params["members"]),
              "masks": np.asarray(jb.params["masks"])}
    tb = st.bagging_classifier_from_arrays(jb.get_params(), arrays, num_features=6,
                                           num_classes=3, device="cpu")
    np.testing.assert_allclose(tb.predict_proba(X).numpy(),
                               np.asarray(jb.predict_proba(X)), atol=1e-6)
    jg = se.GBMRegressor(base_learner=se.LinearRegression(), num_base_learners=2).fit(X, y_reg)
    arrays = {"members": jax.tree_util.tree_map(np.asarray, jg.params["members"]),
              "weights": np.asarray(jg.params["weights"]),
              "init": np.asarray(jg.params["init"]["value"])}
    tg = st.gbm_regressor_from_arrays(jg.get_params(), arrays, num_features=6,
                                      device="cpu")
    np.testing.assert_allclose(tg.predict(X).numpy(), np.asarray(jg.predict(X)),
                               atol=1e-5 * np.abs(y_reg).max())
    jo = se.BoostingRegressor(base_learner=se.LinearRegression(), num_base_learners=2).fit(
        X, y_reg)
    arrays = {"members": jax.tree_util.tree_map(np.asarray, jo.params["members"]),
              "weights": np.asarray(jo.params["weights"])}
    to = st.boosting_regressor_from_arrays(jo.get_params(), arrays, num_features=6,
                                           device="cpu")
    np.testing.assert_allclose(to.predict(X).numpy(), np.asarray(jo.predict(X)),
                               atol=1e-5 * np.abs(y_reg).max())


def test_member_slices_and_unported_planes(tmp_path):
    """``member(i)`` of an ensemble over MLPs is that member's model; the
    planes this port has not reached still raise."""
    X, y, _ = _data(n=120)
    model = st.BaggingClassifier(base_learner=_mlp(st, "MLPClassifier"),
                                 num_base_learners=2).fit(X, y, device="cpu")
    m1 = model.member(1)
    assert isinstance(m1, st.MLPClassificationModel)
    probas = model._base().predict_proba_many_fn(model.params["members"],
                                                 torch.as_tensor(X))
    np.testing.assert_array_equal(m1.predict_proba(X).numpy(), probas[1].numpy())
    # save raised before persistence was ported; it round-trips now
    path = str(tmp_path / "model")
    model.save(path)
    np.testing.assert_array_equal(
        st.load(path, device="cpu").predict_proba(X).numpy(),
        model.predict_proba(X).numpy())
    # a mesh fits now; a device= that disagrees with its device raises
    cpu_mesh = type("CpuMesh", (), {"device": torch.device("cpu")})()
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        st.BaggingClassifier(base_learner=st.GaussianNaiveBayes()).fit(
            X, y, mesh=cpu_mesh, device="cuda")
    # telemetry raised before the port had it; the fit streams now
    path = str(tmp_path / "t.jsonl")
    gbm = st.GBMClassifier(base_learner=st.LinearRegression(), num_base_learners=2,
                           telemetry_path=path).fit(X, y, device="cpu")
    with open(path) as f:
        ends = [json.loads(line) for line in f if '"round_end"' in line]
    assert [e["round"] for e in ends] == list(gbm.fit_history_["round"]) == [0, 1]
