"""Persistence of the PyTorch port (``utils/persist.py``), case for case
with tests/test_persist.py where the case exists in the port, plus the
cross-package contract: a directory saved by the JAX package's ``save``
loads in the port, and one saved by the port loads in the JAX package.

Tolerances: a port round trip is exact (the arrays come back as written).
Across packages the loaded model holds the very arrays the other package
wrote, so splits, thresholds and masks are equal and every row takes the
same route; predictions are held within 1e-5 (probabilities) or 1e-5 of
the label scale (regression), which covers the f32 sums each package
takes in its own order.
"""

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.utils import persist as jpersist
from spark_ensemble_tpu_torch.utils import persist as tpersist


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(600, 8).astype(np.float32)
    yr = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(600)).astype(np.float32)
    ym = np.digitize(X[:, 0] + X[:, 1], [-1, 0, 1]).astype(np.float32)
    return X, yr, ym


def _tree(pkg, cls="DecisionTreeRegressor", **kw):
    return getattr(pkg, cls)(max_depth=3, max_bins=16, **kw)


MODEL_BUILDERS = [
    ("dtr", lambda X, yr, ym: st.DecisionTreeRegressor(max_depth=3).fit(X, yr, device="cpu")),
    ("dtc", lambda X, yr, ym: st.DecisionTreeClassifier(max_depth=3).fit(X, ym, device="cpu")),
    ("linreg", lambda X, yr, ym: st.LinearRegression().fit(X, yr, device="cpu")),
    ("logreg", lambda X, yr, ym: st.LogisticRegression(max_iter=30).fit(X, ym, device="cpu")),
    ("gnb", lambda X, yr, ym: st.GaussianNaiveBayes().fit(X, ym, device="cpu")),
    ("dummy_r", lambda X, yr, ym: st.DummyRegressor(strategy="median").fit(X, yr, device="cpu")),
    ("dummy_c", lambda X, yr, ym: st.DummyClassifier().fit(X, ym, device="cpu")),
    ("bag_r", lambda X, yr, ym: st.BaggingRegressor(
        num_base_learners=3, base_learner=_tree(st)).fit(X, yr, device="cpu")),
    ("bag_c", lambda X, yr, ym: st.BaggingClassifier(
        num_base_learners=3, base_learner=_tree(st, "DecisionTreeClassifier")
    ).fit(X, ym, device="cpu")),
    ("boost_r", lambda X, yr, ym: st.BoostingRegressor(
        num_base_learners=3, base_learner=_tree(st)).fit(X, yr, device="cpu")),
    ("boost_c", lambda X, yr, ym: st.BoostingClassifier(
        num_base_learners=3, base_learner=_tree(st, "DecisionTreeClassifier")
    ).fit(X, ym, device="cpu")),
    ("gbm_r", lambda X, yr, ym: st.GBMRegressor(
        num_base_learners=3, base_learner=_tree(st)).fit(X, yr, device="cpu")),
    ("gbm_c", lambda X, yr, ym: st.GBMClassifier(
        num_base_learners=3, base_learner=_tree(st)).fit(X, ym, device="cpu")),
    ("stack_r", lambda X, yr, ym: st.StackingRegressor(
        base_learners=[_tree(st), st.LinearRegression()],
        stacker=st.LinearRegression(),
    ).fit(X, yr, device="cpu")),
    ("stack_c", lambda X, yr, ym: st.StackingClassifier(
        base_learners=[_tree(st, "DecisionTreeClassifier"), st.GaussianNaiveBayes()],
        stacker=st.LogisticRegression(max_iter=30), stack_method="proba",
    ).fit(X, ym, device="cpu")),
]


@pytest.mark.parametrize("name,builder", MODEL_BUILDERS, ids=[n for n, _ in MODEL_BUILDERS])
def test_save_load_identical_predictions(tmp_path, data, name, builder):
    """A port round trip is exact: predictions and probabilities equal."""
    X, yr, ym = data
    model = builder(X, yr, ym)
    path = str(tmp_path / name)
    model.save(path)
    loaded = st.load(path, device="cpu")
    assert torch.equal(model.predict(X[:100]), loaded.predict(X[:100]))
    if hasattr(model, "predict_proba"):
        assert torch.equal(model.predict_proba(X[:50]), loaded.predict_proba(X[:50]))


def test_loaded_model_params_match(tmp_path, data):
    X, yr, _ = data
    gbm = st.GBMRegressor(num_base_learners=2, learning_rate=0.7, loss="huber",
                          base_learner=_tree(st)).fit(X, yr, device="cpu")
    gbm.save(str(tmp_path / "g"))
    loaded = st.load(str(tmp_path / "g"), device="cpu")
    assert loaded.learning_rate == 0.7
    assert loaded.loss == "huber"
    assert loaded.num_members == gbm.num_members
    assert loaded.device == torch.device("cpu")


def test_estimator_save_load(tmp_path):
    est = st.BaggingRegressor(
        num_base_learners=7,
        base_learner=st.DecisionTreeRegressor(max_depth=3, max_bins=16),
    )
    est_path = str(tmp_path / "est")
    st.save(est, est_path)
    loaded = st.load(est_path, device="cpu")
    assert loaded.num_base_learners == 7
    assert loaded.base_learner.max_depth == 3
    assert loaded.base_learner.max_bins == 16


def test_load_runs_on_the_card_unless_asked(tmp_path, data, monkeypatch):
    """``load`` defaults to ``device="cuda"`` like every entry point, and
    raises without a card instead of falling back to the CPU."""
    X, yr, _ = data
    st.LinearRegression().fit(X, yr, device="cpu").save(str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.load(str(tmp_path / "m"))


def test_tree_persist_defaults_backfill_split_gain():
    """A save made before ``split_gain`` existed loads with zero gains."""
    arrays = {"p.split_feature": np.zeros(3, np.int32),
              "p.split_bin": np.zeros(3, np.int32),
              "p.split_threshold": np.full(3, np.inf, np.float32),
              "p.leaf_value": np.zeros((4, 1), np.float32)}
    spec = {"__namedtuple__": "Tree", "fields": {
        k.split(".")[1]: {"__array__": k} for k in arrays}}
    tree = tpersist._decode(spec, arrays, tpersist._class_registry())
    assert torch.equal(tree.split_gain, torch.zeros(3))


# ---------------------------------------------------------------------------
# across packages: each family saved by one package, loaded by the other
# ---------------------------------------------------------------------------


def _families(pkg):
    """The cross-package families, each as ``(estimator, label kind)``."""
    cls = _tree(pkg, "DecisionTreeClassifier")
    return {
        "gbm_r": (pkg.GBMRegressor(num_base_learners=3, base_learner=_tree(pkg)), "r"),
        "gbm_c": (pkg.GBMClassifier(num_base_learners=3, base_learner=_tree(pkg)), "m"),
        "bag_c": (pkg.BaggingClassifier(num_base_learners=3, base_learner=cls), "m"),
        "boost_c": (pkg.BoostingClassifier(num_base_learners=3, base_learner=cls), "m"),
        "stack_c": (pkg.StackingClassifier(
            base_learners=[_tree(pkg, "DecisionTreeClassifier"), pkg.GaussianNaiveBayes()],
            stacker=pkg.GaussianNaiveBayes(), stack_method="proba"), "m"),
        "pipeline": (pkg.Pipeline(stages=[
            pkg.StandardScaler(),
            pkg.GBMRegressor(num_base_learners=2, base_learner=_tree(pkg))]), "r"),
        "cv": (pkg.CrossValidator(
            estimator=pkg.LinearRegression(), evaluator=pkg.RegressionEvaluator(),
            estimator_param_maps=[{"reg_param": 0.0}, {"reg_param": 0.5}],
            num_folds=2), "r"),
    }


def _outputs(model, X):
    """The model's probabilities (classifiers) or predictions, as numpy."""
    out = model.predict_proba(X) if hasattr(model, "predict_proba") and (
        getattr(model, "num_classes", None)) else model.predict(X)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _splits(model):
    """Every tree's split tables of a model (nested models included), as
    numpy arrays in a fixed order."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in ("split_feature", "split_bin", "split_threshold"):
                out.append(np.asarray(getattr(node, f)))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    for m in [model, getattr(model, "best_model", None),
              getattr(model, "stack_model", None),
              *getattr(model, "base_models", []), *getattr(model, "stage_models", [])]:
        if m is not None:
            walk(m.params)
    return out


@pytest.mark.parametrize("family", sorted(_families(st)))
def test_jax_save_loads_in_the_port(tmp_path, data, family):
    """A directory written by the JAX package's ``save`` loads in the port:
    the same split tables, and outputs within 1e-5 (of the label scale
    for regressors)."""
    X, yr, ym = data
    est, kind = _families(se)[family]
    y = yr if kind == "r" else ym
    jm = est.fit(X, y)
    path = str(tmp_path / family)
    jpersist.save(jm, path)
    tm = st.load(path, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    for a, b in zip(_splits(jm), _splits(tm), strict=True):
        np.testing.assert_array_equal(a, b)
    scale = np.abs(yr).max() if kind == "r" else 1.0
    np.testing.assert_allclose(_outputs(tm, X), _outputs(jm, X), atol=1e-5 * scale)
    _assert_same_tuning_record(jm, tm)


@pytest.mark.parametrize("family", sorted(_families(st)))
def test_port_save_loads_in_the_jax_package(tmp_path, data, family):
    """A directory written by the port's ``save`` loads in the JAX package
    with the same split tables and outputs within 1e-5; the port writes
    no key the JAX package's format lacks."""
    X, yr, ym = data
    est, kind = _families(st)[family]
    y = yr if kind == "r" else ym
    tm = est.fit(X, y, device="cpu")
    path = str(tmp_path / family)
    st.save(tm, path)
    jm = jpersist.load(path)
    assert type(jm).__name__ == type(tm).__name__
    for a, b in zip(_splits(tm), _splits(jm), strict=True):
        np.testing.assert_array_equal(a, b)
    scale = np.abs(yr).max() if kind == "r" else 1.0
    np.testing.assert_allclose(_outputs(jm, X), _outputs(tm, X), atol=1e-5 * scale)
    _assert_same_tuning_record(tm, jm)
    # and the JAX package writes the same directory back, key for key
    again = str(tmp_path / (family + "_again"))
    jpersist.save(jm, again)
    assert set(_tree_files(path)) == set(_tree_files(again))


def _assert_same_tuning_record(saved, loaded):
    """A tuner's record travels as written: metrics and the best index."""
    for attr in ("avg_metrics", "fold_metrics", "best_index", "num_members"):
        if hasattr(saved, attr):
            assert getattr(loaded, attr) == getattr(saved, attr), attr


def _tree_files(root):
    import os

    return [os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs]


def test_gbm_classifier_from_both_roads_agrees(tmp_path, data):
    """``convert.py`` and ``load`` carry the same fitted JAX model into the
    same port model: equal probabilities, since both hold its very
    arrays."""
    X, _, y = data
    jm = _families(se)["gbm_c"][0].fit(X, y)
    jpersist.save(jm, str(tmp_path / "g"))
    loaded = st.load(str(tmp_path / "g"), device="cpu")
    trees = jm.params["members"]
    arrays = {f: np.asarray(getattr(trees, f)) for f in trees._fields}
    arrays.update(weights=np.asarray(jm.params["weights"]),
                  init_raw=np.asarray(jm.params["init_raw"]))
    converted = st.gbm_classifier_from_arrays(
        jm.get_params(), arrays, num_features=8, num_classes=4, device="cpu")
    assert torch.equal(loaded.predict_proba(X), converted.predict_proba(X))
