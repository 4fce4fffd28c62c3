"""PyTorch port parity: model selection (``spark_ensemble_tpu_torch/
tuning.py`` and ``utils/random.py::permutation`` vs the JAX package's).

- ``permutation`` and the fold masks are array-equal to
  ``jax.random.permutation`` and ``tuning._kfold_indices``, at 1 shuffle
  round (n = 10, 1000) and 2 (n = 3000).
- CrossValidator and TrainValidationSplit pick the same ``best_index``,
  with ``avg_metrics`` / ``validation_metrics`` within rtol 1e-6 (f32
  metrics summed in other orders), and log-losses within rtol 1e-4 (the
  logistic solvers meet at a flat optimum, and the GBM's Newton step sizes
  agree to about 1e-5; 3.9e-5 measured).  Tree fixtures use the scatter tier
  and dyadic sample weights k/16 from a wide range, so no two splits tie.
- ``share_binning`` bins once per learner config and search (the port's
  own count: the JAX package's tests of its count are among the ones that
  fail there).
"""

import json

import jax
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu import tuning as jt
from spark_ensemble_tpu_torch import tuning as tt
from spark_ensemble_tpu_torch.utils.random import PRNGKey, permutation


def _data(n=300, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] + 0.1 * rng.randn(n)).astype(np.float32)
    yc = np.digitize(X[:, 0] + 0.3 * rng.randn(n), [-0.5, 0.6]).astype(np.float32)
    w = (rng.randint(1, 33, n) / 16.0).astype(np.float32)
    return X, y, yc, w


@pytest.mark.parametrize("n", [1, 10, 1000, 3000])
@pytest.mark.parametrize("seed", [0, 7])
def test_permutation_equals_the_reference(n, seed):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    np.testing.assert_array_equal(permutation(PRNGKey(seed), n).numpy(), want)


@pytest.mark.parametrize("n", [10, 1000, 3000])
@pytest.mark.parametrize("num_folds", [2, 3])
def test_fold_masks_equal_the_reference(n, num_folds):
    for want, got in zip(jt._kfold_indices(n, num_folds, 5),
                         tt._kfold_indices(n, num_folds, 5)):
        np.testing.assert_array_equal(got, want)


def _cls_data(seed=21, n=512, d=6, k=4):
    """``test_torch_bagging.py``'s tie-free classification fixture: weights
    k/16 from 1/16 to 63/16, so no two leaf class weights tie."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T
                  + 0.5 * rng.randn(n, k), axis=1).astype(np.float32)
    w = (rng.randint(1, 64, n) / 16.0).astype(np.float32)
    return X, y, w


def _grid(pkg, name, values):
    return pkg.ParamGridBuilder().add_grid(name, values).build()


def test_cv_over_a_gbm_regressor_matches():
    X, y, _, _ = _data()

    def cv(pkg, megabatch, **fit):
        est = pkg.GBMRegressor(num_base_learners=3,
                               base_learner=pkg.DecisionTreeRegressor(max_depth=3))
        return pkg.CrossValidator(
            estimator=est, estimator_param_maps=_grid(pkg, "learning_rate", [0.1, 0.5]),
            evaluator=pkg.RegressionEvaluator(), num_folds=3, seed=0,
            megabatch=megabatch,
        ).fit(X, y, **fit)

    jm = cv(se, "off")
    for megabatch in ("off", "on"):
        tm = cv(st, megabatch, device="cpu")
        assert tm.best_index == jm.best_index
        np.testing.assert_allclose(tm.avg_metrics, jm.avg_metrics, rtol=1e-6)
        np.testing.assert_allclose(tm.fold_metrics, jm.fold_metrics, rtol=1e-6)
    np.testing.assert_array_equal(tm.predict(X).numpy(), tm.best_model.predict(X).numpy())


def test_cv_reference_example_over_bagged_trees_matches():
    """The reference's own usage: a CrossValidator over a BaggingClassifier
    with a grid over ``subspace_ratio`` and a multiclass evaluator."""
    X, yc, w = _cls_data()

    def cv(pkg, **fit):
        est = pkg.BaggingClassifier(
            num_base_learners=4,
            base_learner=pkg.DecisionTreeClassifier(max_depth=3, hist="scatter"))
        return pkg.CrossValidator(
            estimator=est, estimator_param_maps=_grid(pkg, "subspace_ratio", [0.5, 1.0]),
            evaluator=pkg.MulticlassClassificationEvaluator(), num_folds=3, seed=0,
        ).fit(X, yc, sample_weight=w, **fit)

    jm, tm = cv(se), cv(st, device="cpu")
    assert tm.best_index == jm.best_index
    np.testing.assert_allclose(tm.avg_metrics, jm.avg_metrics, rtol=1e-6)


def test_train_validation_split_matches():
    """(A TrainValidationSplit over a GBM classifier, in a pipeline, is in
    ``test_torch_pipeline.py``.)"""
    X, yc, w = _cls_data()

    def tvs(pkg, **fit):
        return pkg.TrainValidationSplit(
            estimator=pkg.LogisticRegression(),
            estimator_param_maps=_grid(pkg, "reg_param", [1e-3, 1.0]),
            evaluator=pkg.MulticlassClassificationEvaluator(metric="logLoss"), seed=3,
        ).fit(X, yc, sample_weight=w, **fit)

    jm, tm = tvs(se), tvs(st, device="cpu")
    assert tm.best_index == jm.best_index
    np.testing.assert_allclose(tm.validation_metrics, jm.validation_metrics, rtol=1e-4)


def test_shared_binning_bins_once_per_config(monkeypatch):
    X, y, _, _ = _data(n=120)
    calls = []
    orig = st.DecisionTreeRegressor.make_fit_ctx

    def counting(self, X, num_classes=None):
        calls.append(self.max_depth)
        return orig(self, X, num_classes)

    monkeypatch.setattr(st.DecisionTreeRegressor, "make_fit_ctx", counting)
    grid = [{"learning_rate": 0.1}, {"learning_rate": 0.3},
            {"base_learner": st.DecisionTreeRegressor(max_depth=2)}]
    scores = {}
    for share in (True, False):
        calls.clear()
        model = st.CrossValidator(
            estimator=st.GBMRegressor(num_base_learners=2), estimator_param_maps=grid,
            evaluator=st.RegressionEvaluator(), num_folds=2, share_binning=share,
            megabatch="off",
        ).fit(X, y, device="cpu")
        scores[share] = (model.avg_metrics, len(calls))
    # one binning per learner config (depth 5 and depth 2) with sharing;
    # one per (map, fold) fit plus the refit without it
    assert scores[True][1] == 2
    assert scores[False][1] == 3 * 2 + 1
    assert scores[True][0] == scores[False][0]


def test_config_keys_and_tuner_params_match_the_reference():
    for make in (lambda p: p.MLPClassifier(hidden_layer_sizes=(8, 4)),
                 lambda p: p.DecisionTreeRegressor(max_depth=3),
                 lambda p: p.GBMClassifier(base_learner=p.DecisionTreeRegressor(max_bins=32))):
        assert make(st).config_key() == make(se).config_key()
    for name in ("CrossValidator", "TrainValidationSplit"):
        jdefs, tdefs = getattr(se, name)._param_defs(), getattr(st, name)._param_defs()
        assert sorted(jdefs) == sorted(tdefs)
        for k, p in jdefs.items():
            assert tdefs[k].default == p.default, k
    assert (st.ParamGridBuilder().add_grid("a", [1, 2]).base_on({"b": 3}).build()
            == se.ParamGridBuilder().add_grid("a", [1, 2]).base_on({"b": 3}).build())


def test_unported_planes_and_missing_cuda_raise(monkeypatch, tmp_path):
    X, y, _, _ = _data(n=60)
    kw = dict(estimator=st.LinearRegression(), evaluator=st.RegressionEvaluator())
    with pytest.raises(NotImplementedError, match="item 18"):
        st.CrossValidator(**kw).fit(X, y, mesh=object(), device="cpu")
    # telemetry_path raised before the port had telemetry; each scored
    # candidate streams a tuning_candidate event now
    path = str(tmp_path / "t.jsonl")
    st.TrainValidationSplit(telemetry_path=path, **kw).fit(X, y, device="cpu")
    with open(path) as f:
        cands = [json.loads(line) for line in f]
    assert [c["event"] for c in cands] == ["tuning_candidate"]
    assert cands[0]["tuner"] == "TrainValidationSplit" and not cands[0]["megabatch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.CrossValidator(**kw).fit(X, y)
