"""PyTorch port parity: pipelines and feature scalers
(``spark_ensemble_tpu_torch/pipeline.py`` vs the JAX package's).

Scaled features within 1e-6 (``torch.std`` and ``jnp.std`` sum in their
own orders); a pipeline's predictions as its final stage's against the
JAX package's (tree stages on the scatter tier with dyadic weights, so no
split ties: probabilities within 1e-5; an MLP stage within 1e-5).  A
tuned pipeline's log-losses within rtol 1e-4, as in
``test_torch_tuning.py``.
"""

import jax
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st


def _data(seed=21, n=400, d=6, k=3):
    rng = np.random.RandomState(seed)
    Z = rng.randn(n, d).astype(np.float32)
    X = (Z * np.array([1.0, 10.0, 0.1, 1.0, 3.0, 100.0][:d])
         + np.array([0.0, 5.0, -1.0, 0.0, 2.0, 50.0][:d])).astype(np.float32)
    X[:, 3] = 2.0  # a constant column
    y = np.argmax(Z @ rng.randn(k, d).astype(np.float32).T
                  + 0.5 * rng.randn(n, k), axis=1).astype(np.float32)
    w = (rng.randint(1, 64, n) / 16.0).astype(np.float32)
    return X, y, w


@pytest.mark.parametrize("scaler,kw", [
    ("StandardScaler", {}), ("StandardScaler", dict(with_mean=False)),
    ("StandardScaler", dict(with_std=False)), ("MinMaxScaler", {}),
    ("MinMaxScaler", dict(feature_min=-1.0, feature_max=2.0)),
])
def test_scalers_match(scaler, kw):
    X, _, _ = _data()
    jm = getattr(se, scaler)(**kw).fit(X)
    tm = getattr(st, scaler)(**kw).fit(X, device="cpu")
    want = np.asarray(jm.transform(X))
    np.testing.assert_allclose(tm.transform(X).numpy(), want, atol=1e-6 * max(1.0, np.abs(want).max()),
                               rtol=1e-6)
    with pytest.raises(TypeError):
        tm.predict(X)
    keys = ("mean", "scale") if scaler == "StandardScaler" else ("lo", "range")
    convert = {"StandardScaler": st.standard_scaler_from_arrays,
               "MinMaxScaler": st.min_max_scaler_from_arrays}[scaler]
    conv = convert(jm.get_params(), {k: np.asarray(jm.params[k]) for k in keys},
                   num_features=6, device="cpu")
    np.testing.assert_array_equal(conv.transform(X).numpy(), want)


@pytest.mark.parametrize("final", ["gbm", "mlp"])
def test_pipeline_predictions_match(final):
    X, y, w = _data()

    def pipe(pkg, **fit):
        if final == "gbm":
            stages = [pkg.StandardScaler(), pkg.GBMClassifier(
                num_base_learners=2, learning_rate=0.3, updates="newton",
                base_learner=pkg.DecisionTreeRegressor(max_depth=3, hist="scatter"))]
        else:
            stages = [pkg.MinMaxScaler(), pkg.MLPClassifier(hidden_layer_sizes=(8,),
                                                            max_iter=20)]
        return pkg.Pipeline(stages=stages).fit(X, y, sample_weight=w, **fit)

    jm, tm = pipe(se), pipe(st, device="cpu")
    assert tm.num_classes == jm.num_classes == 3
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), atol=1e-5)
    np.testing.assert_allclose(tm.transform(X).numpy(), np.asarray(jm.transform(X)),
                               atol=1e-5)
    assert torch.equal(tm.predict(X), torch.argmax(tm.predict_raw(X), dim=-1).float())


def test_fitted_stages_pass_through_and_pipelines_convert():
    X, y, w = _data(n=200)
    scaler = st.StandardScaler().fit(X, device="cpu")
    model = st.Pipeline(stages=[scaler, st.LogisticRegression()]).fit(
        X, y, sample_weight=w, device="cpu")
    assert model.stage_models[0] is scaler
    direct = st.LogisticRegression().fit(scaler.transform(X), y, sample_weight=w,
                                         device="cpu")
    np.testing.assert_array_equal(model.predict_proba(X).numpy(),
                                  direct.predict_proba(scaler.transform(X)).numpy())
    with pytest.raises(TypeError, match="stage"):
        st.Pipeline(stages=[object()]).fit(X, y, device="cpu")
    jm = se.Pipeline(stages=[se.StandardScaler(), se.LinearRegression()]).fit(X, X[:, 0])
    js, jl = jm.stage_models
    stages = [
        st.standard_scaler_from_arrays(js.get_params(), jax.tree_util.tree_map(
            np.asarray, js.params), num_features=6, device="cpu"),
        st.linear_regression_from_arrays(jl.get_params(), jax.tree_util.tree_map(
            np.asarray, jl.params), num_features=6, device="cpu"),
    ]
    tm = st.pipeline_from_models(jm.get_params(), stages, num_features=6, device="cpu")
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-5 * np.abs(X[:, 0]).max())


def test_tuned_pipeline_matches():
    """A TrainValidationSplit over ``Pipeline([StandardScaler(),
    GBMClassifier])``: the tuner keys the class count off the pipeline's
    classifier stage, as the JAX package does."""
    X, y, w = _data(n=300)

    def tvs(pkg, **fit):
        pipe = pkg.Pipeline(stages=[pkg.StandardScaler(), pkg.GBMClassifier(
            num_base_learners=2,
            base_learner=pkg.DecisionTreeRegressor(max_depth=2, hist="scatter"))])
        grid = [{"stages": [pkg.StandardScaler(), pkg.GBMClassifier(
                    num_base_learners=2, learning_rate=lr,
                    base_learner=pkg.DecisionTreeRegressor(max_depth=2, hist="scatter"))]}
                for lr in (0.1, 0.5)]
        return pkg.TrainValidationSplit(
            estimator=pipe, estimator_param_maps=grid,
            evaluator=pkg.MulticlassClassificationEvaluator(metric="logLoss"), seed=1,
        ).fit(X, y, sample_weight=w, **fit)

    jm, tm = tvs(se), tvs(st, device="cpu")
    assert tm.best_index == jm.best_index
    np.testing.assert_allclose(tm.validation_metrics, jm.validation_metrics, rtol=1e-4)
    assert isinstance(tm.best_model, st.PipelineModel)
