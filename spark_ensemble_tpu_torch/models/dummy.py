"""Dummy baseline learners (PyTorch port of ``models/dummy.py``), used
standalone as baselines and as GBM's init model.

- DummyRegressor: mean | median | quantile(q) | constant(c); median and
  quantile are the exact weighted ones of ``utils/quantile.py``.
- DummyClassifier: uniform | prior | constant(c); raw = log(probability).
"""

from __future__ import annotations

import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    ClassificationModel,
    RegressionModel,
)
from spark_ensemble_tpu_torch.params import Param, gt_eq, in_array, in_range
from spark_ensemble_tpu_torch.utils.quantile import weighted_median, weighted_quantile


class DummyRegressor(BaseLearner):
    strategy = Param(
        "mean", in_array(["mean", "median", "quantile", "constant"]),
        doc="constant prediction rule over the training target",
    )
    quantile = Param(
        0.5, in_range(0.0, 1.0),
        doc="target quantile for strategy='quantile' (exact, weighted)",
    )
    constant = Param(0.0, doc="value for strategy='constant'")
    tol = Param(1e-3, gt_eq(0.0), doc="kept for API parity; quantiles are exact")

    is_classifier = False

    def make_fit_ctx(self, X, num_classes=None):
        return None

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None):
        strategy = self.strategy.lower()
        if strategy == "mean":
            value = torch.sum(w * y) / torch.clamp(torch.sum(w), min=1e-30)
        elif strategy == "median":
            value = weighted_median(y, w)
        elif strategy == "quantile":
            value = weighted_quantile(y, self.quantile, w)
        else:
            value = torch.tensor(float(self.constant), device=y.device)
        return {"value": value.to(torch.float32)}

    def predict_fn(self, params, X):
        return params["value"].expand(X.shape[0])

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return DummyRegressionModel(
            params=params, num_features=num_features, device=device,
            **self.get_params(),
        )


class DummyRegressionModel(RegressionModel, DummyRegressor):
    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))


class DummyClassifier(BaseLearner):
    strategy = Param(
        "prior", in_array(["uniform", "prior", "constant"]),
        doc="'prior' predicts the modal class with class-frequency "
        "probabilities; 'uniform' ignores the training distribution",
    )
    constant = Param(0.0, doc="class label for strategy='constant'")

    is_classifier = True

    def make_fit_ctx(self, X, num_classes=None):
        return {"num_classes": num_classes}

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None):
        k = ctx["num_classes"]
        strategy = self.strategy.lower()
        if strategy == "uniform":
            proba = torch.full((k,), 1.0 / k, dtype=torch.float32, device=y.device)
        elif strategy == "prior":
            onehot = torch.nn.functional.one_hot(y.to(torch.int64), k).to(torch.float32)
            counts = torch.sum(w[:, None] * onehot, dim=0)
            proba = counts / torch.clamp(torch.sum(counts), min=1e-30)
        else:
            proba = torch.nn.functional.one_hot(
                torch.tensor(int(self.constant), device=y.device), k
            ).to(torch.float32)
        # reference: rawPrediction = log(probability)
        raw = torch.log(torch.clamp(proba, min=1e-30))
        return {"proba": proba, "raw": raw}

    def predict_proba_fn(self, params, X):
        return params["proba"].expand(X.shape[0], -1)

    def predict_raw_fn(self, params, X):
        return params["raw"].expand(X.shape[0], -1)

    def predict_fn(self, params, X):
        return torch.argmax(self.predict_proba_fn(params, X), dim=-1).to(torch.float32)

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return DummyClassificationModel(
            params=params, num_features=num_features,
            num_classes=num_classes or 2, device=device, **self.get_params(),
        )


class DummyClassificationModel(ClassificationModel, DummyClassifier):
    def predict_proba(self, X):
        return self.predict_proba_fn(self.params, self._input(X))

    def predict_raw(self, X):
        return self.predict_raw_fn(self.params, self._input(X))
