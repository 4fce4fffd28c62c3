"""Pipelines and feature transformers (PyTorch port of ``pipeline.py``).

The reference's estimators extend Spark ``Predictor`` so that they compose
with ``Pipeline`` stages and feature transformers.  Here a ``Pipeline``
fits its stages left to right on the device: transformer estimators
(``StandardScaler``, ``MinMaxScaler``) fit to models whose ``transform`` is
a few elementwise ops, and each stage's output feeds the next; the last
stage is usually a predictor.
"""

from __future__ import annotations

from typing import Any, List

import torch

from spark_ensemble_tpu_torch.models.base import (
    Estimator,
    Model,
    as_f32,
    not_supported,
    resolve_device,
)
from spark_ensemble_tpu_torch.params import Param, Params


class Transformer(Params):
    """A stateless or fitted feature transform ``X -> X'``."""

    def transform(self, X) -> torch.Tensor:
        raise NotImplementedError


class StandardScaler(Estimator):
    """Column standardization (Spark ``ml.feature.StandardScaler``): the
    population mean and standard deviation of the training columns."""

    with_mean = Param(True, doc="center features at the training mean")
    with_std = Param(True, doc="scale features to unit training variance")

    def fit(self, X, y=None, sample_weight=None,
            device="cuda") -> "StandardScalerModel":
        dev = resolve_device(device)
        X = as_f32(X, dev)
        mean = torch.mean(X, dim=0)
        std = torch.std(X, dim=0, correction=0)
        return StandardScalerModel(
            params={"mean": mean, "scale": torch.clamp(std, min=1e-12)},
            num_features=X.shape[1], device=dev, **self.get_params(),
        )


class StandardScalerModel(Model, StandardScaler):
    def transform(self, X):
        X = self._input(X)
        if self.with_mean:
            X = X - self.params["mean"]
        if self.with_std:
            X = X / self.params["scale"]
        return X

    def predict(self, X):  # transformers are not predictors
        raise TypeError("StandardScalerModel is a transformer; use transform()")


class MinMaxScaler(Estimator):
    """Rescale columns to [min, max] (Spark ``ml.feature.MinMaxScaler``)."""

    feature_min = Param(0.0, doc="lower bound of the scaled range")
    feature_max = Param(1.0, doc="upper bound of the scaled range")

    def fit(self, X, y=None, sample_weight=None,
            device="cuda") -> "MinMaxScalerModel":
        dev = resolve_device(device)
        X = as_f32(X, dev)
        lo = torch.amin(X, dim=0)
        hi = torch.amax(X, dim=0)
        return MinMaxScalerModel(
            params={"lo": lo, "range": hi - lo},
            num_features=X.shape[1], device=dev, **self.get_params(),
        )


class MinMaxScalerModel(Model, MinMaxScaler):
    def transform(self, X):
        X = self._input(X)
        rng = self.params["range"]
        # constant columns rescale to the midpoint, Spark's E_max == E_min
        # rule
        unit = torch.where(
            rng > 0, (X - self.params["lo"]) / torch.clamp(rng, min=1e-30), 0.5
        )
        return unit * (self.feature_max - self.feature_min) + self.feature_min

    def predict(self, X):
        raise TypeError("MinMaxScalerModel is a transformer; use transform()")


class Pipeline(Estimator):
    """Fit stages left to right; transformer outputs feed later stages
    (Spark ``ml.Pipeline``).  Stages may be transformer estimators (fitted
    to models exposing ``transform``), already-fitted transformers, or a
    final predictor estimator."""

    stages = Param(
        None, is_estimator=True,
        doc="ordered transformers + final estimator, Spark Pipeline style",
    )

    @property
    def is_classifier(self):
        """A pipeline classifies iff some estimator stage does (the tuners
        then take the class count over the full labels)."""
        return any(
            getattr(s, "is_classifier", False) for s in (self.stages or [])
        )

    def fit(self, X, y=None, sample_weight=None, num_classes=None, mesh=None,
            device="cuda") -> "PipelineModel":
        if mesh is not None:
            not_supported("mesh", mesh, "queue 1, item 29")
        dev = resolve_device(device)
        fitted: List[Any] = []
        Xc = as_f32(X, dev)
        num_features = Xc.shape[1]
        for stage in list(self.stages or []):
            if isinstance(stage, (Transformer, Model)):
                # a fitted stage is a transformer stage, never re-fit
                # (Spark semantics)
                fitted.append(stage)
                if hasattr(stage, "transform"):
                    Xc = stage.transform(Xc)
            elif isinstance(stage, Estimator):
                if getattr(stage, "is_classifier", False):
                    model = stage.fit(Xc, y, sample_weight=sample_weight,
                                      num_classes=num_classes, device=dev)
                else:
                    model = stage.fit(Xc, y, sample_weight=sample_weight,
                                      device=dev)
                fitted.append(model)
                if hasattr(model, "transform"):
                    Xc = model.transform(Xc)
            else:
                raise TypeError(f"invalid pipeline stage {stage!r}")
        # the class count of the LAST stage that knows it (the predictor)
        num_classes = next(
            (m.num_classes for m in reversed(fitted)
             if getattr(m, "num_classes", None) is not None),
            None,
        )
        return PipelineModel(
            stage_models=fitted, num_features=num_features,
            num_classes=num_classes, device=dev, **self.get_params(),
        )


class PipelineModel(Model, Pipeline):
    def __init__(self, stage_models=None, num_classes=None, **kwargs):
        super().__init__(**kwargs)
        self.stage_models = stage_models or []
        self.num_classes = num_classes

    def _features(self, X):
        Xc = self._input(X)
        # as in fit(): a non-final stage without `transform` passes the
        # features through unchanged
        for stage in self.stage_models[:-1]:
            if hasattr(stage, "transform"):
                Xc = stage.transform(Xc)
        return Xc

    @property
    def _final(self):
        return self.stage_models[-1]

    def transform(self, X):
        """Every transformer stage; a final predictor stage (no
        ``transform``) is skipped, so the result is the feature matrix the
        final predictor reads."""
        Xc = self._input(X)
        for stage in self.stage_models:
            if hasattr(stage, "transform"):
                Xc = stage.transform(Xc)
        return Xc

    def predict(self, X):
        return self._final.predict(self._features(X))

    def predict_raw(self, X):
        return self._final.predict_raw(self._features(X))

    def predict_proba(self, X):
        return self._final.predict_proba(self._features(X))
