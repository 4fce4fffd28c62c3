"""Stacked generalization (PyTorch port of ``models/stacking.py``).

Heterogeneous base learners fit on the full training split, concurrently
up to ``parallelism`` host threads (an order-preserving pool, as the
reference runs them in parallel Futures).  Their outputs are the meta-features:

- regression: the vector of base predictions;
- classification, by ``stack_method``: ``class`` -> each member's
  predicted class (1 column), ``raw`` -> raw scores (K columns),
  ``proba`` -> probabilities (K columns).

The stacker (meta-learner) trains on the meta-feature matrix; predict
routes a fresh meta-feature row through it.  Base learners that do not
support sample weights get them dropped with a warning.  The numeric
guard (``on_nonfinite``: "raise" or "off" in the port) checks the members
and the stacker for NaN params.  The JAX package's retry layer and chaos
sites wait for the runtime planes (ROADMAP Slice F); a failing member fit
raises on its first attempt, as ``max_retries`` says.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import List

import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    ClassificationModel,
    Estimator,
    Model,
    RegressionModel,
    as_f32,
    infer_num_classes,
    not_supported,
    resolve_device,
    resolve_weights,
)
from spark_ensemble_tpu_torch.models.linear import LinearRegression, LogisticRegression
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)
from spark_ensemble_tpu_torch.params import Param, in_array

logger = logging.getLogger(__name__)


def _params_have_nan(params) -> bool:
    """Any NaN in a model's params (tensors, dicts, tuples); NaN only, as
    trees carry +inf threshold sentinels."""
    if isinstance(params, torch.Tensor):
        return params.is_floating_point() and bool(torch.isnan(params).any())
    if isinstance(params, dict):
        return any(_params_have_nan(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return any(_params_have_nan(v) for v in params)
    return False


class _StackingParams(Estimator):
    base_learners = Param(
        None, is_estimator=True,
        doc="heterogeneous level-0 learner list (each fitted on the full "
        "training split); defaults per task in fit()",
    )
    stacker = Param(
        None, is_estimator=True,
        doc="level-1 meta-learner fitted on the members' outputs; "
        "defaults to a linear/logistic model",
    )
    parallelism = Param(
        1,
        doc="max concurrent base-learner fits: host threads, each "
        "launching on the current CUDA stream",
    )
    seed = Param(0, doc="PRNG seed (member fits are deterministic)")

    def _check_stacking_support(self, mesh):
        self._check_port_support()
        if mesh is not None:
            not_supported("mesh", mesh, "queue 1, item 18")

    def _fit_bases(self, bases, X, y, w, sample_weight, device, num_classes=None):
        """Fit the heterogeneous base learners, concurrently when
        ``parallelism > 1`` (order-preserving)."""

        def fit_one(base):
            sw = w if base.supports_weight else None
            if not base.supports_weight and sample_weight is not None:
                logger.warning(
                    "base learner %s does not support weights; ignoring",
                    type(base).__name__,
                )
            if num_classes is not None and base.is_classifier:
                return base.fit(X, y, sample_weight=sw, num_classes=num_classes,
                                device=device)
            return base.fit(X, y, sample_weight=sw, device=device)

        par = int(self.parallelism or 1)
        if par > 1 and len(bases) > 1:
            with ThreadPoolExecutor(max_workers=min(par, len(bases))) as ex:
                return list(ex.map(fit_one, bases))
        return [fit_one(b) for b in bases]

    def _drop_bad_base_models(self, models):
        """The numeric guard over the fitted level-0 members: under
        'raise' a member with NaN params raises (the JAX package's
        drop/skip recovery policies wait for Slice F)."""
        if str(self.on_nonfinite).lower() == "off":
            return models
        bad = [i for i, m in enumerate(models) if _params_have_nan(m.params)]
        if bad:
            raise FloatingPointError(
                f"non-finite base model params at member {bad[0]} in "
                f"{type(self).__name__} (on_nonfinite='raise')"
            )
        return models

    def _check_stacker(self, stack_model, n_members):
        """A non-finite stacker is always fatal under the guard: every
        prediction routes through it."""
        if str(self.on_nonfinite).lower() == "off":
            return
        if _params_have_nan(stack_model.params):
            raise FloatingPointError(
                f"non-finite stacker params at member {n_members} in "
                f"{type(self).__name__} (on_nonfinite='raise')"
            )


class StackingRegressor(_StackingParams):
    is_classifier = False

    def _bases(self) -> List[BaseLearner]:
        return list(self.base_learners or [DecisionTreeRegressor(), LinearRegression()])

    def _stacker(self) -> BaseLearner:
        return self.stacker or LinearRegression()

    def fit(self, X, y, sample_weight=None, mesh=None,
            device="cuda") -> "StackingRegressionModel":
        self._check_stacking_support(mesh)
        dev = resolve_device(device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w = resolve_weights(y, sample_weight)
        models = self._fit_bases(self._bases(), X, y, w, sample_weight, dev)
        models = self._drop_bad_base_models(models)
        meta = torch.stack([m.predict(X) for m in models], dim=1)  # [n, bases]
        stack_model = self._stacker().fit(meta, y, sample_weight=w, device=dev)
        self._check_stacker(stack_model, len(models))
        return StackingRegressionModel(
            base_models=models, stack_model=stack_model,
            num_features=X.shape[1], device=dev, **self.get_params(),
        )


class StackingRegressionModel(RegressionModel, StackingRegressor):
    def __init__(self, base_models=None, stack_model=None, **kwargs):
        super().__init__(**kwargs)
        self.base_models = base_models or []
        self.stack_model = stack_model

    def predict(self, X):
        X = self._input(X)
        meta = torch.stack([m.predict(X) for m in self.base_models], dim=1)
        return self.stack_model.predict(meta)


class StackingClassifier(_StackingParams):
    stack_method = Param(
        "class", in_array(["class", "raw", "proba"]),
        doc="meta-features fed to the stacker: predicted classes, raw "
        "scores, or class probabilities (reference StackingParams)",
    )

    is_classifier = True

    def _bases(self) -> List[BaseLearner]:
        return list(
            self.base_learners or [DecisionTreeClassifier(), LogisticRegression()]
        )

    def _stacker(self) -> BaseLearner:
        return self.stacker or LogisticRegression()

    def _meta_features(self, models: List[Model], X) -> torch.Tensor:
        method = self.stack_method.lower()
        cols = []
        for m in models:
            if method == "raw":
                cols.append(m.predict_raw(X))
            elif method == "proba":
                cols.append(m.predict_proba(X))
            else:
                cols.append(m.predict(X)[:, None])
        return torch.cat(cols, dim=1)

    def fit(self, X, y, sample_weight=None, num_classes=None, mesh=None,
            device="cuda") -> "StackingClassificationModel":
        self._check_stacking_support(mesh)
        dev = resolve_device(device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w = resolve_weights(y, sample_weight)
        num_classes = infer_num_classes(y, num_classes)
        models = self._fit_bases(self._bases(), X, y, w, sample_weight, dev,
                                 num_classes=num_classes)
        models = self._drop_bad_base_models(models)
        meta = self._meta_features(models, X)
        stacker = self._stacker()
        if stacker.is_classifier:
            stack_model = stacker.fit(meta, y, sample_weight=w,
                                      num_classes=num_classes, device=dev)
        else:
            stack_model = stacker.fit(meta, y, sample_weight=w, device=dev)
        self._check_stacker(stack_model, len(models))
        return StackingClassificationModel(
            base_models=models, stack_model=stack_model,
            num_features=X.shape[1], num_classes=num_classes, device=dev,
            **self.get_params(),
        )


class StackingClassificationModel(ClassificationModel, StackingClassifier):
    def __init__(self, base_models=None, stack_model=None, **kwargs):
        super().__init__(**kwargs)
        self.base_models = base_models or []
        self.stack_model = stack_model

    def predict_raw(self, X):
        return self.stack_model.predict_raw(self._meta_features(self.base_models, self._input(X)))

    def predict_proba(self, X):
        return self.stack_model.predict_proba(self._meta_features(self.base_models, self._input(X)))

    def predict(self, X):
        return torch.argmax(self.predict_raw(X), dim=-1).to(torch.float32)
