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
support sample weights get them dropped with a warning.  Each member fit
and the stacker fit run under the retry layer (``max_retries``).  The
numeric guard (``on_nonfinite``) checks the members for NaN params and
drops a bad one (``skip_round``/``halve_step`` keep every finite member,
``stop_early`` the members before the first bad one); the stacker then
trains on the kept members' meta-features, and predict reads the same
member list.  A non-finite stacker is always fatal under the guard.

With telemetry each member fit is one round (``member_fit``: its fenced
wall time, the round index being the member index; with ``parallelism >
1`` the members' times overlap), and the stacker fit is the ``stacker``
phase.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    ClassificationModel,
    Estimator,
    Model,
    RegressionModel,
    _with_guard_events,
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
from spark_ensemble_tpu_torch.robustness.guards import tree_any_nan
from spark_ensemble_tpu_torch.telemetry.events import FitTelemetry
from spark_ensemble_tpu_torch.utils.instrumentation import (
    block_on_arrays,
    instrumented_fit,
)

logger = logging.getLogger(__name__)


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
        if mesh is not None:
            not_supported("mesh", mesh, "queue 1, item 29")

    def _fit_bases(self, bases, X, y, w, sample_weight, device, telem,
                   num_classes=None):
        """Fit the heterogeneous base learners, concurrently when
        ``parallelism > 1`` (order-preserving), each under the retry layer
        with its own chaos site, so one member's transient fault does not
        kill the other fits."""
        from spark_ensemble_tpu_torch.robustness.chaos import controller
        from spark_ensemble_tpu_torch.robustness.retry import retry_call

        ctl = controller()
        retry_policy = self._retry_policy()
        label = type(self).__name__

        def fit_one(job):
            idx, base = job
            sw = w if base.supports_weight else None
            if not base.supports_weight and sample_weight is not None:
                logger.warning(
                    "base learner %s does not support weights; ignoring",
                    type(base).__name__,
                )
            site = f"{label}:member:{idx}"

            def attempt():
                ctl.transient(site)
                if num_classes is not None and base.is_classifier:
                    return base.fit(X, y, sample_weight=sw,
                                    num_classes=num_classes, device=device)
                return base.fit(X, y, sample_weight=sw, device=device)

            t0 = time.perf_counter()
            model = retry_call(attempt, retry_policy, op=f"{label}.member_fit",
                               telem=telem)
            if getattr(model, "params", None) is not None:
                model.params = ctl.poison_tree(site, model.params)
            if telem.enabled:
                # fence before stamping: the member fit returns with work
                # still in flight
                block_on_arrays(model)
                telem.member_fit(idx, time.perf_counter() - t0,
                                 family=type(base).__name__)
            return model

        jobs = list(enumerate(bases))
        par = int(self.parallelism or 1)
        if par > 1 and len(bases) > 1:
            with ThreadPoolExecutor(max_workers=min(par, len(bases))) as ex:
                return list(ex.map(fit_one, jobs))
        return [fit_one(j) for j in jobs]

    def _fit_stacker(self, stacker, meta, y, w, device, telem,
                     num_classes=None):
        """The level-1 fit under the retry layer and its chaos site."""
        from spark_ensemble_tpu_torch.robustness.chaos import controller
        from spark_ensemble_tpu_torch.robustness.retry import retry_call

        ctl = controller()
        site = f"{type(self).__name__}:stacker"

        def attempt():
            ctl.transient(site)
            if num_classes is not None and stacker.is_classifier:
                return stacker.fit(meta, y, sample_weight=w,
                                   num_classes=num_classes, device=device)
            return stacker.fit(meta, y, sample_weight=w, device=device)

        stack_model = retry_call(attempt, self._retry_policy(),
                                 op=f"{type(self).__name__}.stacker_fit",
                                 telem=telem)
        if telem.enabled:
            block_on_arrays(stack_model)
            telem.phase_mark("stacker")
        return stack_model

    @staticmethod
    def _drop_bad_base_models(models, guard):
        """``on_nonfinite`` over the fitted level-0 members: a member with
        NaN params is dropped; ``stop_early`` keeps the members before the
        first bad one; at least one member must survive."""
        if not guard.active:
            return models
        bad = [i for i, m in enumerate(models)
               if tree_any_nan(getattr(m, "params", None))]
        if not bad:
            return models
        first = bad[0]
        if guard.policy == "raise":
            guard.raise_error(first, what="base model params", unit="member")
        if guard.policy == "stop_early":
            kept, action = models[:first], "stop_early"
        else:
            kept = [m for i, m in enumerate(models) if i not in set(bad)]
            action = "skip_round"
        if not kept:
            guard.raise_error(first, what="every base model's params", unit="member")
        guard.record(first, action, members_dropped=len(models) - len(kept),
                     members_kept=len(kept))
        return kept

    @staticmethod
    def _check_stacker(stack_model, n_members, guard):
        """A non-finite stacker is always fatal under the guard: every
        prediction routes through it."""
        if guard.active and tree_any_nan(getattr(stack_model, "params", None)):
            guard.raise_error(n_members, what="stacker params", unit="member")


class StackingRegressor(_StackingParams):
    is_classifier = False

    def _bases(self) -> List[BaseLearner]:
        return list(self.base_learners or [DecisionTreeRegressor(), LinearRegression()])

    def _stacker(self) -> BaseLearner:
        return self.stacker or LinearRegression()

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, mesh=None,
            device="cuda") -> "StackingRegressionModel":
        self._check_stacking_support(mesh)
        dev = resolve_device(device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w = resolve_weights(y, sample_weight)
        telem = FitTelemetry.start(self, n=X.shape[0], d=X.shape[1])
        telem.phase_mark("setup")
        guard = self._numeric_guard(telem)
        models = self._fit_bases(self._bases(), X, y, w, sample_weight, dev,
                                 telem)
        models = self._drop_bad_base_models(models, guard)
        meta = torch.stack([m.predict(X) for m in models], dim=1)  # [n, bases]
        stack_model = self._fit_stacker(self._stacker(), meta, y, w, dev, telem)
        self._check_stacker(stack_model, len(models), guard)
        model = _with_guard_events(guard, StackingRegressionModel(
            base_models=models, stack_model=stack_model,
            num_features=X.shape[1], device=dev, **self.get_params(),
        ))
        telem.finish(model=model, members=len(models))
        return model


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

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, num_classes=None, mesh=None,
            device="cuda") -> "StackingClassificationModel":
        self._check_stacking_support(mesh)
        dev = resolve_device(device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w = resolve_weights(y, sample_weight)
        num_classes = infer_num_classes(y, num_classes)
        telem = FitTelemetry.start(self, n=X.shape[0], d=X.shape[1],
                                   num_classes=int(num_classes))
        telem.phase_mark("setup")
        guard = self._numeric_guard(telem)
        models = self._fit_bases(self._bases(), X, y, w, sample_weight, dev,
                                 telem, num_classes=num_classes)
        models = self._drop_bad_base_models(models, guard)
        meta = self._meta_features(models, X)
        stack_model = self._fit_stacker(self._stacker(), meta, y, w, dev, telem,
                                        num_classes=num_classes)
        self._check_stacker(stack_model, len(models), guard)
        model = _with_guard_events(guard, StackingClassificationModel(
            base_models=models, stack_model=stack_model,
            num_features=X.shape[1], num_classes=num_classes, device=dev,
            **self.get_params(),
        ))
        telem.finish(model=model, members=len(models))
        return model


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
