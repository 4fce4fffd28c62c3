"""Model selection: ParamGridBuilder, CrossValidator, TrainValidationSplit
(PyTorch port of ``tuning.py``).

The reference's example wraps a ``BaggingClassifier`` in a
``CrossValidator`` over a ``ParamGridBuilder`` grid with a
``MulticlassClassificationEvaluator``; these are the port's counterparts,
with the JAX package's semantics:

- folds are ``jax.random.permutation(PRNGKey(seed), n)`` split round-robin
  (``utils/random.py::permutation`` draws the same permutation), and they
  are **weight masks**: every candidate fits on the FULL feature matrix,
  held-out rows at ``sample_weight = 0``, and is scored on the held-out
  rows with their true weights;
- the class count is taken once over the full labels, so a fold missing
  the top class cannot shrink a model;
- ``share_binning`` memoizes each learner config's fit context (its
  binning) over the search (``models/base.py::shared_fit_context``);
- ``megabatch`` ``"auto"`` fits each group of structurally equal GBM
  candidates as one lockstep sweep (``models/gbm_sweep.py``), whose models
  are bit-identical to the sequential fits, and falls back to sequential
  fits for the rest; ``"on"`` raises instead of falling back; ``"off"``
  fits every candidate by itself;
- the best map refits on the full data, and ``avg_metrics`` /
  ``validation_metrics`` keep Spark's names.

X moves to the device once, so every candidate reads the same tensor.
Each scored candidate emits a ``tuning_candidate`` event (map, fold,
metric, rounds, wall time, whether it was swept) to the tuner's
``telemetry_path`` or the other sinks; a swept group's wall time is the
sweep's, shared evenly.  ``profile_dir`` captures the whole search.
``mesh=`` raises until the port has distribution (ROADMAP queue 1, item
18).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_ensemble_tpu_torch.models.base import (
    Estimator,
    Model,
    as_f32,
    infer_num_classes,
    not_supported,
    resolve_device,
    shared_fit_context,
)
from spark_ensemble_tpu_torch.params import Param, gt_eq, in_array, in_range
from spark_ensemble_tpu_torch.telemetry.events import emit_event
from spark_ensemble_tpu_torch.utils.instrumentation import instrumented_fit
from spark_ensemble_tpu_torch.utils.random import PRNGKey, permutation

logger = logging.getLogger(__name__)


class ParamGridBuilder:
    """Cartesian-product grids of estimator params (Spark ``ParamGridBuilder``)."""

    def __init__(self):
        self._grid: Dict[str, Sequence[Any]] = {}

    def add_grid(self, name: str, values: Sequence[Any]) -> "ParamGridBuilder":
        self._grid[name] = list(values)
        return self

    def base_on(self, fixed: Dict[str, Any]) -> "ParamGridBuilder":
        for name, value in fixed.items():
            self._grid[name] = [value]
        return self

    def build(self) -> List[Dict[str, Any]]:
        names = list(self._grid)
        combos = itertools.product(*(self._grid[n] for n in names))
        return [dict(zip(names, c)) for c in combos]


def _permutation(n: int, seed: int) -> np.ndarray:
    return permutation(PRNGKey(seed), n).numpy()


def _kfold_indices(n: int, num_folds: int, seed: int) -> List[np.ndarray]:
    """Shuffled, near-equal fold membership masks (bool[n] per fold)."""
    perm = _permutation(n, seed)
    folds = []
    for f in range(num_folds):
        mask = np.zeros((n,), bool)
        mask[perm[f::num_folds]] = True
        folds.append(mask)
    return folds


def _full_num_classes(estimator, y):
    """Class count over the FULL label set, taken once per search: a fold's
    train split may miss the top class.  None for regressors."""
    if not getattr(estimator, "is_classifier", False):
        return None
    return infer_num_classes(y)


def _fit(est, X, y, w, num_classes, device):
    if num_classes is not None:
        return est.fit(X, y, sample_weight=w, num_classes=num_classes,
                       device=device)
    return est.fit(X, y, sample_weight=w, device=device)


class _TuningParams(Estimator):
    estimator = Param(None, is_estimator=True, doc="estimator to tune")
    evaluator = Param(
        None, is_estimator=True,
        doc="metric (RegressionEvaluator / *ClassificationEvaluator); "
        "its is_larger_better drives model selection",
    )
    estimator_param_maps = Param(
        None, doc="list of param dicts (ParamGridBuilder.build())"
    )
    parallelism = Param(1, gt_eq(1), doc="API parity; fits run back-to-back")
    seed = Param(0, doc="fold-split PRNG seed")
    share_binning = Param(
        True,
        doc="compute each learner config's fit context (feature binning) "
        "ONCE per search and reuse it across param maps, folds and the "
        "best-map refit, sound because weight-mask folds fit every "
        "candidate on the identical full X; scores are bit-identical "
        "either way",
    )
    megabatch = Param(
        "auto", in_array(["off", "auto", "on"]),
        doc="fit each group of structurally equal GBM candidates as one "
        "lockstep sweep (models/gbm_sweep.py; scores bit-identical to the "
        "sequential loop); 'auto' falls back to sequential fits for the "
        "rest and when share_binning=False, 'on' raises instead, 'off' "
        "fits every candidate by itself",
    )

    def _maps(self) -> List[Dict[str, Any]]:
        return list(self.estimator_param_maps or [{}])

    def _prepare(self, X, y, sample_weight, mesh, device):
        """Validate, and move the data to the device once -> ``(dev, X, y,
        w)``; ``y`` and ``w`` stay on the host for the fold masks."""
        if mesh is not None:
            not_supported("mesh", mesh, "queue 1, item 29")
        dev = resolve_device(device)
        X = as_f32(X, dev)  # one conversion: every fit reads this tensor
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        w = None
        if sample_weight is not None:
            w = (sample_weight.detach().cpu().numpy()
                 if isinstance(sample_weight, torch.Tensor)
                 else np.asarray(sample_weight))
        return dev, X, y, w

    def _binning_scope(self):
        """The search runs under a shared fit-ctx scope when
        ``share_binning``."""
        if self.share_binning:
            return shared_fit_context()
        return contextlib.nullcontext()

    def _emit_candidate(self, mi, fi, metric, model, wall_s, megabatch):
        """One scored candidate: a log line and a ``tuning_candidate``
        event."""
        logger.info(
            "%s map %d fold %d: %.5f%s", type(self).__name__, mi, fi,
            metric, " [megabatch]" if megabatch else "",
        )
        emit_event(
            "tuning_candidate",
            path=self.telemetry_path or None,
            tuner=type(self).__name__,
            map_index=int(mi),
            fold=int(fi),
            metric=float(metric),
            rounds=int(getattr(model, "num_members", 0) or 0),
            wall_s=float(wall_s),
            megabatch=bool(megabatch),
        )

    def _candidate_metrics(self, X, y, w, maps, eval_masks, evaluator, k,
                           dev) -> np.ndarray:
        """Fit and score every (param-map, fold) candidate ->
        ``metrics[map, fold]``.  Under ``megabatch`` != 'off' the GBM
        candidates that share every structural param fit as one sweep;
        the others (and every candidate at 'off') fit one by one."""
        mode = self.megabatch.lower()
        base_w = w if w is not None else np.ones((X.shape[0],), np.float32)
        metrics = np.zeros((len(maps), len(eval_masks)))
        cands = [
            (mi, fi, pmap, eval_mask)
            for fi, eval_mask in enumerate(eval_masks)
            for mi, pmap in enumerate(maps)
        ]

        def score(model, eval_mask):
            idx = torch.as_tensor(np.nonzero(eval_mask)[0], device=dev)
            we = w[eval_mask] if w is not None else None
            return evaluator.evaluate(model, X[idx], y[eval_mask], sample_weight=we)

        def train_w(eval_mask):
            return np.where(~eval_mask, base_w, 0.0).astype(np.float32)

        seq: List[tuple] = []
        groups: Dict[Any, List[tuple]] = {}
        if mode != "off" and not self.share_binning:
            # a megabatch IS shared binning: every lane trains on one
            # binned matrix, so an explicit opt-out wins over 'auto'
            if mode == "on":
                raise ValueError(
                    "megabatch='on' requires share_binning=True: every "
                    "sweep lane trains on the shared binned matrix"
                )
            mode = "off"
        if mode != "off":
            from spark_ensemble_tpu_torch.models.gbm_sweep import (
                sweep_group_key,
                sweep_unsupported_reason,
            )

            for cand in cands:
                est = self.estimator.copy(**cand[2])
                reason = sweep_unsupported_reason(est)
                if reason is not None:
                    if mode == "on":
                        raise ValueError(f"megabatch='on': {reason}")
                    seq.append(cand)
                else:
                    groups.setdefault(sweep_group_key(est), []).append((cand, est))
        else:
            seq = cands

        for items in groups.values():
            from spark_ensemble_tpu_torch.models.gbm_sweep import fit_sweep

            t0 = time.perf_counter()
            models = fit_sweep(
                [est for _, est in items], X, y,
                sample_weights=[train_w(cand[3]) for cand, _ in items],
                num_classes=k, telemetry_path=self.telemetry_path or None,
                device=dev,
            )
            # per-candidate wall is the sweep's amortized over the group;
            # per-round attribution is in the sweep_chunk events
            per_wall = (time.perf_counter() - t0) / max(1, len(items))
            for (cand, _), model in zip(items, models):
                mi, fi, _, eval_mask = cand
                metrics[mi, fi] = score(model, eval_mask)
                self._emit_candidate(mi, fi, metrics[mi, fi], model, per_wall,
                                     True)

        for mi, fi, pmap, eval_mask in seq:
            t0 = time.perf_counter()
            model = _fit(self.estimator.copy(**pmap), X, y, train_w(eval_mask),
                         k, dev)
            metrics[mi, fi] = score(model, eval_mask)
            self._emit_candidate(mi, fi, metrics[mi, fi], model,
                                 time.perf_counter() - t0, False)
        return metrics

    def _best(self, metrics) -> int:
        return int(np.argmax(metrics) if self.evaluator.is_larger_better
                   else np.argmin(metrics))


class CrossValidator(_TuningParams):
    """k-fold CV over a param grid (Spark ``CrossValidator``)."""

    num_folds = Param(3, gt_eq(2), doc="cross-validation folds")

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, mesh=None,
            device="cuda") -> "CrossValidatorModel":
        dev, X, y, w = self._prepare(X, y, sample_weight, mesh, device)
        maps = self._maps()
        folds = _kfold_indices(X.shape[0], self.num_folds, self.seed)
        k = _full_num_classes(self.estimator, y)
        with self._binning_scope():
            metrics = self._candidate_metrics(X, y, w, maps, folds,
                                              self.evaluator, k, dev)
            avg = metrics.mean(axis=1)
            best_idx = self._best(avg)
            best_model = self.estimator.copy(**maps[best_idx]).fit(
                X, y, sample_weight=w, device=dev)
        return CrossValidatorModel(
            best_model=best_model,
            avg_metrics=avg.tolist(),
            fold_metrics=metrics.tolist(),
            best_index=best_idx,
            num_features=X.shape[1],
            device=dev,
            **self.get_params(),
        )


class _TunedModel(Model):
    """A tuner's result: predictions come from its best model."""

    def predict(self, X):
        return self.best_model.predict(X)

    def predict_raw(self, X):
        return self.best_model.predict_raw(X)

    def predict_proba(self, X):
        return self.best_model.predict_proba(X)


class CrossValidatorModel(_TunedModel, CrossValidator):
    def __init__(self, best_model: Optional[Model] = None,
                 avg_metrics: Optional[List[float]] = None, fold_metrics=None,
                 best_index: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.best_model = best_model
        self.avg_metrics = avg_metrics or []
        self.fold_metrics = fold_metrics or []
        self.best_index = best_index


class TrainValidationSplit(_TuningParams):
    """Single random train/validation split sweep (Spark
    ``TrainValidationSplit``)."""

    train_ratio = Param(
        0.75,
        in_range(0.0, 1.0, lower_inclusive=False, upper_inclusive=False),
        doc="fraction of rows in the training split",
    )

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, mesh=None,
            device="cuda") -> "TrainValidationSplitModel":
        dev, X, y, w = self._prepare(X, y, sample_weight, mesh, device)
        maps = self._maps()
        n = X.shape[0]
        perm = _permutation(n, self.seed)
        train_mask = np.zeros((n,), bool)
        train_mask[perm[:int(n * self.train_ratio)]] = True
        k = _full_num_classes(self.estimator, y)
        with self._binning_scope():
            metrics = self._candidate_metrics(X, y, w, maps, [~train_mask],
                                              self.evaluator, k, dev)[:, 0]
            best_idx = self._best(metrics)
            best_model = self.estimator.copy(**maps[best_idx]).fit(
                X, y, sample_weight=w, device=dev)
        return TrainValidationSplitModel(
            best_model=best_model,
            validation_metrics=metrics.tolist(),
            best_index=best_idx,
            num_features=X.shape[1],
            device=dev,
            **self.get_params(),
        )


class TrainValidationSplitModel(_TunedModel, TrainValidationSplit):
    def __init__(self, best_model: Optional[Model] = None,
                 validation_metrics: Optional[List[float]] = None,
                 best_index: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.best_model = best_model
        self.validation_metrics = validation_metrics or []
        self.best_index = best_index
