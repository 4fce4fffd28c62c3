"""Estimator/Model base classes and the BaseLearner functional protocol
(PyTorch port of ``spark_ensemble_tpu/models/base.py``).

A base learner exposes the same functional triple as in the JAX package:

  - ``make_fit_ctx(X, num_classes)``: shared preprocessing computed once per
    ensemble fit (quantile binning for trees);
  - ``fit_from_ctx(ctx, y, w, feature_mask) -> params``: one member fit over
    fixed-shape tensors; row sampling arrives as ``w`` and feature
    subspaces as ``feature_mask``;
  - ``predict_fn(params, X)`` (+ ``predict_raw_fn``/``predict_proba_fn``).

PyTorch runs eagerly, so the JAX package's program caches
(``cached_program``, ``shared_fit_context``) have no counterpart here.
The member protocol takes no PRNG ``key``: the port's base learners (the
histogram trees) draw nothing, and the ensembles draw their bag weights
and feature masks themselves (``utils/random.py``) and pass them in as
``w`` and ``feature_mask``.  The mesh ``axis_name`` argument is absent
until the port grows distribution (ROADMAP queue 1, item 18).

Devices: every ``fit`` takes ``device`` (default ``"cuda"``); the fitted
model keeps its tensors there and moves predict inputs to it.  Asking for
CUDA where there is none raises — nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from spark_ensemble_tpu_torch.params import Param, Params, gt_eq, in_array


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent.  On CUDA, float32 matmuls are pinned to true fp32 (TF32 off):
    the ``"highest"`` precision contract of the histogram tiers."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        # "highest" is true fp32: TF32 keeps ~10 mantissa bits and would
        # move split choices against the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def as_f32(x, device=None) -> torch.Tensor:
    """``x`` (numpy, list or tensor) as a float32 tensor on ``device``
    (the tensor's own device when None)."""
    if isinstance(x, torch.Tensor):
        t = x.to(dtype=torch.float32)
        return t if device is None else t.to(device)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def not_supported(param: str, value, roadmap: str):
    """Raise for a Param value the port does not implement yet."""
    raise NotImplementedError(
        f"{param}={value!r} is not supported by the PyTorch port yet "
        f"(ROADMAP {roadmap})"
    )


def resolve_weights(y: torch.Tensor, sample_weight) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones_like(y, dtype=torch.float32)
    return as_f32(sample_weight, y.device)


def infer_num_classes(y, num_classes: Optional[int] = None) -> int:
    """Class count from labels, with the reference's label validation:
    labels must be finite non-negative integers; an explicit
    ``num_classes`` overrides inference and labels must lie in [0, K)."""
    ya = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    if ya.size == 0:
        raise ValueError("cannot infer num_classes from empty labels")
    if not np.all(np.isfinite(ya)):
        raise ValueError("classification labels must be finite")
    if np.any(ya != np.round(ya)) or np.any(ya < 0):
        bad = ya[(ya != np.round(ya)) | (ya < 0)][0]
        raise ValueError(
            f"classification labels must be non-negative integers; got {bad!r}"
        )
    k = int(ya.max()) + 1
    if num_classes is not None:
        num_classes = int(num_classes)
        if num_classes < 2:
            raise ValueError(f"num_classes must be >= 2; got {num_classes}")
        if k > num_classes:
            raise ValueError(
                f"labels contain class {k - 1} but num_classes={num_classes}; "
                f"labels must lie in [0, num_classes)"
            )
        return num_classes
    return max(k, 2)


def validate_fit_inputs(X, y=None, allow_nan=False, family=""):
    """Raise ``ValueError`` when X (or y) holds NaN/Inf, unless
    ``allow_nan`` (the JAX package's ``robustness/validate.py`` rule)."""
    if allow_nan:
        return
    bad = [
        name for name, a in (("X", X), ("y", y))
        if a is not None and a.is_floating_point()
        and not bool(torch.isfinite(a).all())
    ]
    if bad:
        prefix = f"{family}: " if family else ""
        raise ValueError(
            f"{prefix}{' and '.join(bad)} contains NaN or Inf values; "
            "ensemble fits would silently produce a non-finite model. Clean "
            "the inputs, or pass allow_nan=True to skip this check."
        )


class Model(Params):
    """A fitted model: estimator config + learned params on ``device``."""

    def __init__(self, params: Any = None, num_features: int = 0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.params = params
        self.num_features = num_features
        self.device = torch.device(device) if device is not None else None

    def _input(self, X) -> torch.Tensor:
        return as_f32(X, self.device)

    def predict(self, X) -> torch.Tensor:
        raise NotImplementedError

    @property
    def feature_importances_(self) -> np.ndarray:
        """Gain-based feature importances, normalized to sum 1 (Spark
        ``TreeEnsembleModel.featureImportances``): each member tree's gains
        are normalized to sum 1 first, members average with equal weight,
        and the average is renormalized.  Members with no realized split
        are skipped; an all-leaf model returns zeros."""
        gains = np.asarray(self._feature_gains_raw(), np.float64)
        gains = gains.reshape(-1, gains.shape[-1])
        sums = gains.sum(axis=1, keepdims=True)
        active = sums[:, 0] > 0
        if not active.any():
            return np.zeros(gains.shape[-1])
        imp = (gains[active] / sums[active]).mean(axis=0)
        return imp / imp.sum()

    def _feature_gains_raw(self):
        """Raw gains: ensemble models reach through their stacked members
        with the base learner's ``feature_gains_fn``; a standalone learner
        model is its own learner."""
        if isinstance(self.params, dict) and "members" in self.params:
            members = self.params["members"]
            if members is None:  # zero kept rounds or members
                return np.zeros((self.num_features,))
            gains = self._base().feature_gains_fn(members, self.num_features)
            return gains.detach().cpu().numpy()
        gains_fn = getattr(self, "feature_gains_fn", None)
        if gains_fn is None:
            raise AttributeError(
                f"{type(self).__name__} has no feature gains (gain-based "
                "importances exist for tree base learners only)"
            )
        return gains_fn(self.params, self.num_features).detach().cpu().numpy()

    def member(self, i: int) -> "Model":
        """Member ``i`` as a standalone fitted model, sliced out of the
        stacked members (a subspace-trained member predicts correctly
        without its mask: its splits never use masked features)."""
        if not (isinstance(self.params, dict) and "members" in self.params):
            raise AttributeError(f"{type(self).__name__} has no stacked members")
        members = self.params["members"]
        if members is None:
            raise IndexError("model kept zero members")
        n_members = members[0].shape[0]
        if not 0 <= i < n_members:
            raise IndexError(f"member index {i} out of range [0, {n_members})")
        base = self._base()
        return base.model_from_params(
            type(members)(*(a[i] for a in members)),
            self.num_features,
            getattr(self, "num_classes", None) if base.is_classifier else None,
            self.device,
        )


class RegressionModel(Model):
    def score(self, X, y, sample_weight=None) -> float:
        """R^2 on (X, y): ``RegressionEvaluator(metric="r2")``."""
        from spark_ensemble_tpu_torch.evaluation import RegressionEvaluator

        return RegressionEvaluator(metric="r2").evaluate(self, X, y, sample_weight)


class ClassificationModel(Model):
    """Adds raw scores / probabilities (reference: ProbabilisticClassifier)."""

    def __init__(self, num_classes: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes

    def predict_raw(self, X) -> torch.Tensor:
        raise NotImplementedError

    def predict_proba(self, X) -> torch.Tensor:
        raise NotImplementedError

    def predict(self, X) -> torch.Tensor:
        return torch.argmax(self.predict_proba(X), dim=-1).to(torch.float32)

    def score(self, X, y, sample_weight=None) -> float:
        """Accuracy on (X, y):
        ``MulticlassClassificationEvaluator(metric="accuracy")``."""
        from spark_ensemble_tpu_torch.evaluation import (
            MulticlassClassificationEvaluator,
        )

        return MulticlassClassificationEvaluator(metric="accuracy").evaluate(
            self, X, y, sample_weight
        )


class Estimator(Params):
    """Base estimator: ``fit(X, y, sample_weight, device=...) -> Model``."""

    is_classifier = False
    supports_weight = True

    profile_dir = Param(
        None,
        doc="profiler trace directory; not ported yet (ROADMAP Slice F)",
    )
    telemetry_path = Param(
        None,
        doc="telemetry JSONL path; not ported yet (ROADMAP Slice F)",
    )
    feature_names = Param(
        None, doc="optional column names for X; carried onto fitted models"
    )
    on_nonfinite = Param(
        "raise",
        in_array(["off", "raise", "skip_round", "halve_step", "stop_early"]),
        doc="numeric-guard policy when a round produces non-finite outputs; "
        "the port implements 'raise' and 'off' (the recovery policies wait "
        "for robustness/, ROADMAP Slice F)",
    )
    max_retries = Param(
        2,
        gt_eq(0),
        doc="retries of a transiently failing round dispatch in the JAX "
        "package; the port has no retry layer yet (ROADMAP Slice F), so a "
        "device error surfaces on the first attempt",
    )
    allow_nan = Param(
        False,
        doc="skip the fail-fast NaN/Inf validation of X/y at fit() entry",
    )

    def fit(self, X, y, sample_weight=None, device="cuda") -> Model:
        raise NotImplementedError

    def _check_port_support(self):
        """Raise for Param values the port does not implement yet."""
        if self.profile_dir is not None:
            not_supported("profile_dir", self.profile_dir, "Slice F")
        if self.telemetry_path is not None:
            not_supported("telemetry_path", self.telemetry_path, "Slice F")
        if str(self.on_nonfinite).lower() not in ("raise", "off"):
            not_supported("on_nonfinite", self.on_nonfinite, "Slice F")

    def _validate_fit_inputs(self, X, y=None):
        validate_fit_inputs(
            X, y, allow_nan=bool(self.allow_nan), family=type(self).__name__
        )


class BaseLearner(Estimator):
    """An estimator trainable through the functional member protocol."""

    def make_fit_ctx(self, X: torch.Tensor, num_classes: Optional[int] = None):
        """Shared preprocessing (binning, feature stats)."""
        return X

    def fit_from_ctx(self, ctx, y, w, feature_mask):
        """One member fit -> params."""
        raise NotImplementedError

    def fit_many_from_ctx(self, ctx, ys, ws, feature_masks):
        """Fit M members (``ys``/``ws`` [n, M]) -> stacked params with a
        leading member axis.  Tree learners fuse the members into one
        forest fit (``ops.tree.fit_forest``)."""
        raise NotImplementedError

    def fit_and_direction(self, ctx, y, w, feature_mask, X):
        """Member fit PLUS its predictions on the same rows -> (params,
        pred[n]).  Default: fit then predict."""
        params = self.fit_from_ctx(ctx, y, w, feature_mask)
        return params, self.predict_fn(params, X)

    def fit_many_and_directions(self, ctx, ys, ws, feature_masks, X):
        """Fused-member analogue of ``fit_and_direction`` -> (stacked
        params, preds[n, M])."""
        params = self.fit_many_from_ctx(ctx, ys, ws, feature_masks)
        return params, self.predict_many_fn(params, X).T

    def ctx_gather_rows(self, ctx, idx: torch.Tensor):
        """The fit ctx's rows ``idx[m]`` in a compacted ctx (GBM's gradient
        row sampling): downstream fits then process ``m`` rows.  The
        default ctx is the feature matrix itself; learners whose ctx mixes
        row-indexed and shared entries override (trees gather the bins and
        keep the thresholds)."""
        return ctx[idx]

    def fit_gathered_and_direction(self, ctx_s, y_s, w_s, feature_mask, X):
        """Member fit on a compacted ctx (``ctx_gather_rows``) PLUS the
        fitted member's predictions on ALL rows ``X`` -> (params, pred[n])."""
        params = self.fit_from_ctx(ctx_s, y_s, w_s, feature_mask)
        return params, self.predict_fn(params, X)

    def fit_gathered_many_and_directions(self, ctx_s, ys_s, ws_s,
                                         feature_masks, X):
        """Fused-member analogue of ``fit_gathered_and_direction`` ->
        (stacked params, preds[n, M])."""
        params = self.fit_many_from_ctx(ctx_s, ys_s, ws_s, feature_masks)
        return params, self.predict_many_fn(params, X).T

    def predict_fn(self, params, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def predict_many_fn(self, params, X: torch.Tensor) -> torch.Tensor:
        """Stacked-member predict -> [M, n]."""
        raise NotImplementedError

    def predict_raw_fn(self, params, X):
        raise NotImplementedError

    def predict_proba_fn(self, params, X):
        raise NotImplementedError

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None) -> Model:
        raise NotImplementedError

    def fit(self, X, y, sample_weight=None, num_classes=None,
            device="cuda") -> Model:
        """Fit this learner standalone on ``device``."""
        self._check_port_support()
        dev = resolve_device(device)
        X = as_f32(X, dev)
        y = as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w = resolve_weights(y, sample_weight)
        num_classes = (
            infer_num_classes(y, num_classes) if self.is_classifier else None
        )
        ctx = self.make_fit_ctx(X, num_classes)
        params = self.fit_from_ctx(ctx, y, w, None)
        return self.model_from_params(params, X.shape[1], num_classes, dev)
