"""Evaluators with the Spark ML evaluator surface (PyTorch port of
``evaluation.py``).

Each evaluator has ``evaluate(model, X, y, sample_weight=None) -> float``,
which asks the model for what its metric needs (predictions or
probabilities), and ``is_larger_better``, the direction model selection
takes.  Metric names and sample-weight rules are the JAX package's: every
metric is a weighted mean over rows, with the weight sum clamped at 1e-30.
"""

from __future__ import annotations

import torch

from spark_ensemble_tpu_torch.models.base import as_f32, infer_num_classes
from spark_ensemble_tpu_torch.params import Param, Params, gt_eq, in_array


class Evaluator(Params):
    """Base evaluator (reference: Spark ``ml.evaluation.Evaluator``)."""

    is_larger_better = True

    def evaluate(self, model, X, y, sample_weight=None) -> float:
        raise NotImplementedError


def _labels_and_weights(y, sample_weight, device):
    y = as_f32(y, device)
    w = (torch.ones_like(y) if sample_weight is None
         else as_f32(sample_weight, device))
    return y, w


def regression_metrics(pred, y, w) -> dict:
    """mse, rmse, mae, r2 and var (Spark's explained variance, SSreg /
    weight sum) of ``pred`` against ``y`` under weights ``w``."""
    pred = pred.to(torch.float32)
    sw = torch.clamp(torch.sum(w), min=1e-30)
    err = pred - y
    mse = torch.sum(w * err * err) / sw
    mae = torch.sum(w * torch.abs(err)) / sw
    y_mean = torch.sum(w * y) / sw
    ss_tot = torch.sum(w * (y - y_mean) ** 2) / sw
    r2 = 1.0 - mse / torch.clamp(ss_tot, min=1e-30)
    var = torch.sum(w * (pred - y_mean) ** 2) / sw
    return {"mse": mse, "rmse": torch.sqrt(mse), "mae": mae, "r2": r2, "var": var}


class RegressionEvaluator(Evaluator):
    """Metrics rmse|mse|mae|r2|var (Spark ``RegressionEvaluator`` set)."""

    metric = Param(
        "rmse", in_array(["rmse", "mse", "mae", "r2", "var"]),
        doc="regression metric (Spark RegressionEvaluator names)",
    )

    @property
    def is_larger_better(self):
        return self.metric.lower() in ("r2", "var")

    def evaluate(self, model, X, y, sample_weight=None) -> float:
        pred = model.predict(X)
        y, w = _labels_and_weights(y, sample_weight, pred.device)
        return float(regression_metrics(pred, y, w)[self.metric.lower()])


def multiclass_metric(metric: str, pred, y, w, num_classes: int):
    """accuracy, hammingloss, weightedprecision, weightedrecall or f1 (the
    actual-frequency-weighted mean of per-class F1, as Spark's)."""
    sw = torch.clamp(torch.sum(w), min=1e-30)
    if metric == "accuracy":
        return torch.sum(w * (pred == y)) / sw
    if metric == "hammingloss":
        return torch.sum(w * (pred != y)) / sw
    p = torch.nn.functional.one_hot(pred.to(torch.int64), num_classes).to(torch.float32)
    t = torch.nn.functional.one_hot(y.to(torch.int64), num_classes).to(torch.float32)
    tp = torch.sum(w[:, None] * p * t, dim=0)
    pp = torch.sum(w[:, None] * p, dim=0)
    ap = torch.sum(w[:, None] * t, dim=0)
    precision = tp / torch.clamp(pp, min=1e-30)
    recall = tp / torch.clamp(ap, min=1e-30)
    if metric == "weightedprecision":
        return torch.sum(ap * precision) / sw
    if metric == "weightedrecall":
        return torch.sum(ap * recall) / sw
    f1 = 2.0 * precision * recall / torch.clamp(precision + recall, min=1e-30)
    return torch.sum(ap * f1) / sw


class MulticlassClassificationEvaluator(Evaluator):
    """accuracy|f1|weightedPrecision|weightedRecall|logLoss|hammingLoss
    (Spark ``MulticlassClassificationEvaluator`` set)."""

    metric = Param(
        "f1",
        in_array(["f1", "accuracy", "weightedprecision", "weightedrecall",
                  "logloss", "hammingloss"]),
        doc="multiclass metric (Spark MulticlassClassificationEvaluator "
        "names); f1 is the actual-frequency-weighted mean of per-class F1",
    )
    eps = Param(1e-15, gt_eq(0.0), doc="probability clamp for logLoss (Spark default)")

    @property
    def is_larger_better(self):
        return self.metric.lower() not in ("logloss", "hammingloss")

    def evaluate(self, model, X, y, sample_weight=None) -> float:
        metric = self.metric.lower()
        if metric == "logloss":
            proba = model.predict_proba(X)
            y, w = _labels_and_weights(y, sample_weight, proba.device)
            eps = float(self.eps)
            p = torch.clamp(proba, eps, 1.0 - eps)
            t = torch.nn.functional.one_hot(y.to(torch.int64), proba.shape[1])
            ll = -torch.sum(t * torch.log(p), dim=-1)
            return float(torch.sum(w * ll) / torch.clamp(torch.sum(w), min=1e-30))
        pred = model.predict(X)
        y, w = _labels_and_weights(y, sample_weight, pred.device)
        num_classes = int(getattr(model, "num_classes", None) or infer_num_classes(y))
        return float(multiclass_metric(metric, pred, y, w, num_classes))


def binary_curves(score, y, w):
    """Weighted ROC/PR points ``(tpr, fpr, precision)`` from positive-class
    scores, ranked descending by a stable sort.  Tied scores give one
    curve point per distinct threshold: each row takes the counts of the
    last row of its tie group."""
    order = torch.argsort(-score, stable=True)
    ss, ys, ws = score[order], y[order], w[order]
    pos = torch.sum(w * y)
    neg = torch.sum(w * (1.0 - y))
    tp = torch.cumsum(ws * ys, dim=0)
    fp = torch.cumsum(ws * (1.0 - ys), dim=0)
    start = torch.ones_like(ss, dtype=torch.bool)
    start[1:] = ss[1:] != ss[:-1]
    sid = torch.cumsum(start.to(torch.int64), dim=0) - 1
    last = torch.zeros(int(sid[-1]) + 1, dtype=torch.int64, device=score.device)
    last.scatter_reduce_(0, sid, torch.arange(ss.shape[0], device=score.device),
                         reduce="amax", include_self=False)
    tp, fp = tp[last[sid]], fp[last[sid]]
    tpr = tp / torch.clamp(pos, min=1e-30)
    fpr = fp / torch.clamp(neg, min=1e-30)
    precision = tp / torch.clamp(tp + fp, min=1e-30)
    return tpr, fpr, precision


class BinaryClassificationEvaluator(Evaluator):
    """areaUnderROC | areaUnderPR by trapezoids over the weighted
    score-ranked curves (Spark ``BinaryClassificationEvaluator``)."""

    metric = Param(
        "areaunderroc", in_array(["areaunderroc", "areaunderpr"]),
        doc="threshold-free binary metric over raw scores/probabilities",
    )

    is_larger_better = True

    def evaluate(self, model, X, y, sample_weight=None) -> float:
        proba = model.predict_proba(X)
        y, w = _labels_and_weights(y, sample_weight, proba.device)
        tpr, fpr, precision = binary_curves(proba[:, 1], y, w)
        zero = torch.zeros(1, device=tpr.device)
        if self.metric.lower() == "areaunderpr":
            # anchored at (recall 0, first precision), as Spark (SPARK-21806)
            recall = torch.cat([zero, tpr])
            prec = torch.cat([precision[:1], precision])
            return float(torch.trapezoid(prec, recall))
        return float(torch.trapezoid(torch.cat([zero, tpr]), torch.cat([zero, fpr])))
