"""GBM loss layer (PyTorch port of ``ops/losses.py``): batched loss
functions over ``(label[n, dim], prediction[n, dim])`` tensors with
closed-form gradients and hessians.

Inventory, as in the JAX package:

- regression (dim=1, identity label encoding): squared, absolute,
  logcosh, scaled logcosh(alpha), huber(delta), quantile(q);
- classification: logloss(K) softmax cross-entropy, and the binary
  exponential and bernoulli losses on {0,1} -> {-1,+1} labels with dim=1.

Absolute, huber and quantile have no hessian (``has_hessian=False``):
GBM's ``updates="newton"`` falls back to gradient pseudo-residuals for
them.  ``aggregate_loss`` is the weighted-mean objective, its sums reduced
across a mesh's ranks under ``axis_name``.
"""

from __future__ import annotations

import math

import torch

from spark_ensemble_tpu_torch.ops.collective import preduce


def _logcosh(x):
    # log(cosh(x)) computed stably: |x| + log1p(exp(-2|x|)) - log(2)
    a = torch.abs(x)
    return a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)


def _log1pexp(x):
    # log(1 + exp(x)) stably
    return torch.logaddexp(torch.zeros_like(x), x)


class GBMLoss:
    """Protocol: batched loss over ``label[n, dim]`` / ``prediction[n, dim]``.

    ``loss`` returns per-instance values ``[n]``; ``gradient`` and
    ``hessian`` return ``[n, dim]``."""

    dim: int = 1
    has_hessian: bool = False
    name: str = ""

    def encode_label(self, y: torch.Tensor) -> torch.Tensor:
        """``y[n] -> encoded[n, dim]`` (reference ``encodeLabel``)."""
        return y[:, None]

    def loss(self, label, prediction):
        raise NotImplementedError

    def gradient(self, label, prediction):
        raise NotImplementedError

    def negative_gradient(self, label, prediction):
        return -self.gradient(label, prediction)

    def hessian(self, label, prediction):
        raise NotImplementedError(f"{self.name} has no hessian")

    def sampling_scores(self, label, prediction):
        """Per-row gradient magnitude ``[n]``: the l2 norm of the negative
        gradient over the class dims (the statistic GOSS/MVS rank rows by)."""
        g = self.negative_gradient(label, prediction)
        return torch.sqrt(torch.sum(g * g, dim=-1))

    def linesearch_grad_hess(self, label, prediction, directions, bag_w):
        """Closed-form ``(grad[dim], hess[dim, dim])`` of the step-size
        objective ``a -> sum_i bag_w_i * L(label_i, pred_i + a*dir_i)``
        at ``prediction``; the per-row diagonal hessian form, exact for
        ``dim == 1`` losses.  None when the loss has no hessian."""
        if not self.has_hessian:
            return None
        g = self.gradient(label, prediction)
        h = self.hessian(label, prediction)
        grad = torch.einsum("n,nk,nk->k", bag_w, g, directions)
        hess = torch.diag(
            torch.einsum("n,nk,nk->k", bag_w, h, directions * directions)
        )
        return grad, hess

    def config(self) -> dict:
        """Serializable description; ``loss_from_config`` inverts it."""
        return {"name": self.name}


class GBMClassificationLoss(GBMLoss):
    """Adds raw-score -> class-probability mapping."""

    num_classes: int = 2

    def raw2probability(self, raw):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Regression losses
# ---------------------------------------------------------------------------


class SquaredLoss(GBMLoss):
    name = "squared"
    has_hessian = True

    def loss(self, label, prediction):
        return torch.sum((label - prediction) ** 2 / 2.0, dim=-1)

    def gradient(self, label, prediction):
        return -(label - prediction)

    def hessian(self, label, prediction):
        return torch.ones_like(prediction)


class AbsoluteLoss(GBMLoss):
    name = "absolute"

    def loss(self, label, prediction):
        return torch.sum(torch.abs(label - prediction), dim=-1)

    def gradient(self, label, prediction):
        return -torch.sign(label - prediction)


class LogCoshLoss(GBMLoss):
    name = "logcosh"
    has_hessian = True

    def loss(self, label, prediction):
        return torch.sum(_logcosh(label - prediction), dim=-1)

    def gradient(self, label, prediction):
        return -torch.tanh(label - prediction)

    def hessian(self, label, prediction):
        t = torch.tanh(label - prediction)
        return 1.0 - t * t


class ScaledLogCoshLoss(GBMLoss):
    """Asymmetric logcosh: alpha above the prediction, (1-alpha) below."""

    name = "scaledlogcosh"
    has_hessian = True

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha

    def _scale(self, label, prediction):
        return torch.where(
            label > prediction,
            torch.tensor(self.alpha, dtype=prediction.dtype, device=prediction.device),
            torch.tensor(1.0 - self.alpha, dtype=prediction.dtype, device=prediction.device),
        )

    def loss(self, label, prediction):
        return torch.sum(
            self._scale(label, prediction) * _logcosh(label - prediction), dim=-1
        )

    def gradient(self, label, prediction):
        return self._scale(label, prediction) * -torch.tanh(label - prediction)

    def hessian(self, label, prediction):
        t = torch.tanh(label - prediction)
        return self._scale(label, prediction) * (1.0 - t * t)

    def config(self):
        return {"name": self.name, "alpha": self.alpha}


class HuberLoss(GBMLoss):
    """Quadratic within ``delta`` of the label, linear beyond.  ``delta``
    is a float or a 0-d tensor (GBM's adaptive delta stays on the device)."""

    name = "huber"

    def __init__(self, delta=1.0):
        self.delta = delta

    def loss(self, label, prediction):
        r = label - prediction
        quad = r * r / 2.0
        lin = self.delta * (torch.abs(r) - self.delta / 2.0)
        return torch.sum(torch.where(torch.abs(r) <= self.delta, quad, lin), dim=-1)

    def gradient(self, label, prediction):
        r = label - prediction
        return torch.where(torch.abs(r) <= self.delta, -r, -self.delta * torch.sign(r))

    def config(self):
        return {"name": self.name, "delta": float(self.delta)}


class QuantileLoss(GBMLoss):
    name = "quantile"

    def __init__(self, quantile: float = 0.5):
        self.quantile = quantile

    def loss(self, label, prediction):
        r = label - prediction
        return torch.sum(
            torch.where(r > 0, self.quantile * r, (self.quantile - 1.0) * r), dim=-1
        )

    def gradient(self, label, prediction):
        r = label - prediction
        return torch.where(
            r > 0, torch.full_like(r, -self.quantile),
            torch.full_like(r, 1.0 - self.quantile),
        )

    def config(self):
        return {"name": self.name, "quantile": self.quantile}


# ---------------------------------------------------------------------------
# Classification losses
# ---------------------------------------------------------------------------


class LogLoss(GBMClassificationLoss):
    """K-class softmax cross-entropy on one-hot labels."""

    name = "logloss"
    has_hessian = True

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.dim = num_classes

    def encode_label(self, y):
        return torch.nn.functional.one_hot(
            y.to(torch.int64), self.num_classes
        ).to(torch.float32)

    def loss(self, label, prediction):
        lse = torch.logsumexp(prediction, dim=-1, keepdim=True)
        return torch.sum(-label * (prediction - lse), dim=-1)

    def gradient(self, label, prediction):
        return torch.softmax(prediction, dim=-1) - label

    def hessian(self, label, prediction):
        p = torch.softmax(prediction, dim=-1)
        return p * (1.0 - p)

    def linesearch_grad_hess(self, label, prediction, directions, bag_w):
        """Exact softmax form: per-row hessian ``diag(p) - p pᵀ``
        contracted with the directions, in one data pass."""
        p = torch.softmax(prediction, dim=-1)
        g = p - label
        grad = torch.einsum("n,nk,nk->k", bag_w, g, directions)
        pd = p * directions
        hess = torch.diag(
            torch.einsum("n,nk->k", bag_w, p * directions * directions)
        ) - torch.einsum("n,nj,nk->jk", bag_w, pd, pd)
        return grad, hess

    def raw2probability(self, raw):
        return torch.softmax(raw, dim=-1)

    def config(self):
        return {"name": self.name, "num_classes": self.num_classes}


class ExponentialLoss(GBMClassificationLoss):
    """AdaBoost exponential loss on {-1,+1}-encoded labels."""

    name = "exponential"
    has_hessian = True
    num_classes = 2

    def encode_label(self, y):
        return (2.0 * y - 1.0)[:, None]

    def loss(self, label, prediction):
        return torch.sum(torch.exp(-label * prediction), dim=-1)

    def gradient(self, label, prediction):
        return -label * torch.exp(-label * prediction)

    def hessian(self, label, prediction):
        return label * label * torch.exp(-label * prediction)

    def raw2probability(self, raw):
        # the reference's composed mapping on the K=2 raw vector (-f, f):
        # P(y=1) = sigmoid(2 * raw[0]) = sigmoid(-2 f)
        p1 = torch.sigmoid(2.0 * raw[..., 0])
        return torch.stack([1.0 - p1, p1], dim=-1)


class BernoulliLoss(GBMClassificationLoss):
    """Logistic loss on {-1,+1}-encoded labels."""

    name = "bernoulli"
    has_hessian = True
    num_classes = 2

    def encode_label(self, y):
        return (2.0 * y - 1.0)[:, None]

    def loss(self, label, prediction):
        return torch.sum(_log1pexp(-2.0 * label * prediction), dim=-1)

    def gradient(self, label, prediction):
        return -2.0 * label / (1.0 + torch.exp(2.0 * label * prediction))

    def hessian(self, label, prediction):
        e = torch.exp(2.0 * prediction * label)
        return (4.0 * e * label * label) / (1.0 + e) ** 2

    def raw2probability(self, raw):
        # raw = (-f, f): P(y=1) = 1 / (1 + exp(raw[0])) = sigmoid(f)
        p1 = torch.sigmoid(-raw[..., 0])
        return torch.stack([1.0 - p1, p1], dim=-1)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def get_regression_loss(name: str, alpha: float = 0.5, delta: float = 1.0,
                        quantile: float = 0.5) -> GBMLoss:
    """By-name lookup (case-insensitive)."""
    name = name.lower()
    if name == "squared":
        return SquaredLoss()
    if name == "absolute":
        return AbsoluteLoss()
    if name == "logcosh":
        return LogCoshLoss()
    if name == "scaledlogcosh":
        return ScaledLogCoshLoss(alpha)
    if name == "huber":
        return HuberLoss(delta)
    if name == "quantile":
        return QuantileLoss(quantile)
    raise ValueError(f"unknown regression loss {name!r}")


def get_classification_loss(name: str, num_classes: int = 2) -> GBMClassificationLoss:
    """By-name lookup (case-insensitive)."""
    name = name.lower()
    if name == "logloss":
        return LogLoss(num_classes)
    if name == "exponential":
        return ExponentialLoss()
    if name == "bernoulli":
        return BernoulliLoss()
    raise ValueError(f"unknown classification loss {name!r}")


def loss_from_config(cfg: dict) -> GBMLoss:
    """Inverse of ``GBMLoss.config``."""
    name = cfg["name"]
    if name == "logloss":
        return LogLoss(cfg["num_classes"])
    if name in ("exponential", "bernoulli"):
        return get_classification_loss(name)
    return get_regression_loss(
        name,
        alpha=cfg.get("alpha", 0.5),
        delta=cfg.get("delta", 1.0),
        quantile=cfg.get("quantile", 0.5),
    )


def aggregate_loss(loss: GBMLoss, label, weight, prediction,
                   axis_name=None) -> torch.Tensor:
    """Weighted-mean objective ``sum(w * L) / max(sum(w), 1e-30)``; under a
    mesh both sums are reduced over ``axis_name``, so every rank holds the
    same global mean (the reference's ``GBMLossAggregator``,
    `GBMLoss.scala:34-76`)."""
    num = torch.sum(weight * loss.loss(label, prediction))
    den = torch.sum(weight)
    if axis_name is not None:
        num, den = preduce(torch.stack([num, den]), axis_name)
    return num / torch.clamp(den, min=1e-30)
