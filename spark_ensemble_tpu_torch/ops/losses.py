"""GBM loss layer (PyTorch port of ``ops/losses.py``): batched loss
functions over ``(label[n, dim], prediction[n, dim])`` tensors with
closed-form gradients and hessians.

The slice ports the two losses of the main path: ``squared`` regression
and ``logloss`` K-class softmax cross-entropy.  The other losses raise
``NotImplementedError`` from the factories (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import torch

_NOT_PORTED = "queue 1, item 3"


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

    def linesearch_grad_hess(self, label, prediction, directions, bag_w):
        """Closed-form ``(grad[dim], hess[dim, dim])`` of the step-size
        objective ``a -> sum_i bag_w_i * L(label_i, pred_i + a*dir_i)``
        at ``prediction``; the per-row diagonal hessian form, exact for
        ``dim == 1`` losses."""
        if not self.has_hessian:
            return None
        g = self.gradient(label, prediction)
        h = self.hessian(label, prediction)
        grad = torch.einsum("n,nk,nk->k", bag_w, g, directions)
        hess = torch.diag(
            torch.einsum("n,nk,nk->k", bag_w, h, directions * directions)
        )
        return grad, hess


class GBMClassificationLoss(GBMLoss):
    """Adds raw-score -> class-probability mapping."""

    num_classes: int = 2

    def raw2probability(self, raw):
        raise NotImplementedError


class SquaredLoss(GBMLoss):
    name = "squared"
    has_hessian = True

    def loss(self, label, prediction):
        return torch.sum((label - prediction) ** 2 / 2.0, dim=-1)

    def gradient(self, label, prediction):
        return -(label - prediction)

    def hessian(self, label, prediction):
        return torch.ones_like(prediction)


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


def get_regression_loss(name: str, alpha: float = 0.5, delta: float = 1.0,
                        quantile: float = 0.5) -> GBMLoss:
    """By-name lookup (case-insensitive); the slice ports ``squared``."""
    name = name.lower()
    if name == "squared":
        return SquaredLoss()
    if name in ("absolute", "logcosh", "scaledlogcosh", "huber", "quantile"):
        raise NotImplementedError(
            f"regression loss {name!r} is not ported yet (ROADMAP {_NOT_PORTED})"
        )
    raise ValueError(f"unknown regression loss {name!r}")


def get_classification_loss(name: str, num_classes: int = 2) -> GBMClassificationLoss:
    """By-name lookup; the slice ports ``logloss``."""
    name = name.lower()
    if name == "logloss":
        return LogLoss(num_classes)
    if name in ("exponential", "bernoulli"):
        raise NotImplementedError(
            f"classification loss {name!r} is not ported yet "
            f"(ROADMAP {_NOT_PORTED})"
        )
    raise ValueError(f"unknown classification loss {name!r}")
