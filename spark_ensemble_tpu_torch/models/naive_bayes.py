"""Gaussian naive Bayes base learner (PyTorch port of
``models/naive_bayes.py``): the stacking bench config's "NB" base.

Weighted per-class feature means and variances plus a log-prior; class
log-likelihoods sum per-feature Gaussian terms.  A feature-mask entry
zeroes that feature's log-likelihood contribution.
"""

from __future__ import annotations

import math

import torch

from spark_ensemble_tpu_torch.models.base import BaseLearner, ClassificationModel
from spark_ensemble_tpu_torch.ops.collective import preduce
from spark_ensemble_tpu_torch.params import Param, gt_eq


class GaussianNaiveBayes(BaseLearner):
    var_smoothing = Param(
        1e-6, gt_eq(0.0),
        doc="fraction of the largest feature variance added to every "
        "per-class variance for numerical stability",
    )

    is_classifier = True

    def make_fit_ctx(self, X, num_classes=None):
        return {"X": X, "num_classes": num_classes}

    def ctx_row_leaves(self, ctx):
        return {"X": True, "num_classes": False}

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None, axis_name=None):
        X = ctx["X"]
        k = int(ctx["num_classes"])
        d = X.shape[1]
        onehot = torch.nn.functional.one_hot(y.to(torch.int64), k).to(torch.float32)
        wc = onehot * w[:, None]  # [n, k]
        # the class moments reduced over the mesh's rows (one gather)
        present = (w > 0).to(torch.float32)
        class_w, wx, wxx, n_pr, x_sum = preduce(
            [torch.sum(wc, dim=0), wc.T @ X, wc.T @ (X * X),
             torch.sum(present)[None], torch.sum(X * present[:, None], dim=0)],
            axis_name,
        )
        denom = torch.clamp(class_w[:, None], min=1e-30)
        mean = wx / denom  # [k, d]
        var = wxx / denom - mean * mean
        # the smoothing floor's feature variance counts PRESENT rows only
        # (w > 0): zero-weight rows are out-of-bag and must not move it
        n_present = torch.clamp(n_pr[0], min=1.0)
        x_mu = x_sum / n_present
        x_var = preduce(
            torch.sum(((X - x_mu[None, :]) ** 2) * present[:, None], dim=0),
            axis_name,
        ) / n_present
        var = torch.clamp(var, min=0.0) + self.var_smoothing * torch.clamp(x_var, min=1e-12)
        prior = class_w / torch.clamp(torch.sum(class_w), min=1e-30)
        mask = (feature_mask.to(torch.float32) if feature_mask is not None
                else torch.ones((d,), dtype=torch.float32, device=X.device))
        return {
            "mean": mean,
            "var": var,
            "log_prior": torch.log(torch.clamp(prior, min=1e-30)),
            "mask": mask,
        }

    def predict_raw_fn(self, params, X):
        # [n, k, d] per-feature log-likelihood terms, masked then summed
        diff = X[:, None, :] - params["mean"][None, :, :]
        ll = -0.5 * (
            torch.log(2.0 * math.pi * params["var"])[None, :, :]
            + diff * diff / params["var"][None, :, :]
        )
        ll = ll * params["mask"][None, None, :]
        return params["log_prior"][None, :] + torch.sum(ll, dim=-1)

    def predict_proba_fn(self, params, X):
        return torch.softmax(self.predict_raw_fn(params, X), dim=-1)

    def predict_fn(self, params, X):
        return torch.argmax(self.predict_raw_fn(params, X), dim=-1).to(torch.float32)

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return GaussianNaiveBayesModel(
            params=params, num_features=num_features,
            num_classes=num_classes or 2, device=device, **self.get_params(),
        )


class GaussianNaiveBayesModel(ClassificationModel, GaussianNaiveBayes):
    def predict_proba(self, X):
        return self.predict_proba_fn(self.params, self._input(X))

    def predict_raw(self, X):
        return self.predict_raw_fn(self.params, self._input(X))

    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))
