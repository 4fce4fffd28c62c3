"""Multilayer-perceptron base learners, classifier and regressor (PyTorch
port of ``models/mlp.py``).

A fixed-topology MLP whose fit runs a fixed count of full-batch Adam steps
on the weighted loss, with the features standardized inside the fit (the
weighted mean and deviation of ``models/linear.py``) and, for the
regressor, the target too.  As in the JAX package:

- initialization is Glorot-uniform from the fit's key: one ``split`` per
  layer, ``W`` from the subkey, ``b`` zero (``utils/random.py``, so the
  initial weights equal the JAX package's bit for bit);
- the objective is ``sum(w * loss) / max(sum(w), 1e-30)``; its gradient
  comes from ``torch.autograd``, and the L2 term ``reg_param * W`` is added
  to each weight's gradient after it (biases are not penalized);
- Adam is optax's, in optax's order: ``mu = (1-b1) g + b1 mu``, ``nu =
  (1-b2) g^2 + b2 nu``, bias corrections ``1 - b^t`` taken in float32 on
  the host, then ``p - lr * mu_hat / (sqrt(nu_hat) + 1e-8)``.

Members batch along a leading member axis: ``fit_many_from_ctx`` trains
every member's network at once by ``torch.bmm`` (a single fit is the one-
member case), and ``predict_many_fn`` routes every member in one batched
forward pass.  The MLP is plain matmuls in the JAX package too (no Pallas
kernel), so it runs as ``torch`` products here.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    ClassificationModel,
    RegressionModel,
    as_f32,
    member_params,
)
from spark_ensemble_tpu_torch.models.linear import _apply_mask, _feature_stats
from spark_ensemble_tpu_torch.params import Param, gt, gt_eq, in_array
from spark_ensemble_tpu_torch.utils.random import PRNGKey, split, uniform

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _hidden_sizes_ok(v):
    # a scalar (the sklearn-style `hidden_layer_sizes=64` spelling) must
    # fail as an invalid value, not a TypeError from len()
    if not isinstance(v, (list, tuple)):
        return False
    return len(v) >= 1 and all(int(h) == h and h >= 1 for h in v)


def _stack(params):
    """One member's params -> the same params with a member axis of 1."""
    return {
        "layers": [{"W": p["W"][None], "b": p["b"][None]} for p in params["layers"]],
        **{k: v[None] for k, v in params.items() if k != "layers"},
    }


class _MLPBase(BaseLearner):
    hidden_layer_sizes = Param(
        (64,),
        _hidden_sizes_ok,
        doc="widths of the hidden layers (like Spark MLP's `layers` param)",
    )
    activation = Param(
        "relu", in_array(["relu", "tanh"]), doc="hidden-layer nonlinearity"
    )
    max_iter = Param(
        200,
        gt_eq(1),
        doc="full-batch Adam steps; a fixed count (no convergence-based "
        "stopping), as in the JAX package",
    )
    learning_rate_init = Param(1e-2, gt(0.0), doc="Adam learning rate")
    reg_param = Param(1e-4, gt_eq(0.0), doc="L2 penalty on weights (not biases)")
    seed = Param(0, doc="weight-init PRNG seed")

    def _sizes(self, d: int, out_dim: int):
        return (d, *[int(h) for h in self.hidden_layer_sizes], out_dim)

    def _act(self, z):
        return torch.relu(z) if self.activation == "relu" else torch.tanh(z)

    def _init_nets(self, keys, sizes):
        """Glorot-uniform layers of every member from its key ``[M, 2]``
        -> ``[{"W": [M, in, out], "b": [M, out]}, ...]``."""
        layers = []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            pair = split(keys, 2)
            keys, sub = pair[:, 0], pair[:, 1]
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            layers.append({
                "W": uniform(sub, (fan_in, fan_out), -lim, lim),
                "b": torch.zeros((keys.shape[0], fan_out), dtype=torch.float32,
                                 device=keys.device),
            })
        return layers

    def _forward(self, layers, Xs):
        """Batched forward ``Xs [M, n, d]`` -> ``[M, n, out]``."""
        h = Xs
        for layer in layers[:-1]:
            h = self._act(torch.baddbmm(layer["b"][:, None, :], h, layer["W"]))
        return torch.baddbmm(layers[-1]["b"][:, None, :], h, layers[-1]["W"])

    def _train_nets(self, Xs, w, keys, out_dim, per_example_loss):
        """Adam on every member's mean weighted loss -> trained layers.
        ``Xs [M, n, d]``, ``w [M, n]``; ``per_example_loss(out [M, n,
        out]) -> [M, n]``."""
        net = self._init_nets(keys, self._sizes(Xs.shape[2], out_dim))
        wsum = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-30)
        reg = float(np.float32(self.reg_param))
        lr = float(self.learning_rate_init)
        params = [t for layer in net for t in (layer["W"], layer["b"])]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        f32 = np.float32
        for t in range(1, int(self.max_iter) + 1):
            leaves = [p.detach().requires_grad_(True) for p in params]
            layers = [{"W": leaves[2 * i], "b": leaves[2 * i + 1]}
                      for i in range(len(net))]
            with torch.enable_grad():
                obj = torch.sum(torch.sum(w * per_example_loss(self._forward(layers, Xs)),
                                          dim=1, keepdim=True) / wsum)
                grads = list(torch.autograd.grad(obj, leaves))
            for i in range(0, len(grads), 2):  # L2 on the weights, after the loss
                grads[i] = grads[i] + reg * params[i]
            bc1 = float(f32(1) - f32(_B1) ** f32(t))
            bc2 = float(f32(1) - f32(_B2) ** f32(t))
            for i, g in enumerate(grads):
                mu[i] = (1 - _B1) * g + _B1 * mu[i]
                nu[i] = (1 - _B2) * (g * g) + _B2 * nu[i]
                update = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + _EPS)
                params[i] = params[i] + update * (-lr)
        return [{"W": params[2 * i], "b": params[2 * i + 1]} for i in range(len(net))]

    def _prep(self, X, feature_masks, ws):
        """Every member's masked, standardized features ``[M, n, d]`` and
        the stats and masks to keep."""
        M, d = ws.shape[1], X.shape[1]
        stats = []
        for m in range(M):
            mask = None if feature_masks is None else (
                feature_masks if feature_masks.dim() == 1 else feature_masks[m])
            Xm = _apply_mask(X, mask)
            mu, sd = _feature_stats(Xm, ws[:, m])
            stats.append(((Xm - mu[None, :]) / sd[None, :], mu, sd,
                          mask.to(torch.float32) if mask is not None
                          else torch.ones((d,), dtype=torch.float32, device=X.device)))
        Xs, mu, sd, mask = (torch.stack(z) for z in zip(*stats))
        return Xs, {"x_mu": mu, "x_sd": sd, "mask": mask}

    @staticmethod
    def _keys(keys, M, device):
        if keys is None:
            keys = PRNGKey(0, device)
        return keys[None].expand(M, 2) if keys.dim() == 1 else keys

    def _standardize(self, params, X):
        """``X [n, d]`` masked and standardized by each member's stats ->
        ``[M, n, d]`` (params stacked along a member axis)."""
        Xm = X[None] * params["mask"][:, None, :]
        return (Xm - params["x_mu"][:, None, :]) / params["x_sd"][:, None, :]

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None):
        stacked = self.fit_many_from_ctx(ctx, y[:, None], w[:, None],
                                         feature_mask, keys=key)
        return member_params(stacked, 0)


class MLPClassifier(_MLPBase):
    is_classifier = True

    def make_fit_ctx(self, X, num_classes: Optional[int] = None):
        return {"X": as_f32(X), "num_classes": num_classes}

    def fit_many_from_ctx(self, ctx, ys, ws, feature_masks, keys=None):
        """Every member's network trained at once (``_train_nets``)."""
        X, k = ctx["X"], int(ctx["num_classes"])
        M = ys.shape[1]
        Xs, stats = self._prep(X, feature_masks, ws)
        onehot = torch.nn.functional.one_hot(ys.T.to(torch.int64), k).to(torch.float32)

        def ce(logits):
            return -torch.sum(torch.log_softmax(logits, dim=-1) * onehot, dim=-1)

        layers = self._train_nets(Xs, ws.T, self._keys(keys, M, X.device), k, ce)
        return {"layers": layers, **stats}

    def predict_raw_many_fn(self, params, X):
        """Members' logits ``[M, n, k]``."""
        return self._forward(params["layers"], self._standardize(params, X))

    def predict_raw_fn(self, params, X):
        return self.predict_raw_many_fn(_stack(params), X)[0]

    def predict_proba_fn(self, params, X):
        return torch.softmax(self.predict_raw_fn(params, X), dim=-1)

    def predict_fn(self, params, X):
        return torch.argmax(self.predict_raw_fn(params, X), dim=-1).to(torch.float32)

    def predict_many_fn(self, params, X):
        return torch.argmax(self.predict_raw_many_fn(params, X), dim=-1).to(torch.float32)

    def predict_proba_many_fn(self, params, X):
        return torch.softmax(self.predict_raw_many_fn(params, X), dim=-1)

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return MLPClassificationModel(
            params=params, num_features=num_features,
            num_classes=num_classes or 2, device=device, **self.get_params(),
        )


class MLPClassificationModel(ClassificationModel, MLPClassifier):
    def predict_raw(self, X):
        return self.predict_raw_fn(self.params, self._input(X))

    def predict_proba(self, X):
        return self.predict_proba_fn(self.params, self._input(X))

    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))


class MLPRegressor(_MLPBase):
    is_classifier = False

    def fit_many_from_ctx(self, ctx, ys, ws, feature_masks, keys=None):
        """Every member's network trained at once (``_train_nets``), on
        targets standardized by each member's weighted moments (raw-scale
        targets would need a per-dataset learning rate)."""
        X = ctx
        M = ys.shape[1]
        Xs, stats = self._prep(X, feature_masks, ws)
        y, w = ys.T, ws.T  # [M, n]
        wsum = torch.clamp(torch.sum(w, dim=1), min=1e-30)
        y_mu = torch.sum(w * y, dim=1) / wsum
        y_var = torch.sum(w * (y - y_mu[:, None]) ** 2, dim=1) / wsum
        y_sd = torch.clamp(torch.sqrt(y_var), min=1e-7)
        yn = (y - y_mu[:, None]) / y_sd[:, None]

        def sq(out):
            return 0.5 * (out[:, :, 0] - yn) ** 2

        layers = self._train_nets(Xs, w, self._keys(keys, M, X.device), 1, sq)
        return {"layers": layers, "y_mu": y_mu, "y_sd": y_sd, **stats}

    def predict_many_fn(self, params, X):
        out = self._forward(params["layers"], self._standardize(params, X))
        return out[:, :, 0] * params["y_sd"][:, None] + params["y_mu"][:, None]

    def predict_fn(self, params, X):
        return self.predict_many_fn(_stack(params), X)[0]

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return MLPRegressionModel(
            params=params, num_features=num_features, device=device,
            **self.get_params(),
        )


class MLPRegressionModel(RegressionModel, MLPRegressor):
    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))
