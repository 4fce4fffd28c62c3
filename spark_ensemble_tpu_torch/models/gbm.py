"""Gradient Boosting Machines on one device (PyTorch port of
``models/gbm.py``).

Each round runs, as in the JAX package:

1. the loss gradient and hessian -> pseudo-residuals and fit weights
   (``_pseudo_residuals_and_weights``: the reference's ``max(h, 1e-2)``
   hessian floor and ``0.5 * h / sum_h * w`` scaling for ``"newton"``);
2. one fused tree fit over all class dims (``DecisionTreeRegressor.
   fit_many_and_directions`` -> ``ops.tree.fit_forest``), whose leaf ids
   give the round's directions on the training rows;
3. the step sizes: the closed-form minimizer for squared loss, Brent's
   search over [0, 100] for the other regression losses, projected Newton
   over the class dims for the classification losses;
4. the prediction update.

Huber's delta adapts as in the JAX package: the alpha-quantile of the
labels for the initial validation loss, then the alpha-quantile of
``|y - pred|`` re-taken on the device before every round.

The JAX package compiles chunks of rounds into one XLA program; here the
round loop is a host loop equal to its ``_drive_rounds`` at pipeline depth
0, with validation early stop (``_patience_step``).

Uniform sampling (``subsample_ratio``, ``replacement``, ``subspace_ratio``)
draws the JAX package's plan bit for bit (``utils/random.py``): member
``i``'s key is ``fold_in(PRNGKey(seed), i)``, its bag weights come from
``fold_in(key, 2)`` and its feature mask from ``fold_in(key, 1)``.  At the
defaults (``subsample_ratio=1.0`` without replacement, ``subspace_ratio=1.0``)
those draws are all ones and all True, so the port skips them.  Gradient
sampling (``sampling`` goss/mvs, ``sample_method="goss"``), linear leaves
and the planes not ported yet (checkpoints, telemetry, meshes) raise
``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    ClassificationModel,
    Estimator,
    RegressionModel,
    as_f32,
    infer_num_classes,
    not_supported,
    resolve_device,
    resolve_weights,
)
from spark_ensemble_tpu_torch.models.dummy import DummyClassifier, DummyRegressor
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor, check_tree_base
from spark_ensemble_tpu_torch.ops import losses as losses_mod
from spark_ensemble_tpu_torch.ops.linesearch import brent_minimize, projected_newton_box
from spark_ensemble_tpu_torch.ops.tree import Tree
from spark_ensemble_tpu_torch.params import Param, Params, gt, gt_eq, in_array, in_range
from spark_ensemble_tpu_torch.utils.quantile import weighted_quantile
from spark_ensemble_tpu_torch.utils.random import (
    PRNGKey,
    bootstrap_weights,
    fold_in,
    subspace_mask,
)

logger = logging.getLogger(__name__)


def stack_trees(trees: List[Tree]) -> Tree:
    """Per-round trees -> one Tree with a leading round axis."""
    return Tree(*(torch.stack(fields) for fields in zip(*trees)))


class _GBMParams(Params):
    """Shared GBM params (names, defaults and validators of the JAX
    package's ``_GBMParams``)."""

    base_learner = Param(
        None, is_estimator=True,
        doc="base learner fitted each round on the pseudo-residuals; "
        "defaults to a depth-5 histogram DecisionTreeRegressor",
    )
    num_base_learners = Param(
        10, gt_eq(1), doc="boosting rounds (reference maxIter analogue)"
    )
    learning_rate = Param(
        1.0, gt(0.0), doc="shrinkage applied to each round's step"
    )
    optimized_weights = Param(
        True,
        doc="line-search the per-round step size(s): closed form for "
        "squared loss, Brent for the other regression losses, projected "
        "Newton over the class dims for classification; False uses 1.0",
    )
    updates = Param(
        "gradient", in_array(["gradient", "newton"]),
        doc="pseudo-residual rule: 'gradient' fits -g, 'newton' fits -g/h",
    )
    subsample_ratio = Param(
        1.0, in_range(0.0, 1.0, lower_inclusive=False),
        doc="per-round row subsample (Bernoulli 0/1 weights, or Poisson "
        "counts with replacement)",
    )
    sample_method = Param(
        "uniform", in_array(["uniform", "goss"]),
        doc="'goss' weight-mask sampling is not ported yet",
    )
    top_rate = Param(0.2, in_range(0.0, 1.0), doc="GOSS/MVS top fraction")
    other_rate = Param(
        0.1, in_range(0.0, 1.0, lower_inclusive=False),
        doc="GOSS/MVS sampled fraction of the rest",
    )
    sampling = Param(
        "none", in_array(["none", "goss", "mvs"]),
        doc="gradient-based row sampling with compaction; only 'none' is "
        "ported (ROADMAP queue 1, item 12)",
    )
    mvs_lambda = Param(0.1, gt_eq(0.0), doc="MVS regularizer")
    leaf_model = Param(
        "constant", in_array(["constant", "linear"]),
        doc="'linear' ridge leaves are not ported yet",
    )
    replacement = Param(False, doc="subsample with replacement (Poisson weights)")
    subspace_ratio = Param(
        1.0, in_range(0.0, 1.0, lower_inclusive=False),
        doc="per-round feature-subspace ratio (a Bernoulli feature mask)",
    )
    max_iter = Param(100, gt_eq(1), doc="line-search iteration cap per round")
    tol = Param(1e-6, gt_eq(0.0), doc="line-search convergence tolerance")
    num_rounds = Param(
        1, gt_eq(1),
        doc="early-stop patience: stop after this many consecutive rounds "
        "without validation improvement > validation_tol",
    )
    validation_tol = Param(
        0.01, gt_eq(0.0),
        doc="minimum relative validation-loss improvement that resets the "
        "early-stop patience counter",
    )
    seed = Param(0, doc="PRNG seed for the sampling plans")
    aggregation_depth = Param(2, gt_eq(1), doc="API parity")
    scan_chunk = Param(
        16, gt_eq(1),
        doc="rounds per compiled dispatch in the JAX package; the port's "
        "eager round loop has no dispatch grouping, so it does not change "
        "any result",
    )
    checkpoint_interval = Param(
        10, gt_eq(1), doc="rounds between training-state checkpoints"
    )
    checkpoint_dir = Param(
        None, doc="training-state checkpoints; not ported yet (ROADMAP "
        "queue 1, item 16)",
    )

    def _base(self) -> BaseLearner:
        return self.base_learner or DecisionTreeRegressor()

    def _check_gbm_support(self, mesh):
        """Raise for every Param value this slice does not implement."""
        self._check_port_support()
        if mesh is not None:
            not_supported("mesh", mesh, "queue 1, item 18")
        check_tree_base(self._base(), type(self).__name__)
        if self.checkpoint_dir is not None:
            not_supported("checkpoint_dir", self.checkpoint_dir, "queue 1, item 16")
        if str(self.sample_method).lower() != "uniform":
            not_supported("sample_method", self.sample_method, "queue 1, item 12")
        if str(self.sampling).lower() != "none":
            not_supported("sampling", self.sampling, "queue 1, item 12")
        if str(self.leaf_model).lower() != "constant":
            not_supported("leaf_model", self.leaf_model, "queue 1, item 12")

    def _sampling_plan(self, n: int, d: int, device):
        """The per-round draws -> ``sample(i) -> (bag_w f32[n], mask
        bool[d] | None)``: the JAX package's ``_sampling_plan`` and
        ``_make_bag_many_fn``.  Draws that are all ones (all True) at the
        defaults are skipped."""
        m = int(self.num_base_learners)
        repl, ratio = bool(self.replacement), float(self.subsample_ratio)
        sub_ratio = float(self.subspace_ratio)
        keys = fold_in(PRNGKey(self.seed, device), torch.arange(m, device=device))
        bag_keys = fold_in(keys, 2)
        masks = subspace_mask(fold_in(keys, 1), d, sub_ratio) if sub_ratio < 1.0 else None
        ones = torch.ones((n,), dtype=torch.float32, device=device)

        def sample(i):
            bag_w = (bootstrap_weights(bag_keys[i], n, repl, ratio)
                     if repl or ratio < 1.0 else ones)
            return bag_w, None if masks is None else masks[i]

        return sample

    @staticmethod
    def _patience_step(best: float, err: float, v: int, validation_tol: float):
        """Reference early-stop bookkeeping (`GBMRegressor.scala:457-465`)."""
        if best - err < validation_tol * max(err, 0.01):
            return best, v + 1
        return err, 0

    def _drive_rounds(self, run_round, best: float):
        """The host round loop (the JAX package's ``_drive_rounds`` at
        pipeline depth 0): ``run_round(i) -> (params, weight, err|None)``.
        Returns ``(members, weights, rounds_run, v, val_history)``; the
        caller keeps ``rounds_run - v`` members."""
        members, weights, val_history = [], [], []
        i, v = 0, 0
        label = type(self).__name__
        check = str(self.on_nonfinite).lower() == "raise"
        while i < self.num_base_learners and v < self.num_rounds:
            params, weight, err = run_round(i)
            if check and not bool(
                torch.isfinite(weight).all() & torch.isfinite(params.leaf_value).all()
            ):
                raise FloatingPointError(
                    f"{label} round {i} produced non-finite member params or "
                    "step sizes (on_nonfinite='raise')"
                )
            members.append(params)
            weights.append(weight)
            i += 1
            if err is not None:
                err = float(err)
                val_history.append(err)
                best, v = self._patience_step(best, err, v, self.validation_tol)
                logger.info("%s round %d: val_loss=%.6f patience=%d",
                            label, i - 1, err, v)
        return members, weights, i, v, val_history

    @property
    def validation_history_(self) -> np.ndarray:
        """Per-round validation losses of a fit with a validation split."""
        params = getattr(self, "params", None)
        vh = params.get("val_hist") if isinstance(params, dict) else None
        if vh is None:
            raise AttributeError(
                "validation_history_ exists only on models fit with a "
                "validation split (validation_indicator=...)"
            )
        return np.asarray(vh)


def _split_validation(X, y, w_all, validation_indicator):
    if validation_indicator is None:
        return X, y, w_all, None, None
    vi = torch.as_tensor(np.asarray(validation_indicator, bool), device=X.device)
    return X[~vi], y[~vi], w_all[~vi], X[vi], y[vi]


def _pseudo_residuals_and_weights(loss, updates, y_enc, pred, bag_w, w):
    """Targets/weights for the round's base fit -> (labels[n, dim],
    fit_w[n, dim], bag_w)."""
    neg_grad = loss.negative_gradient(y_enc, pred)
    if updates == "newton" and loss.has_hessian:
        h = torch.clamp(loss.hessian(y_enc, pred), min=1e-2)
        sum_h = torch.sum(bag_w[:, None] * h, dim=0, keepdim=True)
        labels = neg_grad / h
        fit_w = 0.5 * h / torch.clamp(sum_h, min=1e-30) * (w * bag_w)[:, None]
    else:
        labels = neg_grad
        fit_w = (w * bag_w)[:, None].expand_as(neg_grad)
    return labels, fit_w, bag_w


def _make_reg_loss(loss_name, alpha_q, delta):
    """The round's loss: huber at this round's ``delta``, the alpha-shaped
    losses at ``alpha_q``."""
    if loss_name == "huber":
        return losses_mod.HuberLoss(delta)
    return losses_mod.get_regression_loss(loss_name, alpha=alpha_q, quantile=alpha_q)


def make_reg_round_core(base, loss_name, alpha_q, updates, optimized, tol,
                        max_iter):
    """One regressor round ``(ctx, X, bag_w, mask, pred, delta, y, w, lr) ->
    (params, weight, new_pred)``: the closed-form step for squared loss,
    Brent over [0, 100] for the others."""

    def round_core(ctx, X, bag_w, mask, pred, delta, y, w, lr):
        loss = _make_reg_loss(loss_name, alpha_q, delta)
        y_enc = loss.encode_label(y)
        labels, fit_w, bag_w = _pseudo_residuals_and_weights(
            loss, updates, y_enc, pred[:, None], bag_w, w
        )
        params, direction = base.fit_and_direction(
            ctx, labels[:, 0].contiguous(), fit_w[:, 0].contiguous(), mask, X
        )
        if optimized and loss_name == "squared":
            # phi(a) = sum bw*(res - a*dir)^2/2 is exactly quadratic: the
            # minimizer in closed form, clamped to Brent's [0, 100] bracket
            res = y - pred
            num = torch.sum(bag_w * direction * res)
            den = torch.sum(bag_w * direction * direction)
            alpha = torch.where(
                den > 1e-30,
                torch.clamp(num / torch.clamp(den, min=1e-30), 0.0, 100.0),
                torch.ones((), device=den.device),
            )
        elif optimized:
            def phi(a):
                return torch.sum(
                    bag_w * loss.loss(y_enc, (pred + a * direction)[:, None])
                )

            alpha = brent_minimize(phi, 0.0, 100.0, tol=tol,
                                   max_iter=max_iter).to(pred.device)
        else:
            alpha = torch.ones((), device=pred.device)
        weight = lr * alpha
        return params, weight, pred + weight * direction

    return round_core


def make_cls_round_core(base, loss, dim, updates, optimized, tol, max_iter):
    """One classifier round ``(ctx, X, y_enc, w, bag_w, mask, pred,
    alpha_ws, lr) -> (params, weight[dim], new_pred, alpha_carry)``."""

    def round_core(ctx, X, y_enc, w, bag_w, mask, pred, alpha_ws, lr):
        labels, fit_w, bag_w = _pseudo_residuals_and_weights(
            loss, updates, y_enc, pred, bag_w, w
        )
        params, directions = base.fit_many_and_directions(
            ctx, labels.contiguous(), fit_w.contiguous(), mask, X
        )
        if optimized:
            def phi(a):
                return torch.sum(
                    bag_w * loss.loss(y_enc, pred + a[None, :] * directions)
                )

            def gh(a):
                return loss.linesearch_grad_hess(
                    y_enc, pred + a[None, :] * directions, directions, bag_w
                )

            # warm start from the previous round's step sizes
            alpha = projected_newton_box(
                phi, alpha_ws, max_iter=min(max_iter, 25), tol=tol,
                grad_hess=gh,
            )
        else:
            alpha = torch.ones((dim,), dtype=torch.float32, device=pred.device)
        weight = lr * alpha
        new_pred = pred + weight[None, :] * directions
        alpha_carry = torch.where(torch.isfinite(alpha), alpha, torch.ones_like(alpha))
        return params, weight, new_pred, alpha_carry

    return round_core


class GBMRegressor(_GBMParams, Estimator):
    """Friedman GBM regressor."""

    loss = Param(
        "squared",
        in_array(
            ["squared", "absolute", "huber", "quantile", "logcosh", "scaledlogcosh"]
        ),
        doc="regression loss: squared|absolute|huber|quantile, and the "
        "logcosh and scaledlogcosh extensions",
    )
    alpha = Param(
        0.9, in_range(0.0, 1.0),
        doc="huber/quantile/scaledlogcosh shape parameter (the adaptive "
        "huber delta re-quantiles the residuals each round)",
    )
    init_strategy = Param(
        "constant", in_array(["constant", "zero", "base"]),
        doc="round-0 prediction: weighted target constant, zero, or a "
        "fitted copy of the base learner",
    )

    is_classifier = False

    def _fit_init(self, X, y, w, device):
        strategy = self.init_strategy.lower()
        if strategy == "base":
            return self._base().fit(X, y, sample_weight=w, device=device)
        name = self.loss.lower()
        if strategy == "zero":
            dummy = DummyRegressor(strategy="constant", constant=0.0)
        elif name in ("absolute", "huber"):
            dummy = DummyRegressor(strategy="median")
        elif name == "quantile":
            dummy = DummyRegressor(strategy="quantile", quantile=self.alpha)
        else:
            dummy = DummyRegressor(strategy="mean")
        return dummy.fit(X, y, sample_weight=w, device=device)

    def fit(self, X, y, sample_weight=None, validation_indicator=None,
            mesh=None, device="cuda"):
        self._check_gbm_support(mesh)
        loss_name = self.loss.lower()
        alpha_q = float(self.alpha)
        huber = loss_name == "huber"
        dev = resolve_device(device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w_all = resolve_weights(y, sample_weight)
        X, y, w, X_val, y_val = _split_validation(X, y, w_all, validation_indicator)
        n, d = X.shape
        base = self._base().copy()
        ctx = base.make_fit_ctx(X)
        init_model = self._fit_init(X, y, w, dev)
        # initial huber delta: the alpha-quantile of the label over the
        # full input, validation rows included
        delta = (weighted_quantile(torch.cat([y, y_val]) if y_val is not None else y,
                                   alpha_q)
                 if huber else torch.zeros((), device=dev))
        pred = init_model.predict(X).clone()
        sample = self._sampling_plan(n, d, dev)
        lr = float(self.learning_rate)
        round_core = make_reg_round_core(
            base, loss_name, alpha_q, self.updates.lower(),
            bool(self.optimized_weights), float(self.tol), int(self.max_iter),
        )
        with_validation = X_val is not None
        best = 0.0
        if with_validation:
            pred_val = init_model.predict(X_val).clone()
            y_val_enc = y_val[:, None]
            best = float(torch.mean(
                _make_reg_loss(loss_name, alpha_q, delta).loss(y_val_enc, pred_val[:, None])
            ))
        ones = torch.ones_like(y)
        deltas = []

        def run_round(i):
            nonlocal pred, pred_val, delta
            bag_w, mask = sample(i)
            if huber:
                delta = weighted_quantile(torch.abs(y - pred), alpha_q, weights=ones)
                deltas.append(delta)
            params, weight, pred = round_core(
                ctx, X, bag_w, mask, pred, delta, y, w, lr
            )
            err = None
            if with_validation:
                pred_val = pred_val + weight * base.predict_fn(params, X_val)
                err = torch.mean(
                    _make_reg_loss(loss_name, alpha_q, delta).loss(y_val_enc, pred_val[:, None])
                )
            return params, weight, err

        members, weights, i, v, val_history = self._drive_rounds(run_round, best)
        keep = i - v
        return GBMRegressionModel(
            params={
                "members": stack_trees(members[:keep]) if keep > 0 else None,
                "weights": (torch.stack(weights[:keep]) if keep > 0
                            else torch.zeros((0,), device=dev)),
                "init": init_model.params,
                "val_hist": (np.asarray(val_history, np.float32)
                             if with_validation else None),
                # each round's huber delta (every round run, kept or not)
                "huber_delta": torch.stack(deltas) if huber else None,
            },
            num_features=d,
            init_model=init_model,
            num_members=keep,
            device=dev,
            **self.get_params(),
        )


class GBMRegressionModel(RegressionModel, GBMRegressor):
    """predict = init + sum_i w_i * m_i(x)."""

    def __init__(self, init_model=None, num_members=0, **kwargs):
        super().__init__(**kwargs)
        self.init_model = init_model
        self.num_members = num_members

    def predict(self, X):
        X = self._input(X)
        out = self.init_model.predict(X)
        if self.num_members == 0:
            return out
        preds = self._base().predict_many_fn(self.params["members"], X)
        return out + torch.einsum("m,mn->n", self.params["weights"], preds)


class GBMClassifier(_GBMParams, Estimator):
    """Multiclass GBM: dim regressors per round (one fused forest fit),
    K-dim box-constrained line search, raw-score prediction state."""

    loss = Param(
        "logloss", in_array(["logloss", "exponential", "bernoulli"]),
        doc="K-class softmax cross-entropy, or the reference's binary "
        "exponential / bernoulli losses on (-f, f) raw scores",
    )
    init_strategy = Param(
        "prior", in_array(["prior", "uniform"]),
        doc="round-0 raw scores: class-prior log-odds or zeros",
    )

    is_classifier = True

    def _make_loss(self, num_classes):
        return losses_mod.get_classification_loss(self.loss.lower(), num_classes)

    def _init_raw_scores(self, X, y, w, num_classes, dim, device):
        """Init model + round-0 raw scores: log prior for logloss (dim ==
        num_classes); for the binary dim-1 losses the prior log-odds, or
        zero under 'uniform'."""
        init_model = DummyClassifier(strategy=self.init_strategy).fit(
            X, y, sample_weight=w, num_classes=num_classes, device=device
        )
        if dim == 1 and num_classes == 2 and self.init_strategy.lower() == "prior":
            # clamp both sides: a train split can hold no positives
            p1 = init_model.params["proba"][1]
            init_raw = torch.log(
                torch.clamp(p1, min=1e-30) / torch.clamp(1.0 - p1, min=1e-30)
            )[None]
        elif dim == 1:
            init_raw = torch.zeros((1,), dtype=torch.float32, device=device)
        else:
            init_raw = init_model.params["raw"]
        return init_model, init_raw

    def fit(self, X, y, sample_weight=None, validation_indicator=None,
            mesh=None, num_classes=None, device="cuda"):
        self._check_gbm_support(mesh)
        dev = resolve_device(device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w_all = resolve_weights(y, sample_weight)
        # over the FULL label set, so a validation split missing the top
        # class cannot shrink the model
        num_classes = infer_num_classes(y, num_classes)
        loss = self._make_loss(num_classes)
        dim = loss.dim
        X, y, w, X_val, y_val = _split_validation(X, y, w_all, validation_indicator)
        n, d = X.shape
        base = self._base().copy()
        ctx = base.make_fit_ctx(X)
        init_model, init_raw = self._init_raw_scores(X, y, w, num_classes, dim, dev)
        y_enc = loss.encode_label(y)
        pred = init_raw[None, :].expand(n, dim).clone()
        sample = self._sampling_plan(n, d, dev)
        alpha_ws = torch.ones((dim,), dtype=torch.float32, device=dev)
        lr = float(self.learning_rate)
        round_core = make_cls_round_core(
            base, loss, dim, self.updates.lower(), bool(self.optimized_weights),
            float(self.tol), int(self.max_iter),
        )
        with_validation = X_val is not None
        best = 0.0
        if with_validation:
            y_enc_val = loss.encode_label(y_val)
            pred_val = init_raw[None, :].expand(X_val.shape[0], dim).clone()
            best = float(torch.mean(loss.loss(y_enc_val, pred_val)))

        def run_round(i):
            nonlocal pred, pred_val, alpha_ws
            bag_w, mask = sample(i)
            params, weight, pred, alpha_ws = round_core(
                ctx, X, y_enc, w, bag_w, mask, pred, alpha_ws, lr
            )
            err = None
            if with_validation:
                dirs_val = base.predict_many_fn(params, X_val).T
                pred_val = pred_val + weight[None, :] * dirs_val
                err = torch.mean(loss.loss(y_enc_val, pred_val))
            return params, weight, err

        members, weights, i, v, val_history = self._drive_rounds(run_round, best)
        keep = i - v
        return GBMClassificationModel(
            params={
                "members": stack_trees(members[:keep]) if keep > 0 else None,
                "weights": (torch.stack(weights[:keep]) if keep > 0
                            else torch.zeros((0, dim), device=dev)),
                "init_raw": init_raw,
                "val_hist": (np.asarray(val_history, np.float32)
                             if with_validation else None),
            },
            num_features=d,
            num_classes=num_classes,
            num_members=keep,
            dim=dim,
            device=dev,
            **self.get_params(),
        )


class GBMClassificationModel(ClassificationModel, GBMClassifier):
    """raw = init_raw + sum_ij w_ij m_ij(x), and (-f, f) for the binary
    dim-1 losses; probabilities by the loss's raw -> probability mapping."""

    def __init__(self, num_members=0, dim=1, **kwargs):
        super().__init__(**kwargs)
        self.num_members = num_members
        self.dim = dim

    def _raw_state(self, X):
        out = self.params["init_raw"][None, :].expand(X.shape[0], self.dim)
        if self.num_members == 0:
            return out.clone()
        members, weights = self.params["members"], self.params["weights"]
        r, dim = weights.shape
        # the [round, class-dim] grid flattened: one forest predict covers
        # every tree
        flat = Tree(*(a.reshape((r * dim,) + a.shape[2:]) for a in members))
        preds = self._base().predict_many_fn(flat, X).reshape(r, dim, -1)
        return out + torch.einsum("md,mdn->nd", weights, preds)

    def predict_raw(self, X):
        f = self._raw_state(self._input(X))
        if self.dim == 1 and self.num_classes == 2:
            return torch.cat([-f, f], dim=1)
        return f

    def predict_proba(self, X):
        return self._make_loss(self.num_classes).raw2probability(self.predict_raw(X))

    def predict(self, X):
        return torch.argmax(self.predict_raw(X), dim=-1).to(torch.float32)
