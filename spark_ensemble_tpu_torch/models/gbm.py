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
those draws are all ones and all True, so the port skips them.

Gradient-based row sampling, with the JAX package's draws: round ``i``'s
key is its bag key ``fold_in(fold_in(PRNGKey(seed), i), 2)``.

- ``sampling="goss"|"mvs"`` ranks rows by their gradient norm on the
  device (``_sample_compact``, from ``fold_in(key, 11)``) and GATHERS the
  survivors into a buffer of a power-of-two ``bucket`` of rows, fixed at
  fit start (``_resolved_sampling``): the round's tree fit, hessian sum and
  line search run over the bucket, and only the prediction update routes
  all rows (``fit_gathered_and_direction``).
- the legacy ``sample_method="goss"`` keeps all rows and multiplies the
  bag weights by a GOSS mask (``_goss_multiplier``, from
  ``fold_in(key, 7)``).  Mixing the two raises ``ValueError``.

``leaf_model="linear"`` swaps a ``DecisionTreeRegressor`` base for a
``LinearTreeRegressor`` (``_base``).  The planes not ported yet
(checkpoints, telemetry, meshes) raise ``NotImplementedError``.
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
from spark_ensemble_tpu_torch.models.linear_tree import LinearTreeRegressor
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor, check_tree_base
from spark_ensemble_tpu_torch.ops import losses as losses_mod
from spark_ensemble_tpu_torch.ops.linesearch import brent_minimize, projected_newton_box
from spark_ensemble_tpu_torch.ops.tree import Tree
from spark_ensemble_tpu_torch.params import Param, Params, gt, gt_eq, in_array, in_range
from spark_ensemble_tpu_torch.utils.quantile import weighted_quantile
from spark_ensemble_tpu_torch.utils.random import (
    PRNGKey,
    bernoulli,
    bootstrap_weights,
    fold_in,
    subspace_mask,
    uniform,
)

logger = logging.getLogger(__name__)

# smallest compaction bucket of gradient row sampling (the JAX package's
# default ``sample_bucket_floor``; the port has no autotune)
_SAMPLE_BUCKET_FLOOR = 256


def stack_members(members: List):
    """Per-round member params (a Tree, or a linear-leaf dict around one)
    -> the same structure with a leading round axis."""
    first = members[0]
    if isinstance(first, dict):
        return {k: stack_members([m[k] for m in members]) for k in first}
    if isinstance(first, Tree):
        return Tree(*(torch.stack(fields) for fields in zip(*members)))
    return torch.stack(members)


def map_members(fn, params):
    """``fn`` applied to every tensor of member params (a Tree or a dict)."""
    if isinstance(params, dict):
        return {k: map_members(fn, v) for k, v in params.items()}
    if isinstance(params, Tree):
        return Tree(*(fn(a) for a in params))
    return fn(params)


def _fitted_values(params) -> List[torch.Tensor]:
    """The values a non-finite round poisons: leaf values, and the linear
    leaves' coefficients (thresholds hold +inf by design)."""
    if isinstance(params, dict):
        return [params["tree"].leaf_value, params["beta"]]
    return [params.leaf_value]


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
        doc="'goss' = gradient-based one-side sampling as a weight mask: "
        "each round keeps the top_rate fraction of rows by gradient "
        "magnitude plus an amplified other_rate sample of the rest, all "
        "rows still in the fit (composes with subsample_ratio)",
    )
    top_rate = Param(
        0.2, in_range(0.0, 1.0),
        doc="GOSS: fraction of rows kept by gradient magnitude",
    )
    other_rate = Param(
        0.1, in_range(0.0, 1.0, lower_inclusive=False),
        doc="GOSS: fraction of the FULL data sampled from the rest (kept "
        "rows amplified so the rest's gradient mass is unbiased)",
    )
    sampling = Param(
        "none", in_array(["none", "goss", "mvs"]),
        doc="gradient-based row sampling with row compaction: per round "
        "the rows are ranked on the device by gradient magnitude ('goss') "
        "or by minimal-variance keep probability ('mvs'), and the "
        "survivors are gathered into a power-of-two bucket of rows that "
        "the tree fit and line search run over.  'goss' keeps "
        "ceil(top_rate*n) rows by |grad| plus ceil(other_rate*n) uniform "
        "draws of the rest at weight (1-top_rate)/other_rate; 'mvs' keeps "
        "an expected (top_rate+other_rate)*n rows with probability "
        "min(1, sqrt(g^2+mvs_lambda)/mu).  Not with sample_method='goss'",
    )
    mvs_lambda = Param(0.1, gt_eq(0.0), doc="MVS regularizer")
    leaf_model = Param(
        "constant", in_array(["constant", "linear"]),
        doc="'linear' fits a ridge regression in every leaf: a "
        "DecisionTreeRegressor base becomes a LinearTreeRegressor with its "
        "params (models/linear_tree.py); another base raises ValueError",
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
        base = self.base_learner or DecisionTreeRegressor()
        if str(self.leaf_model).lower() == "linear":
            # here, not in fit: the fitted model's predict paths rebuild the
            # base from its params and must read the ridge-leaf params
            if type(base) is DecisionTreeRegressor:
                base = LinearTreeRegressor(**base.get_params())
            elif not isinstance(base, LinearTreeRegressor):
                raise ValueError(
                    "leaf_model='linear' needs a DecisionTreeRegressor "
                    f"base learner (got {type(base).__name__}); pass a "
                    "LinearTreeRegressor base directly to customize its "
                    "leaf params"
                )
        return base

    def _check_gbm_support(self, mesh):
        """Raise for every Param value this slice does not implement."""
        self._check_port_support()
        if mesh is not None:
            not_supported("mesh", mesh, "queue 1, item 18")
        check_tree_base(self._base(), type(self).__name__, linear_leaves=True)
        if self.checkpoint_dir is not None:
            not_supported("checkpoint_dir", self.checkpoint_dir, "queue 1, item 16")

    def _resolved_sampling(self, n: int):
        """The gradient row-sampling plan, fixed on the host at fit start,
        or None when ``sampling='none'``: the method, the counts ``k_top``
        and ``k_rand``, GOSS's amplifier, MVS's lambda and the pow2
        ``bucket`` of gathered rows.  The port has no autotune, so the
        rates are the Params."""
        method = str(self.sampling).lower()
        if method == "none":
            return None
        top, other = float(self.top_rate), float(self.other_rate)
        if method == "goss":
            k_top = int(np.ceil(top * n))
            k_rand = int(np.ceil(other * n))
            amp = max(1.0 - top, 0.0) / max(other, 1e-9)  # (1-a)/b
            lam = 0.0
        else:  # mvs: expected sample size (top_rate + other_rate) * n
            k_top = 0
            k_rand = int(np.ceil(min(top + other, 1.0) * n))
            amp = 0.0
            lam = float(self.mvs_lambda)
        return {
            "method": method,
            "bucket": _sample_pow2_bucket(n, k_top + k_rand, _SAMPLE_BUCKET_FLOOR),
            "samp": (k_top, k_rand, amp, lam),
            "sampled_rows": min(k_top + k_rand, n),
        }

    def _check_sampling_supported(self, plan) -> None:
        if plan is not None and str(self.sample_method).lower() == "goss":
            raise ValueError(
                "sampling != 'none' supersedes the legacy weight-mask "
                "sample_method='goss'; configure one of the two"
            )

    def _goss(self):
        """The legacy weight-mask GOSS rates, or None."""
        if str(self.sample_method).lower() != "goss":
            return None
        return float(self.top_rate), float(self.other_rate)

    def _member_keys(self, device):
        """Round ``i``'s key ``fold_in(PRNGKey(seed), i)``, for every round."""
        m = int(self.num_base_learners)
        return fold_in(PRNGKey(self.seed, device), torch.arange(m, device=device))

    def _sampling_keys(self, device, plan):
        """Every round's gradient-sampling key, hashed at fit start (no
        per-round copy to the device), folded from the round's bag key
        ``fold_in(member key, 2)``: ``fold_in(bag key, 11)`` for the
        compacted selection, ``fold_in(bag key, 7)`` for the legacy GOSS
        mask, as in the JAX package."""
        bag_keys = fold_in(self._member_keys(device), 2)
        return fold_in(bag_keys, 11 if plan is not None else 7)

    def _sampling_plan(self, n: int, d: int, device):
        """The per-round draws -> ``sample(i) -> (bag_w f32[n], mask
        bool[d] | None)``: the JAX package's ``_sampling_plan`` and
        ``_make_bag_many_fn``.  Draws that are all ones (all True) at the
        defaults are skipped."""
        repl, ratio = bool(self.replacement), float(self.subsample_ratio)
        sub_ratio = float(self.subspace_ratio)
        keys = self._member_keys(device)
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
            if check and not bool(torch.stack(
                [torch.isfinite(t).all() for t in [weight, *_fitted_values(params)]]
            ).all()):
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


def _goss_multiplier(neg_grad, w, bag_w, key, top_rate, other_rate):
    """The legacy GOSS weight mask ``f32[n]``: 1 on the rows whose gradient
    norm is in the top ``top_rate`` (the exact weighted quantile), and a
    Bernoulli keep of the rest at rate ``other_rate / (1 - top_rate)``
    weighted by its reciprocal, so the rest's gradient mass is unbiased."""
    score = torch.sqrt(torch.sum(neg_grad * neg_grad, dim=-1))
    thr = weighted_quantile(score, 1.0 - top_rate, w * bag_w)
    # the JAX package's f32 arithmetic on the rates
    f32 = np.float32
    p = np.minimum(f32(1.0), f32(other_rate) / np.maximum(f32(1.0 - top_rate), f32(1e-9)))
    keep = bernoulli(key, p, score.shape)
    return torch.where(score >= thr, 1.0, torch.where(keep, f32(1.0) / p, f32(0.0)))


def _sample_pow2_bucket(n: int, k_target: int, floor: int) -> int:
    """The compaction bucket: the next power of two at or above the
    expected survivor count (at least ``floor``), at most n."""
    target = max(1, min(int(k_target), int(n)), int(floor))
    m = 1
    while m < target:
        m *= 2
    return min(int(n), m)


def _sample_compact(method, score, alive, key, m, samp):
    """Survivor selection on the device -> ``(idx i64[m], mult f32[m])``:
    the rows gathered into the compacted buffer and their weights.
    ``samp = (k_top, k_rand, amp, lam)`` are host numbers fixed at fit
    start; ``key`` is the round's selection key; nothing here reads a
    value back to the host or copies one to the device.  Dead rows
    (``alive`` False) sort behind every candidate and can only land in the
    buffer at weight 0.

    GOSS: the ``k_top`` largest-score alive rows keep weight 1 (rank by a
    stable argsort, so tied scores go by row index), and ``k_rand`` uniform
    draws of the rest weigh ``amp``.  MVS: scores ``s = sqrt(score^2 +
    lam)``; ``mu`` solves ``sum(min(1, s/mu)) = k_rand`` by 30 bisection
    steps, rows with ``s >= mu`` are kept, the rest with probability
    ``s/mu`` at weight ``mu/s``; past ``m`` keeps the lowest-priority
    random ones drop."""
    k_top, k_rand, amp, lam = samp
    n = score.shape[0]
    dev = score.device
    u = uniform(key, (n,))
    if method == "goss":
        s = torch.where(alive, score, -torch.inf)
        order_s = torch.argsort(-s, stable=True)
        rank = torch.empty_like(order_s)
        rank[order_s] = torch.arange(n, device=dev)
        is_top = (rank < k_top) & alive
        # top rows first (by their uniform), then the rest by their
        # uniform, dead rows last
        pri = torch.where(is_top, 2.0 + u, torch.where(alive, u, -1.0))
        idx = torch.argsort(-pri, stable=True)[:m]
        n_top = torch.sum(is_top)
        pos = torch.arange(m, device=dev)
        mult = torch.where(
            pos < n_top, 1.0,
            torch.where((pos < n_top + k_rand) & alive[idx], np.float32(amp), 0.0),
        )
        return idx, mult.to(torch.float32)
    s = torch.where(alive, torch.sqrt(score * score + np.float32(lam)), 0.0)
    hi = torch.clamp(torch.max(s), min=1e-30)
    lo = hi * 1e-9
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        # the expected count falls as mu rises: too many keeps -> raise lo
        # (k_rand compares as f32, with no copy to the device)
        over = torch.sum(torch.clamp(s / mid, max=1.0)) >= float(k_rand)
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    mu = torch.clamp(0.5 * (lo + hi), min=1e-30)
    keep_det = alive & (s >= mu)
    keep_rand = alive & ~keep_det & (u * mu < s)
    pri = torch.where(keep_det, 2.0 + u, torch.where(keep_rand, u, -1.0))
    idx = torch.argsort(-pri, stable=True)[:m]
    pri_g = pri[idx]
    mult = torch.where(
        pri_g >= 2.0, 1.0,
        torch.where(pri_g >= 0.0, mu / torch.clamp(s[idx], min=1e-30), 0.0),
    )
    return idx, mult


def _pseudo_residuals_and_weights(loss, updates, y_enc, pred, bag_w, w,
                                  goss=None, goss_key=None):
    """Targets/weights for the round's base fit -> (labels[n, dim],
    fit_w[n, dim], bag_w); ``bag_w`` comes back multiplied by the legacy
    GOSS mask when ``goss=(top_rate, other_rate)``, so the line search
    sees the rows the trees fit."""
    neg_grad = loss.negative_gradient(y_enc, pred)
    if goss is not None:
        bag_w = bag_w * _goss_multiplier(neg_grad, w, bag_w, goss_key, *goss)
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


def _squared_step(bag_w, direction, res):
    """The closed-form step of squared loss: ``phi(a) = sum bw*(res -
    a*dir)^2/2`` is exactly quadratic; its minimizer, clamped to Brent's
    [0, 100] bracket (1.0 for a zero direction)."""
    num = torch.sum(bag_w * direction * res)
    den = torch.sum(bag_w * direction * direction)
    return torch.where(
        den > 1e-30,
        torch.clamp(num / torch.clamp(den, min=1e-30), 0.0, 100.0),
        torch.ones((), device=den.device),
    )


def make_reg_round_core(base, loss_name, alpha_q, updates, optimized, goss,
                        tol, max_iter, sampling=None):
    """One regressor round ``(ctx, X, bag_w, key, mask, pred, delta, y, w,
    lr) -> (params, weight, new_pred)``: the closed-form step for squared
    loss, Brent over [0, 100] for the others.  ``key`` is the round's
    sampling key (``_GBMParams._sampling_keys``), unused without sampling.  With a ``sampling`` plan
    (``_resolved_sampling``) the tree fit, the hessian sum and the step
    search run over the gathered survivors, and only the prediction update
    routes every row."""

    def step(loss, y_s, pred_s, bag_s, dir_s):
        if optimized and loss_name == "squared":
            return _squared_step(bag_s, dir_s, y_s - pred_s)
        if optimized:
            y_enc_s = loss.encode_label(y_s)

            def phi(a):
                return torch.sum(
                    bag_s * loss.loss(y_enc_s, (pred_s + a * dir_s)[:, None])
                )

            return brent_minimize(phi, 0.0, 100.0, tol=tol,
                                  max_iter=max_iter).to(pred_s.device)
        return torch.ones((), device=pred_s.device)

    def round_core(ctx, X, bag_w, key, mask, pred, delta, y, w, lr):
        loss = _make_reg_loss(loss_name, alpha_q, delta)
        y_enc = loss.encode_label(y)
        if sampling is None:
            labels, fit_w, bag_w = _pseudo_residuals_and_weights(
                loss, updates, y_enc, pred[:, None], bag_w, w, goss, key,
            )
            params, direction = base.fit_and_direction(
                ctx, labels[:, 0].contiguous(), fit_w[:, 0].contiguous(), mask, X
            )
            alpha = step(loss, y, pred, bag_w, direction)
        else:
            idx, mult = _sample_compact(
                sampling["method"], loss.sampling_scores(y_enc, pred[:, None]),
                (w * bag_w) > 0, key, sampling["bucket"], sampling["samp"],
            )
            # the survivors, their (1-a)/b amplification folded into the
            # bag weights so split gains and the newton sum stay unbiased
            y_s, w_s, pred_s = y[idx], w[idx], pred[idx]
            labels, fit_w, bag_s = _pseudo_residuals_and_weights(
                loss, updates, loss.encode_label(y_s), pred_s[:, None],
                bag_w[idx] * mult, w_s,
            )
            params, direction = base.fit_gathered_and_direction(
                base.ctx_gather_rows(ctx, idx), labels[:, 0].contiguous(),
                fit_w[:, 0].contiguous(), mask, X,
            )
            alpha = step(loss, y_s, pred_s, bag_s, direction[idx])
        weight = lr * alpha
        return params, weight, pred + weight * direction

    return round_core


def make_cls_round_core(base, loss, dim, updates, optimized, goss, tol,
                        max_iter, sampling=None):
    """One classifier round ``(ctx, X, y_enc, w, bag_w, key, mask, pred,
    alpha_ws, lr) -> (params, weight[dim], new_pred, alpha_carry)``.  With
    a ``sampling`` plan, rows rank by their gradient norm over the class
    dims, and every dim's tree fits on the same gathered buffer."""

    def step(y_enc_s, pred_s, bag_s, dirs_s, alpha_ws):
        if not optimized:
            return torch.ones((dim,), dtype=torch.float32, device=pred_s.device)

        def phi(a):
            return torch.sum(bag_s * loss.loss(y_enc_s, pred_s + a[None, :] * dirs_s))

        def gh(a):
            return loss.linesearch_grad_hess(
                y_enc_s, pred_s + a[None, :] * dirs_s, dirs_s, bag_s
            )

        # warm start from the previous round's step sizes
        return projected_newton_box(phi, alpha_ws, max_iter=min(max_iter, 25),
                                    tol=tol, grad_hess=gh)

    def round_core(ctx, X, y_enc, w, bag_w, key, mask, pred, alpha_ws, lr):
        if sampling is None:
            labels, fit_w, bag_w = _pseudo_residuals_and_weights(
                loss, updates, y_enc, pred, bag_w, w, goss, key,
            )
            params, directions = base.fit_many_and_directions(
                ctx, labels.contiguous(), fit_w.contiguous(), mask, X
            )
            alpha = step(y_enc, pred, bag_w, directions, alpha_ws)
        else:
            idx, mult = _sample_compact(
                sampling["method"], loss.sampling_scores(y_enc, pred),
                (w * bag_w) > 0, key, sampling["bucket"], sampling["samp"],
            )
            y_enc_s, pred_s = y_enc[idx], pred[idx]
            labels, fit_w, bag_s = _pseudo_residuals_and_weights(
                loss, updates, y_enc_s, pred_s, bag_w[idx] * mult, w[idx]
            )
            params, directions = base.fit_gathered_many_and_directions(
                base.ctx_gather_rows(ctx, idx), labels.contiguous(),
                fit_w.contiguous(), mask, X,
            )
            alpha = step(y_enc_s, pred_s, bag_s, directions[idx], alpha_ws)
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
        plan = self._resolved_sampling(n)
        self._check_sampling_supported(plan)
        keys = self._sampling_keys(dev, plan)
        round_core = make_reg_round_core(
            base, loss_name, alpha_q, self.updates.lower(),
            bool(self.optimized_weights), self._goss(), float(self.tol),
            int(self.max_iter), plan,
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
                ctx, X, bag_w, keys[i], mask, pred, delta, y, w, lr
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
                "members": stack_members(members[:keep]) if keep > 0 else None,
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
        plan = self._resolved_sampling(n)
        self._check_sampling_supported(plan)
        keys = self._sampling_keys(dev, plan)
        round_core = make_cls_round_core(
            base, loss, dim, self.updates.lower(), bool(self.optimized_weights),
            self._goss(), float(self.tol), int(self.max_iter), plan,
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
                ctx, X, y_enc, w, bag_w, keys[i], mask, pred, alpha_ws, lr
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
                "members": stack_members(members[:keep]) if keep > 0 else None,
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
        flat = map_members(lambda a: a.reshape((r * dim,) + a.shape[2:]), members)
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
