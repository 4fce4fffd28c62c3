"""AdaBoost meta-estimators: SAMME / SAMME.R classification, Drucker R2
regression (PyTorch port of ``models/boosting.py``).

Each round normalizes the boosting weights, fits one base learner on them
(reading its same-row predictions off the fit's leaf ids), computes the
error and the estimator weight, and reweights the rows.  The JAX package
scans chunks of rounds on the device and replays the data-dependent aborts
on the host; the port runs one round at a time in a host loop, as its GBM
does, with the same kept-round semantics.

Formulas (the JAX package's, `BoostingClassifier.scala:198-260`,
`BoostingRegressor.scala:97-106,208-260`):

- SAMME ("discrete"): err = sum(w_norm * 1[miss]); beta =
  err / ((1-err)(K-1)); estimator weight log(1/beta) (1.0 if beta == 0);
  w <- w_norm * (1/beta)^miss; the round is aborted and dropped if
  err >= 1 - 1/K.
- SAMME.R ("real"): estimator weight 1.0; w <- w_norm *
  exp(-((K-1)/K) * sum_c code_c * log(max(p_c, EPS))), code_c = 1 for the
  true class else -1/(K-1), EPS = 2^-52.
- Drucker R2: err_i = |y_i - pred_i| / maxError; loss shaping
  exponential (1 - e^-e) | linear | squared; estErr = sum(w_norm * loss);
  the round is dropped and the fit stops at estErr >= 0.5, kept with
  weight 1.0 and the fit stops at maxError == 0; beta = estErr/(1-estErr);
  w <- w_norm * beta^(1-loss).
- Every flavor stops, keeping the round, once err <= 0 (classifiers), and
  before a round whose incoming weight mass is not positive.

Prediction: discrete raw = +weight for the member's class, -weight/(K-1)
elsewhere; real raw = sum over members of (K-1) * (log p - mean_c log p);
probability = softmax(raw / (K-1)); regression = the weighted median
(default) or weighted mean of the members' predictions.

Round keys ``fold_in(PRNGKey(seed), i)`` are derived as in the JAX package
and handed to nothing yet: the tree base learners draw nothing.
"""

from __future__ import annotations

import logging
import math

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
from spark_ensemble_tpu_torch.models.gbm import stack_members
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    check_tree_base,
)
from spark_ensemble_tpu_torch.params import Param, gt_eq, in_array
from spark_ensemble_tpu_torch.utils.quantile import weighted_median_rows
from spark_ensemble_tpu_torch.utils.random import PRNGKey, fold_in

logger = logging.getLogger(__name__)

EPSILON = 2.220446049250313e-16  # Spark MLUtils.EPSILON (double ulp of 1.0)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # a float32 constant, as jax takes a Python float against f32 arrays
    # (1e-300 becomes 0)
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _slice_members(members, m):
    return None if members is None else type(members)(*(a[:m] for a in members))


class _BoostingParams(Estimator):
    """Reference `BoostingParams.scala:26-37`."""

    base_learner = Param(
        None, is_estimator=True,
        doc="weak learner fitted per round on reweighted rows; defaults "
        "to a depth-5 histogram decision tree",
    )
    num_base_learners = Param(
        10, gt_eq(1),
        doc="maximum boosting rounds (fits may stop early on a round-0 "
        "abort, reference Boosting.scala semantics)",
    )
    scan_chunk = Param(
        16, gt_eq(1),
        doc="rounds per compiled dispatch in the JAX package; the port "
        "runs one round at a time, so it changes no result",
    )
    ramp = Param(
        "auto", in_array(["auto", "off"]),
        doc="the JAX package's chunk schedule for abort-prone flavors; the "
        "port's one-round loop has no chunks, so it changes no result",
    )
    checkpoint_interval = Param(
        10, gt_eq(1), doc="rounds between training-state checkpoints"
    )
    checkpoint_dir = Param(
        None, doc="training-state checkpoints; not ported yet (ROADMAP "
        "queue 1, item 16)",
    )
    aggregation_depth = Param(2, gt_eq(1), doc="API parity; reductions are sums")
    seed = Param(0, doc="PRNG seed of the round keys")

    def _prepare(self, X, y, sample_weight, mesh, device):
        self._check_port_support()
        if mesh is not None:
            not_supported("mesh", mesh, "queue 1, item 18")
        if self.checkpoint_dir is not None:
            not_supported("checkpoint_dir", self.checkpoint_dir, "queue 1, item 16")
        check_tree_base(self._base(), type(self).__name__)
        dev = resolve_device(device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        return dev, X, y, resolve_weights(y, sample_weight)

    def _drive(self, run_round, replay, bw, root):
        """The host round loop: ``run_round(bw, round_key) -> (params,
        est_weight, new_bw, stats)``, stats a dict of 0-d tensors, and
        ``replay(stats) -> (keep, stop)``, the flavor's stopping rules on
        their host floats.  ``round_key()`` derives round ``i``'s key
        ``fold_in(root, i)`` for a base learner that draws (the trees do
        not, so no round derives it).  Each round reads the device once:
        its stats, step size and non-finite flags in one tensor.  Returns
        the kept members and weights."""
        members, weights = [], []
        check = str(self.on_nonfinite).lower() == "raise"
        label = type(self).__name__
        i = 0
        stop = float(torch.sum(bw)) <= 0
        while i < self.num_base_learners and not stop:
            params, est_weight, new_bw, stats = run_round(
                bw, lambda i=i: fold_in(root, i))
            row = [*stats.values(), est_weight]
            if check:
                row += [torch.isnan(a).any().to(est_weight.dtype)
                        for a in params if a.is_floating_point()]
            host = torch.stack(row).tolist()
            stats = dict(zip(stats, host))
            if check and (
                any(host[len(stats) + 1:])
                or not all(map(math.isfinite, host[: len(stats) + 1]))
            ):
                raise FloatingPointError(
                    f"{label} round {i} produced non-finite member params or "
                    "step sizes (on_nonfinite='raise')"
                )
            keep, stop = replay(stats)
            logger.info("%s round %d: %s%s", label, i, stats,
                        "" if keep else " (dropped)")
            if not keep:
                break
            members.append(params)
            weights.append(est_weight)
            i += 1
            bw = new_bw
            # the loop guard of the next round: positive weight mass
            stop = stop or stats["sum_bw"] <= 0
        return members, weights

    def _model_params(self, members, weights, dev):
        return {
            "members": stack_members(members) if members else None,
            "weights": (torch.stack(weights) if weights
                        else torch.zeros((0,), dtype=torch.float32, device=dev)),
        }

    def fit_resume(self, *args, **kwargs):
        not_supported("fit_resume", "Boosting", "queue 1, item 16")


class BoostingClassifier(_BoostingParams):
    algorithm = Param(
        "discrete", in_array(["discrete", "real"]),
        doc="'discrete' = SAMME (class votes), 'real' = SAMME.R "
        "(probability-weighted log-odds votes)",
    )

    is_classifier = True

    def _base(self) -> BaseLearner:
        return self.base_learner or DecisionTreeClassifier()

    def fit(self, X, y, sample_weight=None, num_classes=None, mesh=None,
            device="cuda") -> "BoostingClassificationModel":
        dev, X, y, w = self._prepare(X, y, sample_weight, mesh, device)
        k = infer_num_classes(y, num_classes)
        base = self._base().copy()
        ctx = base.make_fit_ctx(X, k)
        real = self.algorithm.lower() == "real"
        y_int = y.to(torch.int64)
        codes = torch.where(
            torch.nn.functional.one_hot(y_int, k) > 0,
            _f32(1.0, y), _f32(-1.0 / (k - 1.0), y),
        )

        def run_round(bw, round_key):
            w_norm = bw / torch.clamp(torch.sum(bw), min=1e-30)
            if real:
                params, proba = base.fit_and_proba(ctx, y, w_norm, None, X)
                miss = (torch.argmax(proba, dim=-1) != y_int).to(torch.float32)
                err = torch.sum(w_norm * miss)
                ll = torch.sum(codes * torch.log(torch.clamp(proba, min=EPSILON)), dim=-1)
                new_bw = w_norm * torch.exp(-((k - 1.0) / k) * ll)
                est_weight = _f32(1.0, y)
            else:
                params, pred = base.fit_and_direction(ctx, y, w_norm, None, X)
                miss = (pred != y).to(torch.float32)
                err = torch.sum(w_norm * miss)
                beta = err / torch.clamp((1.0 - err) * (k - 1.0), min=1e-30)
                inv = 1.0 / torch.maximum(beta, _f32(1e-300, y))
                est_weight = torch.where(beta == 0.0, _f32(1.0, y), torch.log(inv))
                new_bw = w_norm * torch.pow(inv, miss)
            return params, est_weight, new_bw, {"err": err, "sum_bw": torch.sum(new_bw)}

        def replay(stats):
            if not real and stats["err"] >= 1.0 - 1.0 / k:
                return False, True  # abort the round, drop its model
            return True, stats["err"] <= 0

        members, weights = self._drive(run_round, replay, w, PRNGKey(self.seed, dev))
        return BoostingClassificationModel(
            params=self._model_params(members, weights, dev),
            num_features=X.shape[1], num_classes=k,
            num_members=len(members), device=dev, **self.get_params(),
        )


class BoostingClassificationModel(ClassificationModel, BoostingClassifier):
    def __init__(self, num_members=0, **kwargs):
        super().__init__(**kwargs)
        self.num_members = num_members

    def predict_raw(self, X):
        X = self._input(X)
        k = self.num_classes
        if self.num_members == 0:
            # reference predictRaw over zero models: a zero raw vector
            return torch.zeros((X.shape[0], k), dtype=torch.float32, device=X.device)
        base, members = self._base(), self.params["members"]
        if self.algorithm.lower() == "real":
            probas = base.predict_proba_many_fn(members, X)
            logp = torch.log(torch.clamp(probas, min=EPSILON))
            decisions = logp - torch.mean(logp, dim=-1, keepdim=True)
            return (k - 1.0) * torch.sum(decisions, dim=0)
        preds = base.predict_many_fn(members, X).to(torch.int64)
        onehot = torch.nn.functional.one_hot(preds, k)
        votes = torch.where(onehot > 0, _f32(1.0, X), _f32(-1.0 / (k - 1.0), X))
        return torch.einsum("m,mnk->nk", self.params["weights"], votes)

    def predict_proba(self, X):
        return torch.softmax(self.predict_raw(X) / (self.num_classes - 1.0), dim=-1)

    def predict(self, X):
        return torch.argmax(self.predict_raw(X), dim=-1).to(torch.float32)

    def take(self, m: int) -> "BoostingClassificationModel":
        """The model of the first ``m`` kept rounds."""
        m = min(m, self.num_members)
        return BoostingClassificationModel(
            params={"members": _slice_members(self.params["members"], m),
                    "weights": self.params["weights"][:m]},
            num_features=self.num_features, num_classes=self.num_classes,
            num_members=m, device=self.device, **self.get_params(),
        )


class BoostingRegressor(_BoostingParams):
    loss = Param(
        "exponential", in_array(["exponential", "linear", "squared"]),
        doc="Drucker R2 per-row loss shaping of the normalized errors",
    )
    voting_strategy = Param(
        "median", in_array(["median", "mean"]),
        doc="'median' = weighted median of member predictions (Drucker), "
        "'mean' = confidence-weighted mean",
    )

    is_classifier = False

    def _base(self) -> BaseLearner:
        return self.base_learner or DecisionTreeRegressor()

    @staticmethod
    def _replay(stats):
        """Drucker's stopping rules -> (keep the round, stop)."""
        if stats["max_err"] == 0.0:
            return True, True  # degenerate perfect fit: keep, stop
        if stats["est_err"] >= 0.5:
            return False, True  # drop the round and stop
        return True, False

    def fit(self, X, y, sample_weight=None, mesh=None,
            device="cuda") -> "BoostingRegressionModel":
        dev, X, y, w = self._prepare(X, y, sample_weight, mesh, device)
        base = self._base().copy()
        ctx = base.make_fit_ctx(X)
        loss_name = self.loss.lower()

        def shape_loss(e):
            if loss_name == "exponential":
                return 1.0 - torch.exp(-e)
            if loss_name == "squared":
                return e * e
            return e

        def run_round(bw, round_key):
            w_norm = bw / torch.clamp(torch.sum(bw), min=1e-30)
            params, pred = base.fit_and_direction(ctx, y, w_norm, None, X)
            errors = torch.abs(y - pred)
            max_error = torch.max(errors)
            rel = torch.where(
                max_error > 0, errors / torch.clamp(max_error, min=1e-30), errors
            )
            losses = shape_loss(rel)
            est_err = torch.sum(w_norm * losses)
            beta = est_err / torch.clamp(1.0 - est_err, min=1e-30)
            floor = torch.maximum(beta, _f32(1e-300, y))
            est_weight = torch.where(beta == 0.0, _f32(1.0, y), torch.log(1.0 / floor))
            new_bw = w_norm * torch.pow(floor, 1.0 - losses)
            new_bw = torch.where(beta == 0.0, torch.zeros_like(new_bw), new_bw)
            return params, est_weight, new_bw, {
                "max_err": max_error, "est_err": est_err, "sum_bw": torch.sum(new_bw),
            }

        members, weights = self._drive(run_round, self._replay, w,
                                       PRNGKey(self.seed, dev))
        return BoostingRegressionModel(
            params=self._model_params(members, weights, dev),
            num_features=X.shape[1], num_members=len(members), device=dev,
            **self.get_params(),
        )


class BoostingRegressionModel(RegressionModel, BoostingRegressor):
    def __init__(self, num_members=0, **kwargs):
        super().__init__(**kwargs)
        self.num_members = num_members

    def member_predictions(self, X):
        """Per-member predictions ``f32[m, n]``."""
        return self._base().predict_many_fn(self.params["members"], self._input(X))

    def predict(self, X):
        X = self._input(X)
        if self.num_members == 0:
            return torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
        preds = self.member_predictions(X)
        weights = self.params["weights"]
        if self.voting_strategy.lower() == "mean":
            return torch.einsum("m,mn->n", weights, preds) / torch.clamp(
                torch.sum(weights), min=1e-30
            )
        return weighted_median_rows(preds.T, weights)

    def take(self, m: int) -> "BoostingRegressionModel":
        """The model of the first ``m`` kept rounds."""
        m = min(m, self.num_members)
        return BoostingRegressionModel(
            params={"members": _slice_members(self.params["members"], m),
                    "weights": self.params["weights"][:m]},
            num_features=self.num_features, num_members=m, device=self.device,
            **self.get_params(),
        )
