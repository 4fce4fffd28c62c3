"""Bagging meta-estimators, SubBag: bootstrap rows plus random feature
subspaces (PyTorch port of ``models/bagging.py``).

All members train in ONE ``fit_many_from_ctx`` call over a shared fit
context, each with its own bag weights, feature mask and key (tree members
in one forest fit; other learners loop over the members or batch them).  The
plan is the JAX package's, draw for draw (``utils/random.py``): member
``i``'s key is ``fold_in(PRNGKey(seed), i)``, its bag weights come from
``fold_in(key, 0)`` (Poisson counts with replacement, a Bernoulli mask
without; Spark's ``RDD.sample``) and its feature mask from
``fold_in(key, 1)`` (`HasSubBag.scala:69-79`); the member's fit gets
``key`` itself.

Voting (`BaggingClassifier.scala:260-287`): hard = summed one-hot votes of
the members' classes, soft = summed member probabilities; probability =
raw / members; prediction = the first argmax of raw, as ``jnp.argmax``
takes it (hard votes tie often).  The regressor predicts the members'
unweighted mean (`BaggingRegressor.scala:221-228`).

The one fused member fit runs under the retry layer, and the numeric
guard (``on_nonfinite``) drops members with NaN params, so ``num_members``
is the kept count and probabilities divide by it.  With telemetry the one
fused fit is one round chunk of ``num_base_learners`` rounds, each charged
an equal share of its fenced wall time.

``fit(X, y, mesh=...)`` places rows and members on the mesh's two axes at
once, as the JAX package's ``_shard_rows_and_members``: each rank keeps its
block of the rows (the reference's partitions on executors) and fits its
block of the members (the driver's thread pool) in one forest fit whose
statistics are reduced over the row axis; the member blocks are gathered
over "member" (phantom members of zero weight round the count up to a
multiple of its size, and are trimmed).  A mesh without a "member" axis
fits every member on every rank.  Every rank returns the same model.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    ClassificationModel,
    Estimator,
    RegressionModel,
    _with_guard_events,
    as_f32,
    infer_num_classes,
    make_shared_fit_ctx,
    mesh_device,
    predict_program,
    program_call,
    resolve_device,
    resolve_weights,
    tree_map,
)
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)
from spark_ensemble_tpu_torch.ops.collective import pairwise_sum, pgather
from spark_ensemble_tpu_torch.params import Param, gt_eq, in_array, in_range
from spark_ensemble_tpu_torch.telemetry.events import FitTelemetry
from spark_ensemble_tpu_torch.utils.instrumentation import instrumented_fit
from spark_ensemble_tpu_torch.utils.random import (
    PRNGKey,
    bootstrap_weights,
    fold_in,
    subspace_mask,
)


class _BaggingParams(Estimator):
    """Reference `BaggingParams.scala:27-37` + `HasSubBag.scala:69-71`."""

    base_learner = Param(
        None, is_estimator=True,
        doc="learner template copied per member; defaults to a depth-5 "
        "histogram decision tree",
    )
    num_base_learners = Param(10, gt_eq(1), doc="ensemble size")
    replacement = Param(
        True,
        doc="bootstrap with replacement (Poisson sample weights) vs "
        "without (Bernoulli); reference SubBag semantics",
    )
    subsample_ratio = Param(
        1.0, in_range(0.0, 1.0, lower_inclusive=False),
        doc="per-member row sample ratio (enters as weights, not subsets)",
    )
    subspace_ratio = Param(
        1.0, in_range(0.0, 1.0, lower_inclusive=False),
        doc="per-member feature-subspace ratio (random subspaces)",
    )
    parallelism = Param(1, gt_eq(1), doc="API parity; members fit as one forest")
    seed = Param(0, doc="PRNG seed for member sampling plans")

    def _member_plan(self, n: int, d: int, w: torch.Tensor):
        """Stacked per-member ``(fit weights f32[m, n], masks bool[m, d],
        keys int64[m, 2])``, drawn on ``w``'s device."""
        m = int(self.num_base_learners)
        root = PRNGKey(self.seed, device=w.device)
        keys = fold_in(root, torch.arange(m, device=w.device))
        bag = bootstrap_weights(fold_in(keys, 0), n, bool(self.replacement),
                                float(self.subsample_ratio))
        masks = subspace_mask(fold_in(keys, 1), d, float(self.subspace_ratio))
        return bag * w[None, :], masks, keys

    def _fit_members(self, X, y, sample_weight, num_classes, mesh, device):
        """Validate, draw the plan and fit every member in one
        ``fit_many_from_ctx`` under the robustness runtime (a chaos
        transient site and the retry layer around the one fused fit, then
        the guard's drop of non-finite members) -> ``(members, masks,
        num_classes, d, device, guard, telem)``."""
        from spark_ensemble_tpu_torch.robustness.chaos import controller
        from spark_ensemble_tpu_torch.robustness.retry import retry_call

        dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w = resolve_weights(y, sample_weight)
        if self.is_classifier:
            num_classes = infer_num_classes(y, num_classes)
        n, d = X.shape
        base = self._base().copy()
        ctx = make_shared_fit_ctx(base, X, num_classes)
        fit_w, masks, keys = self._member_plan(n, d, w)
        m = fit_w.shape[0]
        meta = {} if num_classes is None else {"num_classes": int(num_classes)}
        telem = FitTelemetry.start(self, n=n, d=d, mesh=mesh, **meta)
        ax = member_axis = None
        fit_masks, fit_keys = masks, keys
        if mesh is not None:
            ctx, y, fit_w, fit_masks, fit_keys = self._shard_rows_and_members(
                mesh, base, ctx, y, fit_w, masks, keys)
            ax, n = mesh.row_axis, y.shape[0]
            if mesh.member_axis is not None and mesh.member_axis.size > 1:
                member_axis = mesh.member_axis
        telem.phase_mark("setup")
        t_fit = time.perf_counter()
        ctl = controller()
        site = f"{type(self).__name__}:fit_all"

        # the one forest fit is one call of the JAX package's fit program
        tag = "bagging_fit_cls" if self.is_classifier else "bagging_fit"
        call = None

        def attempt():
            nonlocal call
            ctl.transient(site)
            with program_call(tag, y, fit_w, self) as call:
                out = base.fit_many_from_ctx(
                    ctx, y[:, None].expand(n, fit_w.shape[0]), fit_w.T.contiguous(),
                    fit_masks, keys=fit_keys, axis_name=ax,
                )
            if member_axis is None:
                return out
            return tree_map(lambda a: pgather(a, member_axis, 0)[:m], out)

        members = retry_call(attempt, self._retry_policy(),
                             op=f"{type(self).__name__}.fit_all", telem=telem)
        if telem.enabled:
            # every member fits in ONE forest fit: all m "rounds" share
            # its fenced wall time evenly
            telem.round_chunk(0, m, t_fit, fence=members, program=call)
        members = ctl.poison_member_stack(site, members)
        guard = self._numeric_guard(telem)
        members, masks = self._drop_bad_members(members, masks, guard)
        return members, masks, num_classes, d, dev, guard, telem

    @staticmethod
    def _shard_rows_and_members(mesh, base, ctx, y, fit_w, masks, keys):
        """This rank's rows and member block -> ``(ctx, y, fit_w [blk, rows],
        masks [blk, d], keys [blk, 2])``: the members padded to a multiple
        of the "member" axis by zero-weight phantoms (all features on, zero
        keys), rows padded with zero-weight rows."""
        from spark_ensemble_tpu_torch.parallel.mesh import shard_ctx_rows, shard_rows

        n, m = y.shape[0], fit_w.shape[0]
        member_axis = mesh.member_axis
        size = 1 if member_axis is None else member_axis.size
        m_pad = m + (-m) % size
        if m_pad != m:
            fit_w = torch.cat([fit_w, fit_w.new_zeros((m_pad - m, n))])
            masks = torch.cat([masks, masks.new_ones((m_pad - m, masks.shape[1]))])
            keys = torch.cat([keys, keys.new_zeros((m_pad - m, keys.shape[1]))])
        blk = m_pad // size
        lo = 0 if member_axis is None else member_axis.index * blk
        return (shard_ctx_rows(mesh, base, ctx, n), shard_rows(mesh, y, n),
                shard_rows(mesh, fit_w[lo:lo + blk], n, dim=1),
                masks[lo:lo + blk], keys[lo:lo + blk])

    @staticmethod
    def _drop_bad_members(members, masks, guard):
        """``on_nonfinite`` over the fitted member stack: members whose
        params picked up NaN are dropped outright (Bagging averages its
        members with equal weight, so no weight can neutralize one).
        ``stop_early`` keeps the members before the first bad one;
        ``skip_round`` and ``halve_step`` (no step to halve in one fused
        fit) keep every finite member.  Probabilities then divide by the
        kept count (``num_members``)."""
        if not guard.active:
            return members, masks
        flags = guard.member_flags(members)
        if flags is None or not flags.any():
            return members, masks
        first = int(np.flatnonzero(flags)[0])
        if guard.policy == "raise":
            guard.raise_error(first, what="member params", unit="member")
        if guard.policy == "stop_early":
            keep, action = np.arange(first), "stop_early"
        else:
            keep, action = np.flatnonzero(~flags), "skip_round"
        if keep.size == 0:
            # a usable Bagging model needs at least one finite member
            guard.raise_error(first, what="every member's params", unit="member")
        guard.record(first, action, members_dropped=int(flags.size - keep.size),
                     members_kept=int(keep.size))
        idx = torch.as_tensor(keep, device=masks.device)
        return tree_map(lambda a: a[idx], members), masks[idx]


class BaggingRegressor(_BaggingParams):
    is_classifier = False

    def _base(self) -> BaseLearner:
        return self.base_learner or DecisionTreeRegressor()

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, mesh=None,
            device="cuda") -> "BaggingRegressionModel":
        members, masks, _, d, dev, guard, telem = self._fit_members(
            X, y, sample_weight, None, mesh, device
        )
        model = _with_guard_events(guard, BaggingRegressionModel(
            params={"members": members, "masks": masks},
            num_features=d, num_members=masks.shape[0], device=dev,
            **self.get_params(),
        ))
        telem.finish(model=model, members=model.num_members)
        return model


class BaggingRegressionModel(RegressionModel, BaggingRegressor):
    def __init__(self, num_members=None, **kwargs):
        super().__init__(**kwargs)
        self.num_members = (int(num_members) if num_members is not None
                            else int(self.num_base_learners))

    def member_predictions(self, X):
        """Per-member predictions ``f32[m, n]``."""
        return self._base().predict_many_fn(self.params["members"], self._input(X))

    @predict_program("members")
    def predict(self, X):
        # members summed by the fixed pairwise tree (batch-independent)
        preds = self.member_predictions(X)
        return pairwise_sum(preds) / preds.shape[0]


class BaggingClassifier(_BaggingParams):
    voting_strategy = Param(
        "hard", in_array(["hard", "soft"]),
        doc="'hard' majority-votes member classes; 'soft' averages "
        "member probabilities",
    )

    is_classifier = True

    def _base(self) -> BaseLearner:
        return self.base_learner or DecisionTreeClassifier()

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, mesh=None, num_classes=None,
            device="cuda") -> "BaggingClassificationModel":
        members, masks, num_classes, d, dev, guard, telem = self._fit_members(
            X, y, sample_weight, num_classes, mesh, device
        )
        model = _with_guard_events(guard, BaggingClassificationModel(
            params={"members": members, "masks": masks},
            num_features=d, num_classes=num_classes,
            num_members=masks.shape[0], device=dev, **self.get_params(),
        ))
        telem.finish(model=model, members=model.num_members)
        return model


class BaggingClassificationModel(ClassificationModel, BaggingClassifier):
    def __init__(self, num_members=None, **kwargs):
        super().__init__(**kwargs)
        self.num_members = (int(num_members) if num_members is not None
                            else int(self.num_base_learners))

    def member_class_predictions(self, X):
        """Per-member class predictions ``f32[m, n]``."""
        return self._base().predict_many_fn(self.params["members"], self._input(X))

    @predict_program("member_preds")
    def predict_raw(self, X):
        base, Xq = self._base(), self._input(X)
        if self.voting_strategy.lower() == "soft":
            return pairwise_sum(base.predict_proba_many_fn(self.params["members"], Xq))
        votes = base.predict_many_fn(self.params["members"], Xq).to(torch.int64)
        return pairwise_sum(
            torch.nn.functional.one_hot(votes, self.num_classes).to(torch.float32)
        )

    def predict_proba(self, X):
        # raw2probabilityInPlace scales by 1/numModels
        # (`BaggingClassifier.scala:285-287`)
        return self.predict_raw(X) / self.num_members

    def predict(self, X):
        return torch.argmax(self.predict_raw(X), dim=-1).to(torch.float32)
