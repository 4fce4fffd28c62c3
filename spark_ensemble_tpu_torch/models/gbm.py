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

The round loop is the JAX package's ``_drive_rounds`` on the port's
``RoundExecutor`` (``execution.py``): chunks of ``scan_chunk`` rounds
(clamped to checkpoint boundaries) run one round after another, and the
host commits a chunk at once, reading its finite flags and validation
losses in one transfer, stepping the patience recurrence
(``_patience_step``) and saving a checkpoint on save rounds.  At pipeline
depth 1 (the default, ``SE_TPU_PIPELINE``) the next chunk's launches are
enqueued before that read.  ``checkpoint_dir`` resumes a fit after a
preemption, ``fit_resume`` continues a fitted model, and ``on_nonfinite``
recovers from a poisoned round (skip, halve the step, or stop early).

Uniform sampling (``subsample_ratio``, ``replacement``, ``subspace_ratio``)
draws the JAX package's plan bit for bit (``utils/random.py``): member
``i``'s key is ``fold_in(PRNGKey(seed), i)``, its bag weights come from
``fold_in(key, 2)`` and its feature mask from ``fold_in(key, 1)``.  At the
defaults (``subsample_ratio=1.0`` without replacement, ``subspace_ratio=1.0``)
those draws are all ones and all True, so the port skips them.  The base
learner gets the round's bag key ``fold_in(key, 2)``, one key for all of a
classifier's class dims, as in the JAX package; any base learner fits
(trees fuse the class dims into one forest, the others loop or batch).

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
``LinearTreeRegressor`` (``_base``).

``fit_streaming`` trains over an on-disk shard store
(``data/streaming.py``): the same round loop (``_fit_rounds``) with the
shard sweep in place of the base tree.

``fit(X, y, mesh=...)`` runs the JAX package's SPMD fit, one process per
device (``parallel/mesh.py``): every rank passes the same global arrays,
keeps its block of the rows (zero-weight padding included) and reduces
every row sum across the mesh's row axis: the hessian sums, the tree
statistics, the step searches' objectives, the validation losses and
huber's quantile (the sharded walk of ``utils/quantile.py``).  The draws
over all rows come out whole on every rank and each keeps its block.  The
classifier's class dims split into equal blocks over a "member" axis
(zero-weight phantom dims round them up): a rank fits its block, and the
params and directions are gathered over "member" and trimmed before the
step search.  Every rank takes the same decisions on the same reduced
values and returns the same model.  Checkpoints under a mesh hold the
global padded carry (``parallel/mesh.CheckpointBlocks``), and
``fit_streaming(mesh=...)`` distributes the shard sweeps
(``parallel/elastic.py``).

Telemetry follows the JAX package's call sites: ``fit_start`` (with a
``sampling_config`` event for a sampled fit), the ``setup`` / ``probe`` /
``rounds`` / ``finalize`` phase marks, one ``round_chunk`` per committed
chunk with its validation losses, step sizes and ``round_cost``, the
opt-in classifier ``phase_probe`` (``SE_TPU_TELEMETRY_PHASES``), and
``finish`` attaching ``fit_history_``.  Every fit, telemetry on or off,
captures its training-time drift reference ``drift_ref_``
(``telemetry/quality.drift_reference_from_ctx``), which ``pack`` ships as
the ``quality`` sidecar.
"""

from __future__ import annotations

import logging
import time
from typing import List

import numpy as np
import torch

from spark_ensemble_tpu_torch import execution as _execution
from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    CheckpointableParams,
    ClassificationModel,
    Estimator,
    RegressionModel,
    _with_guard_events,
    as_f32,
    infer_num_classes,
    make_shared_fit_ctx,
    mesh_device,
    mesh_fit_kwargs,
    predict_program,
    program_call,
    resolve_device,
    resolve_weights,
    stack_members,
    tree_leaves,
    tree_map,
)
from spark_ensemble_tpu_torch.models.dummy import DummyClassifier, DummyRegressor
from spark_ensemble_tpu_torch.models.linear_tree import LinearTreeRegressor
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor
from spark_ensemble_tpu_torch.ops import losses as losses_mod
from spark_ensemble_tpu_torch.ops.collective import pairwise_sum, pgather, preduce
from spark_ensemble_tpu_torch.ops.linesearch import brent_minimize, projected_newton_box_lanes
from spark_ensemble_tpu_torch.ops.tree import Tree
from spark_ensemble_tpu_torch.parallel.mesh import (
    CheckpointBlocks,
    setup_row_sharding,
    shard_rows,
)
from spark_ensemble_tpu_torch.params import Param, gt, gt_eq, in_array, in_range
from spark_ensemble_tpu_torch.telemetry.events import FitTelemetry
from spark_ensemble_tpu_torch.telemetry.quality import drift_reference_from_ctx
from spark_ensemble_tpu_torch.utils.instrumentation import (
    Instrumentation,
    instrumented_fit,
)
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


def _round_cost(base, n: int, d: int, members: int, device, sample_plan=None):
    """Static per-round cost model for the telemetry round events
    (``ops/tree.round_cost_est``): resolved histogram tier, packed-lane
    width, memory bytes and flops per round.  ``members`` is the number of
    trees a round fits (1 for the regressor, the class dims for the
    classifier).  None when the base learner is not a histogram tree."""
    try:
        from spark_ensemble_tpu_torch.ops.tree import round_cost_est

        out = round_cost_est(
            n=int(n), d=int(d), k=1, M=int(members),
            max_depth=int(base.max_depth), max_bins=int(base.max_bins),
            hist=str(getattr(base, "hist", "auto")),
            hist_precision=str(getattr(base, "hist_precision", "highest")),
            sampled_rows=int(sample_plan["bucket"]) if sample_plan else None,
            device=device,
        )
        if sample_plan is not None:
            out["sampled_rows"] = int(sample_plan["sampled_rows"])
            out["sample_bucket"] = int(sample_plan["bucket"])
        return out
    except (AttributeError, TypeError, ValueError):
        return None


def _emit_sampling_config(telem, plan) -> None:
    if plan is not None:
        telem.emit(
            "sampling_config",
            method=plan["method"],
            top_rate=plan["top_rate"],
            other_rate=plan["other_rate"],
            mvs_lambda=plan["mvs_lambda"],
            sampled_rows=plan["sampled_rows"],
            sample_bucket=plan["bucket"],
            amp=plan["amp"],
        )


def _sampling_span_fields(plan):
    if plan is None:
        return None
    return {"sampling": plan["method"], "sample_bucket": plan["bucket"]}


def _fitted_values(params) -> List[torch.Tensor]:
    """The values a non-finite round poisons: a tree's leaf values, a
    linear-leaf tree's coefficients too (thresholds hold +inf by design),
    and every float tensor of any other learner's params."""
    if isinstance(params, Tree):
        return [params.leaf_value]
    if isinstance(params, dict) and isinstance(params.get("tree"), Tree):
        return [params["tree"].leaf_value, params["beta"]]
    return [a for a in tree_leaves(params) if a.is_floating_point()]


class _GBMParams(CheckpointableParams):
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
        doc="rounds per chunk: the host commits a chunk at once (one read of "
        "its finite flags and validation losses); a validation stop inside "
        "a chunk drops its later rounds, so no result depends on it",
    )
    checkpoint_interval = Param(
        10, gt_eq(1), doc="rounds between training-state checkpoints"
    )
    checkpoint_dir = Param(
        None,
        doc="when set, training state (round, members, predictions, "
        "patience) is checkpointed every checkpoint_interval rounds and "
        "fit() resumes from the latest checkpoint",
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

    def _check_streaming_supported(self) -> None:
        """``fit_streaming``'s gates: what the shard sweep cannot stage (the
        compacted row gather and the linear-leaf solves both read the
        resident rows)."""
        if str(self.sampling).lower() != "none":
            raise ValueError(
                "fit_streaming does not support gradient-based row "
                "sampling (sampling != 'none'): the compacted gather "
                "needs the resident row matrix"
            )
        if str(self.leaf_model).lower() == "linear":
            raise ValueError(
                "fit_streaming does not support leaf_model='linear': the "
                "leaf ridge solve reads raw rows the shard stream does "
                "not stage"
            )

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
            "top_rate": top,
            "other_rate": other,
            "mvs_lambda": lam,
            "amp": amp,
        }

    def _check_sampling_supported(self, plan, mesh=None) -> None:
        if plan is None:
            return
        if mesh is not None:
            raise ValueError(
                "sampling != 'none' is single-device only for now: the "
                "compacted row gather has no shard_map story yet (rows "
                "would need a cross-shard gather); drop mesh= or set "
                "sampling='none'"
            )
        if str(self.sample_method).lower() == "goss":
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

    def _round_keys(self, device, plan):
        """Every round's keys, hashed at fit start (no per-round copy to
        the device): the bag key ``fold_in(member key, 2)``, which the base
        learner gets, and the gradient-sampling key folded from it,
        ``fold_in(bag key, 11)`` for the compacted selection and
        ``fold_in(bag key, 7)`` for the legacy GOSS mask, as in the JAX
        package -> ``(bag_keys [m, 2], sampling_keys [m, 2])``."""
        bag_keys = fold_in(self._member_keys(device), 2)
        return bag_keys, fold_in(bag_keys, 11 if plan is not None else 7)

    def _subspace_masks(self, d: int, device):
        """Every round's feature mask ``bool[m, d]`` from ``fold_in(member
        key, 1)``, or None at ``subspace_ratio=1.0`` (all True)."""
        ratio = float(self.subspace_ratio)
        if ratio >= 1.0:
            return None
        return subspace_mask(fold_in(self._member_keys(device), 1), d, ratio)

    def _model_masks(self, d: int, device):
        """The feature masks a model keeps (``member_feature_names``)."""
        masks = self._subspace_masks(d, device)
        if masks is None:
            masks = torch.ones((int(self.num_base_learners), d), dtype=torch.bool,
                               device=device)
        return masks

    def _sampling_plan(self, n: int, d: int, device):
        """The per-round draws -> ``sample(i) -> (bag_w f32[n], mask
        bool[d] | None)``: the JAX package's ``_sampling_plan`` and
        ``_make_bag_many_fn``.  Draws that are all ones (all True) at the
        defaults are skipped."""
        repl, ratio = bool(self.replacement), float(self.subsample_ratio)
        bag_keys = fold_in(self._member_keys(device), 2)
        masks = self._subspace_masks(d, device)
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

    def _drive_rounds(self, ckpt, chunks, run_chunk, save_state, label, i, v,
                      best, val_history, guard, snapshot, restore, telem,
                      round_cost=None, span_fields=None, program_args=()):
        """The shared round loop of both GBM flavors, behind the
        port's :class:`RoundExecutor` (the JAX package's ``_drive_rounds``
        and its ``_Adapter``).

        ``run_chunk(sl, step_scale) -> (params [c, ...], weights [c, ...],
        errs f32[c] | None, aux [c] | None)`` runs rounds ``sl`` from the
        carry and advances it (through its closure); ``snapshot()`` /
        ``restore(snap)`` copy and rewind the carry.  ``chunks`` holds the
        committed round-stacked ``members``, ``weights`` and ``aux`` lists.
        A chunk is ``scan_chunk`` rounds, clamped to the next checkpoint
        boundary.  Committing a chunk reads its finite flags and validation
        losses in one host transfer, steps the patience recurrence, and
        saves a checkpoint on a save round.

        Robustness: each chunk runs under the retry layer (a transient
        ``RuntimeError`` re-runs the same chunk from the same carry), and
        when the guard flags a round the carry rewinds to the chunk start,
        the clean prefix replays (same absolute rounds, same keys, same
        results), and the poisoned round is raised, skipped, re-run at a
        halved step or truncated per ``on_nonfinite``.  Returns ``(i, v,
        best)``; the caller keeps ``i - v`` rounds.

        Telemetry: each committed chunk's wait is charged to
        ``host_blocked_us``, and its rounds become ``round_start`` /
        ``round_end`` events (``telem.round_chunk``) with the chunk's
        validation losses, step sizes and ``round_cost``; the executor
        traces the chunks as spans.

        Each chunk is one call of the program ``gbm_cls_round`` /
        ``gbm_reg_round`` over ``program_args`` and its round count
        (``models/base.program_call``); a committed chunk's call joins its
        ``round_end`` events (``round_chunk(program=...)``)."""
        from spark_ensemble_tpu_torch.robustness.chaos import controller
        from spark_ensemble_tpu_torch.robustness.retry import retry_call

        tag = "gbm_cls_round" if self.is_classifier else "gbm_reg_round"
        programs = {}  # chunk start -> its program call, until committed
        chunk = int(self.scan_chunk)
        retry_policy = self._retry_policy()
        ctl = controller()
        refresh_fit = self._is_refresh_fit
        guard_on = guard.active
        depth = _execution.resolve_pipeline_depth()
        dp_on = _execution.device_patience_enabled()
        drv = self

        def dispatch(sl, step_scale=1.0):
            site = f"{label}:round:{sl.start}"

            def attempt():
                ctl.transient(site)
                with program_call(tag, *program_args, sl.stop - sl.start) as call:
                    out = run_chunk(sl, step_scale)
                programs[sl.start] = call
                return out

            params_c, weights_c, errs, aux = retry_call(
                attempt, retry_policy, op=f"{label}.round_chunk", telem=telem
            )
            return params_c, ctl.poison_array(site, weights_c), errs, aux

        def read(params_c, weights_c, errs):
            """One host read of a chunk -> (first bad round | None, errs as
            host floats | None)."""
            parts = []
            if guard_on:
                parts.append(guard.flags(params_c, weights_c, errs).to(torch.float32))
            if errs is not None and not dp_on:
                parts.append(errs.to(torch.float32))
            host = torch.cat(parts).tolist() if parts else []
            bad = None
            if guard_on:
                c = weights_c.shape[0]
                flags, host = host[:c], host[c:]
                bad = next((j for j, f in enumerate(flags) if f), None)
            return bad, (host if errs is not None and not dp_on else None)

        def process(i, c, params_c, weights_c, errs, errs_host, aux, v, best,
                    t_chunk):
            """One clean chunk's bookkeeping -> (i, v, best, stopped)."""
            if telem.enabled:
                telem.round_chunk(
                    i, c, t_chunk, fence=(params_c, weights_c, errs),
                    losses=errs_host if errs_host is not None else errs,
                    step_sizes=weights_c, round_cost=round_cost,
                    program=programs.pop(i, None),
                )
            chunks["members"].append(params_c)
            chunks["weights"].append(weights_c)
            chunks["aux"].append(aux)
            stopped = False
            if errs is not None:
                if dp_on:
                    best, v, stopped, kept = _execution.device_patience_step(
                        errs, best, v, self.validation_tol, self.num_rounds,
                        telem=telem,
                    )
                    val_history.extend(errs[:kept].tolist())
                    if stopped:
                        i += kept
                else:
                    for j, err in enumerate(errs_host):
                        val_history.append(err)
                        best, v = self._patience_step(best, err, v,
                                                      self.validation_tol)
                        logger.info("%s round %d: val_loss=%.6f patience=%d",
                                    label, i + j, err, v)
                        if v >= self.num_rounds:
                            i += j + 1
                            stopped = True
                            break
            if not stopped:
                i += c
                save_state(i - 1, v, best)
            return i, v, best, stopped

        def part(tree, lo, hi):
            return tree_map(lambda x: x[lo:hi], tree)

        def sanitize(tree):
            return tree_map(
                lambda x: torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
                if x.is_floating_point() else x,
                tree,
            )

        def recover(i0, bad, snap, params_c, weights_c, errs, errs_host, aux,
                    v, best, t_chunk):
            """``on_nonfinite`` for a chunk whose first poisoned round is
            chunk-relative index ``bad`` -> (i, v, best, halt)."""
            rnd = i0 + bad
            if guard.policy == "raise":
                guard.raise_error(rnd)
            if guard.policy == "stop_early":
                # keep the clean prefix; the poisoned carry is never used
                # again (the model is assembled from members)
                guard.record(rnd, "stop_early")
                i = i0
                if bad > 0:
                    i, v, best, _ = process(
                        i0, bad, part(params_c, 0, bad), weights_c[:bad],
                        None if errs is None else errs[:bad],
                        None if errs_host is None else errs_host[:bad],
                        part(aux, 0, bad), v, best, t_chunk,
                    )
                return i, v, best, True
            # skip_round / halve_step: rewind the carry and replay the clean
            # prefix (same absolute rounds -> same keys -> same outputs;
            # injected faults fire at most once per site)
            restore(snap)
            i = i0
            if bad > 0:
                t_pre = time.perf_counter()
                p_pre, w_pre, e_pre, a_pre = dispatch(slice(i0, i0 + bad))
                _, eh_pre = read(p_pre, w_pre, e_pre)
                i, v, best, stopped = process(i0, bad, p_pre, w_pre, e_pre,
                                              eh_pre, a_pre, v, best, t_pre)
                if stopped:
                    return i, v, best, False
            if guard.policy == "halve_step":
                for h in range(1, guard.max_halvings + 1):
                    scale = 0.5 ** h
                    snap2 = snapshot()
                    t1 = time.perf_counter()
                    p1, w1, e1, a1 = dispatch(slice(i, i + 1), step_scale=scale)
                    bad1, eh1 = read(p1, w1, e1)
                    if bad1 is None:
                        guard.record(i, "halve_step", step_scale=scale)
                        i, v, best, _ = process(i, 1, p1, w1, e1, eh1, a1, v,
                                                best, t1)
                        return i, v, best, False
                    restore(snap2)
                # not recoverable by damping: fall through to a skip
            # skip: re-run the round at step_scale=0; the carry advances by
            # exactly zero while keys, masks and the checkpoint cadence stay
            # on absolute round indices
            guard.record(i, "skip_round")
            t1 = time.perf_counter()
            p1, w1, e1, a1 = dispatch(slice(i, i + 1), step_scale=0.0)
            # the member fit itself may be the non-finite source: keep a
            # sanitized zero-weight copy so predict never sees 0 * NaN
            p1, w1 = sanitize(p1), sanitize(w1)
            e1 = None if e1 is None else torch.nan_to_num(e1)
            _, eh1 = read(p1, w1, e1)
            i, v, best, _ = process(i, 1, p1, w1, e1, eh1, a1, v, best, t1)
            return i, v, best, False

        class _Adapter(_execution.RoundAdapter):
            """Each launched entry carries two carry snapshots: the chunk
            start (the guard's rewind point) and the chunk end (the state a
            checkpoint must see, so a speculative chunk is never saved
            before its predecessor commits)."""

            def __init__(self):
                self.depth = depth
                self.telem = telem  # the executor traces chunk spans
                self.span_fields = span_fields
                self.i, self.v, self.best = i, v, best
                self.halt = False
                self.i_disp = i  # launch frontier (absolute round index)

            def should_continue(self):
                return (not self.halt and self.i < drv.num_base_learners
                        and self.v < drv.num_rounds)

            def can_launch(self):
                return self.i_disp < drv.num_base_learners

            def launch(self):
                c = min(chunk, drv.num_base_learners - self.i_disp)
                if ckpt.enabled:
                    c = min(c, ckpt.rounds_until_save(self.i_disp))
                snap_pre = snapshot()
                t0 = time.perf_counter()
                out = dispatch(slice(self.i_disp, self.i_disp + c))
                entry = (self.i_disp, c, snap_pre, snapshot(), t0) + out
                self.i_disp += c
                return entry

            def commit(self, entry, speculated):
                i0, c, snap_pre, snap_post, t0, params_c, weights_c, errs, aux = entry
                if telem.enabled:
                    # host-blocked accounting (a pure fence): the wait the
                    # lookahead exists to overlap
                    telem.blocking_read((params_c, weights_c, errs))
                bad, errs_host = read(params_c, weights_c, errs)
                if speculated:
                    # commit under this chunk's own end state: a save must
                    # persist committed arrays, not the speculative frontier
                    frontier = snapshot()
                    restore(snap_post)
                if bad is None:
                    self.i, self.v, self.best, stopped = process(
                        i0, c, params_c, weights_c, errs, errs_host, aux,
                        self.v, self.best, t0,
                    )
                    # a mid-chunk validation stop: chunks in flight were
                    # launched for rounds that no longer exist
                    invalidate = stopped
                    if speculated and not stopped:
                        restore(frontier)
                else:
                    self.i, self.v, self.best, self.halt = recover(
                        i0, bad, snap_pre, params_c, weights_c, errs,
                        errs_host, aux, self.v, self.best, t0,
                    )
                    invalidate = True
                # chaos: a preemption lands here, after the chunk's
                # periodic save, so kill-and-resume runs cross a real
                # checkpoint boundary
                ctl.preempt(f"{label}:after_round:{self.i}")
                if refresh_fit:
                    # refresh-only kill site: a warm-start refresh fit dies
                    # mid-fit, and the served model must stay untouched
                    ctl.refresh_crash(f"{label}:refresh_round:{self.i}")
                return invalidate

            def reset_frontier(self):
                self.i_disp = self.i

            def finish(self):
                # join the in-flight save (and surface its failure) before
                # the model is assembled
                ckpt.wait()

        try:
            ad = _execution.RoundExecutor(_Adapter()).run()
        except BaseException:
            ckpt.abandon()
            raise
        return ad.i, ad.v, ad.best

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
        if isinstance(vh, torch.Tensor):  # as a loaded model holds it
            return vh.detach().cpu().numpy()
        return np.asarray(vh)


def _row_sharded_sample(sample, mesh, n):
    """A sampling plan's draws over all ``n`` rows (the same on every rank,
    bit for bit the unsharded draws), cut to this rank's block of the padded
    rows (padding at weight 0), as the JAX package's ``P(None, ax)``."""

    def sample_l(i):
        bag_w, mask = sample(i)
        return shard_rows(mesh, bag_w, n), mask

    return sample_l


def _sharded_mean(values, valid, ax):
    """The mean of ``values`` over the real rows of every rank: both sums
    reduced over ``ax`` (the JAX package's psum-ed weighted mean)."""
    num, den = preduce(torch.stack([torch.sum(valid * values), torch.sum(valid)]), ax)
    return num / den


def _split_validation(X, y, w_all, validation_indicator):
    if validation_indicator is None:
        return X, y, w_all, None, None
    vi = torch.as_tensor(np.asarray(validation_indicator, bool), device=X.device)
    return X[~vi], y[~vi], w_all[~vi], X[vi], y[vi]


def _goss_multiplier(neg_grad, w, bag_w, key, top_rate, other_rate,
                     axis_name=None):
    """The legacy GOSS weight mask ``f32[n]``: 1 on the rows whose gradient
    norm is in the top ``top_rate`` (the exact weighted quantile), and a
    Bernoulli keep of the rest at rate ``other_rate / (1 - top_rate)``
    weighted by its reciprocal, so the rest's gradient mass is unbiased.
    Under a mesh the threshold is the sharded quantile, and each rank folds
    its coordinate on every row axis into the key, as the JAX package
    folds ``axis_index``, so the ranks draw different patterns."""
    score = torch.sqrt(torch.sum(neg_grad * neg_grad, dim=-1))
    thr = weighted_quantile(score, 1.0 - top_rate, w * bag_w, axis_name=axis_name)
    if axis_name is not None:
        for name in axis_name.names:
            key = fold_in(key, axis_name.coords[name])
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
                                  goss=None, goss_key=None, axis_name=None):
    """Targets/weights for the round's base fit -> (labels[n, dim],
    fit_w[n, dim], bag_w); ``bag_w`` comes back multiplied by the legacy
    GOSS mask when ``goss=(top_rate, other_rate)``, so the line search
    sees the rows the trees fit.  Under a mesh the hessian sum is reduced
    over ``axis_name``."""
    neg_grad = loss.negative_gradient(y_enc, pred)
    if goss is not None:
        bag_w = bag_w * _goss_multiplier(neg_grad, w, bag_w, goss_key, *goss,
                                         axis_name=axis_name)
    if updates == "newton" and loss.has_hessian:
        h = torch.clamp(loss.hessian(y_enc, pred), min=1e-2)
        sum_h = preduce(torch.sum(bag_w[:, None] * h, dim=0, keepdim=True),
                        axis_name)
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


def _squared_step(bag_w, direction, res, axis_name=None):
    """The closed-form step of squared loss: ``phi(a) = sum bw*(res -
    a*dir)^2/2`` is exactly quadratic; its minimizer, clamped to Brent's
    [0, 100] bracket (1.0 for a zero direction).  Both sums are reduced
    under a mesh."""
    num = torch.sum(bag_w * direction * res)
    den = torch.sum(bag_w * direction * direction)
    if axis_name is not None:
        num, den = preduce(torch.stack([num, den]), axis_name)
    return torch.where(
        den > 1e-30,
        torch.clamp(num / torch.clamp(den, min=1e-30), 0.0, 100.0),
        torch.ones((), device=den.device),
    )


def make_reg_round_core(base, loss_name, alpha_q, updates, optimized, goss,
                        tol, max_iter, sampling=None, ax=None):
    """One regressor round ``(ctx, X, bag_w, keys, mask, pred, delta, y, w,
    lr, step_scale=1.0) -> (params, weight, new_pred)``: the closed-form
    step for squared loss, Brent over [0, 100] for the others.  ``keys`` is the round's
    ``(bag key, sampling key)`` (``_GBMParams._round_keys``): the base
    learner draws from the first, the gradient sampling from the second.
    With a ``sampling`` plan (``_resolved_sampling``) the tree fit, the
    hessian sum and the step search run over the gathered survivors, and
    only the prediction update routes every row.  The round's parts
    without sampling (``round_core.targets`` and ``round_core.step``) are
    what a megabatch sweep runs per lane (``models/gbm_sweep.py``).  ``ax``
    is a mesh fit's row axis: the rows are this rank's, and every row sum
    is reduced over it."""

    def step(loss, y_s, pred_s, bag_s, dir_s):
        if optimized and loss_name == "squared":
            return _squared_step(bag_s, dir_s, y_s - pred_s, ax)
        if optimized:
            y_enc_s = loss.encode_label(y_s)

            def phi(a):
                return torch.sum(
                    bag_s * loss.loss(y_enc_s, (pred_s + a * dir_s)[:, None])
                )

            return brent_minimize(phi, 0.0, 100.0, tol=tol, max_iter=max_iter,
                                  axis_name=ax).to(pred_s.device)
        return torch.ones((), device=pred_s.device)

    def targets(loss, y, pred, bag_w, w, samp_key):
        """The round's fit targets and weights -> (labels[n], fit_w[n],
        bag_w)."""
        labels, fit_w, bag_w = _pseudo_residuals_and_weights(
            loss, updates, loss.encode_label(y), pred[:, None], bag_w, w,
            goss, samp_key, axis_name=ax,
        )
        return labels[:, 0].contiguous(), fit_w[:, 0].contiguous(), bag_w

    def round_core(ctx, X, bag_w, keys, mask, pred, delta, y, w, lr,
                   step_scale=1.0):
        base_key, samp_key = keys
        loss = _make_reg_loss(loss_name, alpha_q, delta)
        if sampling is None:
            labels, fit_w, bag_w = targets(loss, y, pred, bag_w, w, samp_key)
            params, direction = base.fit_and_direction(
                ctx, labels, fit_w, mask, X, key=base_key, axis_name=ax
            )
            alpha = step(loss, y, pred, bag_w, direction)
        else:
            y_enc = loss.encode_label(y)
            idx, mult = _sample_compact(
                sampling["method"], loss.sampling_scores(y_enc, pred[:, None]),
                (w * bag_w) > 0, samp_key, sampling["bucket"], sampling["samp"],
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
                fit_w[:, 0].contiguous(), mask, X, key=base_key,
            )
            alpha = step(loss, y_s, pred_s, bag_s, direction[idx])
        weight = _scaled_step(lr * alpha, step_scale)
        return params, weight, _advance(pred, weight, direction, step_scale)

    round_core.targets = targets
    round_core.step = step
    return round_core


def make_cls_round_core(base, loss, dim, updates, optimized, goss, tol,
                        max_iter, sampling=None, ax=None, member_axis=None):
    """One classifier round ``(ctx, X, y_enc, w, bag_w, keys, mask, pred,
    alpha_ws, lr, step_scale=1.0) -> (params, weight[dim], new_pred,
    alpha_carry)``, with
    ``keys`` the round's ``(bag key, sampling key)``.  With a ``sampling``
    plan, rows rank by their gradient norm over the class dims, and every
    dim's tree fits on the same gathered buffer.  The step search is
    ``projected_newton_box_lanes`` over one lane; a megabatch sweep runs it
    over every candidate at once (``round_core.targets``,
    ``round_core.step_problem``).

    Under a mesh ``ax`` is the row axis (every row sum reduced over it)
    and ``member_axis`` the "member" axis, whose ranks fit equal blocks of
    the class dims: the dims round up to a multiple of its size with
    phantom dims of zero labels and weights, each rank fits its block, and
    the params and directions are gathered over it and trimmed to ``dim``
    before the step search."""
    member_size = 1 if member_axis is None else member_axis.size
    dim_blk = dim + (-dim) % member_size
    k_local = dim_blk // member_size

    def fit_dims(ctx, labels, fit_w, mask, X, base_key):
        if member_axis is None:
            return base.fit_many_and_directions(
                ctx, labels, fit_w, mask, X, keys=base_key, axis_name=ax
            )
        if dim_blk != dim:
            pad = labels.new_zeros((labels.shape[0], dim_blk - dim))
            labels, fit_w = torch.cat([labels, pad], 1), torch.cat([fit_w, pad], 1)
        lo = member_axis.index * k_local
        params, directions = base.fit_many_and_directions(
            ctx, labels[:, lo:lo + k_local].contiguous(),
            fit_w[:, lo:lo + k_local].contiguous(), mask, X, keys=base_key,
            axis_name=ax,
        )
        params = tree_map(lambda a: pgather(a, member_axis, 0)[:dim], params)
        return params, pgather(directions, member_axis, 1)[:, :dim]

    def step_problem(y_enc_s, pred_s, bag_s, dirs_s):
        """The step search's objective and its closed-form gradient and
        hessian."""

        def phi(a):
            return torch.sum(bag_s * loss.loss(y_enc_s, pred_s + a[None, :] * dirs_s))

        def gh(a):
            return loss.linesearch_grad_hess(
                y_enc_s, pred_s + a[None, :] * dirs_s, dirs_s, bag_s
            )

        return phi, gh

    def step(y_enc_s, pred_s, bag_s, dirs_s, alpha_ws):
        if not optimized:
            return torch.ones((dim,), dtype=torch.float32, device=pred_s.device)
        phi, gh = step_problem(y_enc_s, pred_s, bag_s, dirs_s)
        # warm start from the previous round's step sizes
        return projected_newton_box_lanes(
            [phi], alpha_ws[None], max_iter=min(max_iter, 25), tol=tol,
            grad_hess=[gh], axis_name=ax,
        )[0]

    def targets(y_enc, pred, bag_w, w, samp_key):
        """The round's fit targets and weights -> (labels[n, dim],
        fit_w[n, dim], bag_w)."""
        labels, fit_w, bag_w = _pseudo_residuals_and_weights(
            loss, updates, y_enc, pred, bag_w, w, goss, samp_key, axis_name=ax,
        )
        return labels.contiguous(), fit_w.contiguous(), bag_w

    def round_core(ctx, X, y_enc, w, bag_w, keys, mask, pred, alpha_ws, lr,
                   step_scale=1.0, member=None):
        """``member``: replay a committed round (``fit_resume``), its
        directions the stored member's predictions in place of a fit."""
        base_key, samp_key = keys
        if sampling is None:
            labels, fit_w, bag_w = targets(y_enc, pred, bag_w, w, samp_key)
            if member is None:
                params, directions = fit_dims(ctx, labels, fit_w, mask, X, base_key)
            else:
                params, directions = member, base.predict_many_fn(member, X).T
            alpha = step(y_enc, pred, bag_w, directions, alpha_ws)
        else:
            idx, mult = _sample_compact(
                sampling["method"], loss.sampling_scores(y_enc, pred),
                (w * bag_w) > 0, samp_key, sampling["bucket"], sampling["samp"],
            )
            y_enc_s, pred_s = y_enc[idx], pred[idx]
            labels, fit_w, bag_s = _pseudo_residuals_and_weights(
                loss, updates, y_enc_s, pred_s, bag_w[idx] * mult, w[idx]
            )
            if member is None:
                params, directions = base.fit_gathered_many_and_directions(
                    base.ctx_gather_rows(ctx, idx), labels.contiguous(),
                    fit_w.contiguous(), mask, X, keys=base_key,
                )
            else:
                params, directions = member, base.predict_many_fn(member, X).T
            alpha = step(y_enc_s, pred_s, bag_s, directions[idx], alpha_ws)
        weight = _scaled_step(lr * alpha, step_scale)
        new_pred = _advance(pred, weight[None, :], directions, step_scale)
        return params, weight, new_pred, alpha_carry(alpha)

    round_core.targets = targets
    round_core.step = step
    round_core.step_problem = step_problem
    return round_core


def _weighted_round_sum(weights, preds):
    """``sum_m weights[m, ...] * preds[m, ..., n]`` over the round axis:
    each product rounded, then summed by the fixed pairwise tree of
    ``ops/collective.pairwise_sum``, so a row's sum does not depend on how
    many rows share the call (CUDA's sum over the rounds reorders when one
    row is left).  The serving engine relies on that: a request padded
    into a bucket predicts as it does alone."""
    return pairwise_sum(weights[..., None] * preds)


def _scaled_step(weight, step_scale):
    """The guard's step damper on a round's weight: 1.0 on the clean path
    (the weight untouched), a halving under ``halve_step``, and a hard zero
    at 0 (``skip_round``), so a NaN step cannot leak through 0 * NaN."""
    if step_scale == 1.0:
        return weight
    if step_scale > 0:
        return weight * step_scale
    return torch.zeros_like(weight)


def _advance(pred, weight, direction, step_scale):
    """The carried prediction after a round; unchanged at step_scale 0."""
    if step_scale > 0:
        return pred + weight * direction
    return pred.clone()


def alpha_carry(alpha):
    """The next round's warm start: this round's step sizes, 1 where not
    finite."""
    return torch.where(torch.isfinite(alpha), alpha, torch.ones_like(alpha))


def _concat(chunks):
    """Round-stacked chunks (leading round axis) -> one stack, or None."""
    if not chunks:
        return None
    return tree_map(lambda *xs: torch.cat(xs), *chunks)


def _take_rounds(members, k: int):
    """The first ``k`` rounds of round-stacked members (None when none)."""
    if members is None or k <= 0:
        return None
    return tree_map(lambda a: a[:k], members)


def _check_resume_args(model, k: int, n_new: int, X) -> None:
    """The ``fit_resume`` argument gate of the GBM and Boosting families."""
    if k < 1:
        raise ValueError(
            "fit_resume needs at least one committed member to resume from"
        )
    if n_new < 1:
        raise ValueError(f"n_new_rounds must be >= 1; got {n_new}")
    shape = tuple(X.shape) if hasattr(X, "shape") else np.shape(X)
    d = shape[1] if len(shape) == 2 else -1
    if d != model.num_features:
        raise ValueError(
            f"fit_resume requires the original training matrix "
            f"(num_features={model.num_features}); got shape {shape}"
        )


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

    def _fit_init(self, X, y, w, device, mesh=None):
        """The init model; under a mesh its fit runs over the mesh's rows
        too (the base learner's or the dummy's standalone mesh fit)."""
        strategy = self.init_strategy.lower()
        if strategy == "base":
            base = self._base()
            return base.fit(X, y, sample_weight=w, device=device,
                            **mesh_fit_kwargs(base, mesh))
        name = self.loss.lower()
        if strategy == "zero":
            dummy = DummyRegressor(strategy="constant", constant=0.0)
        elif name in ("absolute", "huber"):
            dummy = DummyRegressor(strategy="median")
        elif name == "quantile":
            dummy = DummyRegressor(strategy="quantile", quantile=self.alpha)
        else:
            dummy = DummyRegressor(strategy="mean")
        return dummy.fit(X, y, sample_weight=w, device=device,
                         **mesh_fit_kwargs(dummy, mesh))

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, validation_indicator=None,
            mesh=None, device="cuda"):
        """Fit; with ``mesh`` (``parallel/mesh.py``; every rank calls with
        the same arrays) the rows shard over the mesh's row axes and every
        rank returns the same model."""
        dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w_all = resolve_weights(y, sample_weight)
        X, y, w, X_val, y_val = _split_validation(X, y, w_all, validation_indicator)
        n, d = X.shape
        instr = Instrumentation("GBMRegressor.fit")
        instr.log_params(self.get_params())
        instr.log_dataset(n, d)
        telem = FitTelemetry.start(self, n=n, d=d, mesh=mesh)
        base = self._base().copy()
        ctx = make_shared_fit_ctx(base, X)
        # the training-time drift reference (telemetry/quality.py),
        # counted on the device from the binned ctx
        drift_ref = drift_reference_from_ctx(ctx)
        model = self._fit_rounds(X, y, w, X_val, y_val, base, ctx, dev,
                                 telem=telem, drift_ref=drift_ref, mesh=mesh)
        instr.log_outcome(kept_members=model.num_members)
        return model

    @instrumented_fit
    def fit_streaming(self, store, y, sample_weight=None, X_val=None,
                      y_val=None, mesh=None, reduce="ordered", device="cuda"):
        """Out-of-core fit over a sealed ``ShardStore`` (``data/shards.py``):
        the packed bins stream from disk shard by shard, never on the
        device at once, and the fit is bit-identical to ``fit`` with a
        ``hist="stream"`` base learner at matched chunk rows
        (``data/streaming.py``).  The validation split (``X_val``,
        ``y_val``) stays resident.  With ``mesh`` (every rank calls with
        the same store and labels) each rank sweeps its round-robin slice
        of the shards and the ranks fold their histograms together
        (``parallel/elastic.DistributedSweep``): bit-identical to the
        single-process fit under ``reduce="ordered"``, allclose under
        ``"psum"``."""
        self._check_streaming_supported()
        from spark_ensemble_tpu_torch.data.streaming import fit_streaming_regressor

        return fit_streaming_regressor(
            self, store, y, sample_weight=sample_weight, X_val=X_val,
            y_val=y_val, mesh=mesh, reduce=reduce, device=device,
        )

    def _fit_rounds(self, X, y, w, X_val, y_val, base, ctx, dev, telem,
                    trees=None, drift_ref=None, mesh=None):
        """The round loop of :meth:`fit` from the training split on: ``X``
        f32[n, d] (only its shape is read when ``trees`` fits the rounds),
        ``ctx`` the base's fit context, ``telem`` the fit's telemetry.
        ``trees`` stands in for the base in the round core (a streaming
        fit's shard sweep: ``trees.begin_round(r)`` runs before round ``r``
        and ``trees.end_round(r)`` after it).  The model carries
        ``drift_ref`` as ``drift_ref_`` when given.  With ``mesh`` the
        arrays are the global ones and each rank keeps its rows here."""
        loss_name = self.loss.lower()
        alpha_q = float(self.alpha)
        huber = loss_name == "huber"
        n, d = X.shape
        init_model = self._fit_init(X, y, w, dev, mesh)
        # initial huber delta: the alpha-quantile of the label over the
        # full input, validation rows included
        delta = (weighted_quantile(torch.cat([y, y_val]) if y_val is not None else y,
                                   alpha_q)
                 if huber else torch.zeros((), device=dev))
        sample = self._sampling_plan(n, d, dev)
        lr = float(self.learning_rate)
        plan = self._resolved_sampling(n)
        self._check_sampling_supported(plan, mesh)
        _emit_sampling_config(telem, plan)
        bag_keys, samp_keys = self._round_keys(dev, plan)
        ax = valid = None
        if mesh is not None:
            ctx, X, ax, _, (y, w, valid) = setup_row_sharding(
                mesh, base, ctx, X, n, (y, w, torch.ones_like(y)))
            sample = _row_sharded_sample(sample, mesh, n)
        pred = init_model.predict(X).clone()
        round_core = make_reg_round_core(
            base if trees is None else trees, loss_name, alpha_q,
            self.updates.lower(), bool(self.optimized_weights), self._goss(),
            float(self.tol), int(self.max_iter), plan, ax=ax,
        )
        with_validation = X_val is not None
        best, pred_val = 0.0, None
        if with_validation:
            pred_val = init_model.predict(X_val).clone()
            y_val_enc = y_val[:, None]
            best = float(torch.mean(
                _make_reg_loss(loss_name, alpha_q, delta).loss(y_val_enc, pred_val[:, None])
            ))
            if mesh is not None:
                nv = X_val.shape[0]
                X_val, y_val_enc, pred_val, valid_val = (
                    shard_rows(mesh, t, nv)
                    for t in (X_val, y_val_enc, pred_val, torch.ones_like(y_val)))
        # huber's per-round quantile: every real row at weight 1 (zero-weight
        # padding under a mesh, as the JAX package's validity mask)
        ones = torch.ones_like(y) if valid is None else valid
        chunks = {"members": [], "weights": [], "aux": []}
        val_history: List[float] = []
        i, v = 0, 0

        nv = 0 if y_val is None else y_val.shape[0]  # X_val is this rank's block
        blocks = CheckpointBlocks(mesh, n, nv, trees)
        ckpt = self._checkpointer(dev, n, d, nv, blocks.n_pad, blocks.nv_pad,
                                  telem=telem, axis=blocks.axis)
        resumed = self._load_resume(ckpt, telem, blocks.axis)
        if resumed is not None:
            last_round, st = resumed
            i, v, best = last_round + 1, int(st["v"]), float(st["best"])
            val_history[:] = [float(x) for x in st["val_hist"].tolist()]
            pred = blocks.own(st["pred"].to(dev))
            if st.get("pred_val") is not None:
                pred_val = blocks.own(st["pred_val"].to(dev), val=True)
            members, weights = self._resume_chunks(st)
            chunks["members"], chunks["weights"] = members, weights
            if huber:
                chunks["aux"] = [st["huber_delta"]]
            delta = st["delta"].to(dev)
            logger.info("GBMRegressor resuming from round %d", i)

        def save_state(round_idx, v, best):
            # gate before building the state: the concat below must not
            # run every round
            if not ckpt.should_save(round_idx):
                return
            ckpt.save(round_idx, {
                "v": v,
                "best": best,
                "val_hist": torch.tensor(val_history, dtype=torch.float32),
                "pred": blocks.whole(pred),
                "pred_val": blocks.whole(pred_val),
                "members_layout": self.MEMBERS_LAYOUT,
                "members": _concat(chunks["members"]),
                "weights": torch.cat(chunks["weights"]),
                "delta": delta,
                # the port's model keeps every round's huber delta
                "huber_delta": _concat(chunks["aux"]) if huber else None,
            })

        def run_chunk(sl, step_scale=1.0):
            nonlocal pred, pred_val, delta
            p, pv, dl = pred, pred_val, delta
            params_l, weights_l, errs_l, deltas_l = [], [], [], []
            for r in range(sl.start, sl.stop):
                if trees is not None:
                    trees.begin_round(r)
                bag_w, mask = sample(r)
                if huber:
                    dl = weighted_quantile(torch.abs(y - p), alpha_q, weights=ones,
                                           axis_name=ax)
                    deltas_l.append(dl)
                params, weight, p = round_core(
                    ctx, X, bag_w, (bag_keys[r], samp_keys[r]), mask, p, dl,
                    y, w, lr, step_scale,
                )
                if with_validation:
                    pv = _advance(pv, weight, base.predict_fn(params, X_val),
                                  step_scale)
                    le = _make_reg_loss(loss_name, alpha_q, dl).loss(y_val_enc, pv[:, None])
                    errs_l.append(torch.mean(le) if ax is None
                                  else _sharded_mean(le.reshape(-1), valid_val, ax))
                params_l.append(params)
                weights_l.append(weight)
                if trees is not None:
                    trees.end_round(r)
            # the carry moves only once the whole chunk ran, so a retried
            # chunk starts from the same state
            pred, pred_val, delta = p, pv, dl
            return (stack_members(params_l), torch.stack(weights_l),
                    torch.stack(errs_l) if with_validation else None,
                    torch.stack(deltas_l) if huber else None)

        def snapshot():
            return pred, pred_val, delta

        def restore(snap):
            nonlocal pred, pred_val, delta
            pred, pred_val, delta = snap

        guard = self._numeric_guard(telem)
        telem.phase_mark("setup")
        i, v, best = self._drive_rounds(
            ckpt, chunks, run_chunk, save_state, "GBMRegressor", i, v, best,
            val_history, guard, snapshot, restore, telem,
            round_cost=(_round_cost(base, n, d, 1, dev, plan)
                        if telem.enabled else None),
            span_fields=_sampling_span_fields(plan),
            program_args=(X, y, self),
        )
        ckpt.delete()
        keep = i - v
        model = _with_guard_events(guard, self._model(_concat(chunks["members"]),
                           torch.cat(chunks["weights"]) if chunks["weights"] else None,
                           keep, d, dev, val_history if with_validation else None,
                           init_model=init_model,
                           # each round's huber delta (every round run, kept or not)
                           huber_delta=_concat(chunks["aux"]) if huber else None))
        if drift_ref is not None:
            model.drift_ref_ = drift_ref
        telem.finish(model=model, rounds=i, kept_members=keep)
        return model

    def _model(self, members, weights, keep, d, dev, val_history, *, init_model,
               huber_delta):
        """The fitted model of the first ``keep`` of the round-stacked
        ``members`` and ``weights`` (``val_history`` None without a
        validation split)."""
        return GBMRegressionModel(
            params={
                "members": _take_rounds(members, keep),
                "weights": (weights[:keep] if keep > 0
                            else torch.zeros((0,), device=dev)),
                "masks": self._model_masks(d, dev)[:keep],
                "init": init_model.params,
                "val_hist": (None if val_history is None
                             else np.asarray(val_history, np.float32)),
                "huber_delta": huber_delta,
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

    @predict_program("predict")
    def predict(self, X):
        X = self._input(X)
        out = self.init_model.predict(X)
        if self.num_members == 0:
            return out
        preds = self._base().predict_many_fn(self.params["members"], X)
        return out + _weighted_round_sum(self.params["weights"], preds)

    def _persisted_params(self):
        # huber's per-round deltas are a diagnostic of the fit; the JAX
        # package's model has no such key, so a save leaves them out
        return {k: v for k, v in self.params.items() if k != "huber_delta"}

    def take(self, k: int) -> "GBMRegressionModel":
        """The model of the first ``k`` rounds (the reference's rebuilt
        ``new GBMRegressionModel(take(i), ...)``)."""
        k = min(k, self.num_members)
        vh, hd = self.params.get("val_hist"), self.params.get("huber_delta")
        return GBMRegressionModel(
            params={
                "members": _take_rounds(self.params["members"], k),
                "weights": self.params["weights"][:k],
                "masks": self.params["masks"][:k],
                "init": self.params["init"],
                "val_hist": None if vh is None else vh[:k],
                "huber_delta": None if hd is None else hd[:k],
            },
            num_features=self.num_features,
            init_model=self.init_model,
            num_members=k,
            device=self.device,
            **self.get_params(),
        )

    def fit_resume(self, X, y, n_new_rounds, sample_weight=None, device=None):
        """Continue this model for ``n_new_rounds`` more rounds on the same
        training data: bit-identical to one ``num_members + n_new_rounds``
        round fit, since round keys and masks derive from absolute round
        indices.  The carried predictions replay from the stored members in
        the fit's own per-round f32 order (the trees' predict routes to the
        leaf values the fit's same-row directions read), huber's per-round
        delta with them; the state goes in as a warm resume that the next
        fit consumes like a loaded checkpoint.  Fits without a validation
        split; ``device`` defaults to this model's."""
        k, n_new = int(self.num_members), int(n_new_rounds)
        _check_resume_args(self, k, n_new, X)
        dev = resolve_device(device if device is not None else self.device)
        X32, y32 = as_f32(X, dev), as_f32(y, dev)
        base = self._base().copy()
        members = tree_map(lambda a: a.to(dev), self.params["members"])
        weights = self.params["weights"].to(dev, torch.float32)
        pred = self.init_model.predict(X32).to(dev).clone()
        huber = self.loss.lower() == "huber"
        ones = torch.ones_like(y32)
        deltas = []
        for r in range(k):
            if huber:
                deltas.append(weighted_quantile(torch.abs(y32 - pred),
                                                float(self.alpha), weights=ones))
            pred = pred + weights[r] * base.predict_fn(
                tree_map(lambda a: a[r], members), X32)
        delta = deltas[-1] if huber else torch.zeros((), device=dev)
        est = GBMRegressor(**{**self.get_params(), "num_base_learners": k + n_new})
        est._set_warm_resume(k - 1, {
            "v": 0,
            "best": 0.0,
            "val_hist": torch.zeros((0,)),
            "pred": pred,
            "pred_val": None,
            "members_layout": self.MEMBERS_LAYOUT,
            "members": members,
            "weights": weights,
            "delta": delta,
            "huber_delta": torch.stack(deltas) if huber else None,
        })
        return est.fit(X, y, sample_weight=sample_weight, device=dev)


def _probe_classifier_phases(telem, round_core, base, ctx, X, y_enc, w, bag_w,
                             keys, mask, pred, alpha_ws):
    """Opt-in fine-phase probe (``SE_TPU_TELEMETRY_PHASES=1``): runs round
    0's pieces one by one on its inputs, each twice (the first run warms
    the allocator), and emits a ``phase_probe`` event with each piece's
    fenced wall time.  ``tree_fit`` covers the histogram kernels, the
    split search and the leaf pass together (per-kernel splits:
    ``utils/profiling.py`` on a ``profile_dir`` capture).  The probe reads
    and writes no state the fit carries, so the fit is unchanged."""
    from spark_ensemble_tpu_torch.utils.instrumentation import block_on_arrays

    def time_once(fn, *args):
        block_on_arrays(fn(*args))
        t0 = time.perf_counter()
        out = fn(*args)
        block_on_arrays(out)
        return time.perf_counter() - t0, out

    base_key, samp_key = keys
    durations = {}
    dt, (labels, fit_w, bag_w) = time_once(
        round_core.targets, y_enc, pred, bag_w, w, samp_key)
    durations["grad_hess"] = dt
    dt, (_, directions) = time_once(
        lambda: base.fit_many_and_directions(ctx, labels, fit_w, mask, X,
                                             keys=base_key))
    durations["tree_fit"] = dt
    dt, alpha = time_once(round_core.step, y_enc, pred, bag_w, directions,
                          alpha_ws)
    durations["line_search"] = dt
    dt, _ = time_once(lambda: pred + alpha[None, :] * directions)
    durations["update"] = dt
    telem.phase_probe(
        durations,
        note="tree_fit fuses histogram build + split search + leaf solve; "
        "single-round unsharded probe, times representative not additive",
    )


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

    def _init_raw_scores(self, X, y, w, num_classes, dim, device, mesh=None):
        """Init model + round-0 raw scores: log prior for logloss (dim ==
        num_classes); for the binary dim-1 losses the prior log-odds, or
        zero under 'uniform'.  Under a mesh the prior's counts are reduced
        over the mesh's rows."""
        dummy = DummyClassifier(strategy=self.init_strategy)
        init_model = dummy.fit(
            X, y, sample_weight=w, num_classes=num_classes, device=device,
            **mesh_fit_kwargs(dummy, mesh),
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

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, validation_indicator=None,
            mesh=None, num_classes=None, device="cuda"):
        """Fit; with ``mesh`` the rows shard over the mesh's row axes and
        the class dims over its "member" axis, and every rank returns the
        same model (module docstring)."""
        dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        w_all = resolve_weights(y, sample_weight)
        # over the FULL label set, so a validation split missing the top
        # class cannot shrink the model
        num_classes = infer_num_classes(y, num_classes)
        X, y, w, X_val, y_val = _split_validation(X, y, w_all, validation_indicator)
        n, d = X.shape
        instr = Instrumentation("GBMClassifier.fit")
        instr.log_params(self.get_params())
        instr.log_dataset(n, d, num_classes)
        telem = FitTelemetry.start(self, n=n, d=d, num_classes=int(num_classes),
                                   mesh=mesh)
        base = self._base().copy()
        ctx = make_shared_fit_ctx(base, X)
        # the training-time drift reference (telemetry/quality.py),
        # counted on the device from the binned ctx
        drift_ref = drift_reference_from_ctx(ctx)
        model = self._fit_rounds(X, y, w, X_val, y_val, num_classes, base, ctx,
                                 dev, telem=telem, drift_ref=drift_ref, mesh=mesh)
        instr.log_outcome(kept_members=model.num_members)
        return model

    @instrumented_fit
    def fit_streaming(self, store, y, sample_weight=None, X_val=None,
                      y_val=None, num_classes=None, mesh=None, reduce="ordered",
                      device="cuda"):
        """Out-of-core fit over a sealed ``ShardStore``; see
        :meth:`GBMRegressor.fit_streaming` (``mesh`` and ``reduce`` too).
        The class dims fold into the shard sweep's member axis, as in the
        resident forest."""
        self._check_streaming_supported()
        from spark_ensemble_tpu_torch.data.streaming import fit_streaming_classifier

        return fit_streaming_classifier(
            self, store, y, sample_weight=sample_weight, X_val=X_val,
            y_val=y_val, num_classes=num_classes, mesh=mesh, reduce=reduce,
            device=device,
        )

    def _fit_rounds(self, X, y, w, X_val, y_val, num_classes, base, ctx, dev,
                    telem, trees=None, drift_ref=None, mesh=None):
        """The round loop of :meth:`fit` from the training split on; see
        :meth:`GBMRegressor._fit_rounds`."""
        loss = self._make_loss(num_classes)
        dim = loss.dim
        n, d = X.shape
        init_model, init_raw = self._init_raw_scores(X, y, w, num_classes, dim, dev,
                                                     mesh)
        sample = self._sampling_plan(n, d, dev)
        ax = member_axis = None
        if mesh is not None:
            ctx, X, ax, _, (y, w) = setup_row_sharding(mesh, base, ctx, X, n, (y, w))
            sample = _row_sharded_sample(sample, mesh, n)
            # a one-rank member axis holds every class dim: nothing to gather
            if mesh.member_axis is not None and mesh.member_axis.size > 1:
                member_axis = mesh.member_axis
        y_enc = loss.encode_label(y)
        pred = init_raw[None, :].expand(X.shape[0], dim).clone()
        # the step search's warm start, carried across rounds and
        # checkpoints (a resume replays the same Newton trajectory)
        alpha_ws = torch.ones((dim,), dtype=torch.float32, device=dev)
        lr = float(self.learning_rate)
        plan = self._resolved_sampling(n)
        self._check_sampling_supported(plan, mesh)
        _emit_sampling_config(telem, plan)
        bag_keys, samp_keys = self._round_keys(dev, plan)
        round_core = make_cls_round_core(
            base if trees is None else trees, loss, dim, self.updates.lower(),
            bool(self.optimized_weights), self._goss(), float(self.tol),
            int(self.max_iter), plan, ax=ax, member_axis=member_axis,
        )
        with_validation = X_val is not None
        best, pred_val = 0.0, None
        if with_validation:
            y_enc_val = loss.encode_label(y_val)
            pred_val = init_raw[None, :].expand(X_val.shape[0], dim).clone()
            best = float(torch.mean(loss.loss(y_enc_val, pred_val)))
            if mesh is not None:
                nv = X_val.shape[0]
                X_val, y_enc_val, pred_val, valid_val = (
                    shard_rows(mesh, t, nv)
                    for t in (X_val, y_enc_val, pred_val, torch.ones_like(y_val)))
        chunks = {"members": [], "weights": [], "aux": []}
        val_history: List[float] = []
        i, v = 0, 0

        nv = 0 if y_val is None else y_val.shape[0]  # X_val is this rank's block
        blocks = CheckpointBlocks(mesh, n, nv, trees)
        ckpt = self._checkpointer(dev, n, d, num_classes, nv, blocks.n_pad,
                                  blocks.nv_pad, telem=telem, axis=blocks.axis)
        resumed = self._load_resume(ckpt, telem, blocks.axis)
        if resumed is not None:
            last_round, st = resumed
            i, v, best = last_round + 1, int(st["v"]), float(st["best"])
            val_history[:] = [float(x) for x in st["val_hist"].tolist()]
            alpha_ws = st["alpha_ws"].to(dev)
            pred = blocks.own(st["pred"].to(dev))
            if st.get("pred_val") is not None:
                pred_val = blocks.own(st["pred_val"].to(dev), val=True)
            chunks["members"], chunks["weights"] = self._resume_chunks(st)
            logger.info("GBMClassifier resuming from round %d", i)

        def save_state(round_idx, v, best):
            if not ckpt.should_save(round_idx):
                return
            ckpt.save(round_idx, {
                "v": v,
                "best": best,
                "val_hist": torch.tensor(val_history, dtype=torch.float32),
                "pred": blocks.whole(pred),
                "pred_val": blocks.whole(pred_val),
                "alpha_ws": alpha_ws,
                "members_layout": self.MEMBERS_LAYOUT,
                "members": _concat(chunks["members"]),
                "weights": torch.cat(chunks["weights"]),
            })

        def run_chunk(sl, step_scale=1.0):
            nonlocal pred, pred_val, alpha_ws
            p, pv, aw = pred, pred_val, alpha_ws
            params_l, weights_l, errs_l = [], [], []
            for r in range(sl.start, sl.stop):
                if trees is not None:
                    trees.begin_round(r)
                bag_w, mask = sample(r)
                params, weight, p, aw = round_core(
                    ctx, X, y_enc, w, bag_w, (bag_keys[r], samp_keys[r]), mask,
                    p, aw, lr, step_scale,
                )
                if with_validation:
                    dirs_val = base.predict_many_fn(params, X_val).T
                    pv = _advance(pv, weight[None, :], dirs_val, step_scale)
                    le = loss.loss(y_enc_val, pv)
                    errs_l.append(torch.mean(le) if ax is None
                                  else _sharded_mean(le.reshape(-1), valid_val, ax))
                params_l.append(params)
                weights_l.append(weight)
                if trees is not None:
                    trees.end_round(r)
            pred, pred_val, alpha_ws = p, pv, aw
            return (stack_members(params_l), torch.stack(weights_l),
                    torch.stack(errs_l) if with_validation else None, None)

        def snapshot():
            return pred, pred_val, alpha_ws

        def restore(snap):
            nonlocal pred, pred_val, alpha_ws
            pred, pred_val, alpha_ws = snap

        guard = self._numeric_guard(telem)
        telem.phase_mark("setup")
        if (telem.enabled and telem.phases_enabled() and plan is None
                and trees is None and i == 0):
            bag0, mask0 = sample(0)
            _probe_classifier_phases(
                telem, round_core, base, ctx, X, y_enc, w, bag0,
                (bag_keys[0], samp_keys[0]), mask0, pred, alpha_ws,
            )
            telem.phase_mark("probe")
        i, v, best = self._drive_rounds(
            ckpt, chunks, run_chunk, save_state, "GBMClassifier", i, v, best,
            val_history, guard, snapshot, restore, telem,
            round_cost=(_round_cost(base, n, d, dim, dev, plan)
                        if telem.enabled else None),
            span_fields=_sampling_span_fields(plan),
            program_args=(X, y_enc, self),
        )
        ckpt.delete()
        keep = i - v
        model = _with_guard_events(guard, self._model(_concat(chunks["members"]),
                           torch.cat(chunks["weights"]) if chunks["weights"] else None,
                           keep, d, dev, val_history if with_validation else None,
                           init_raw=init_raw, num_classes=num_classes, dim=dim))
        if drift_ref is not None:
            model.drift_ref_ = drift_ref
        telem.finish(model=model, rounds=i, kept_members=keep)
        return model

    def _model(self, members, weights, keep, d, dev, val_history, *, init_raw,
               num_classes, dim):
        """The fitted model of the first ``keep`` of the round-stacked
        ``members`` and ``weights`` (``val_history`` None without a
        validation split)."""
        return GBMClassificationModel(
            params={
                "members": _take_rounds(members, keep),
                "weights": (weights[:keep] if keep > 0
                            else torch.zeros((0, dim), device=dev)),
                "masks": self._model_masks(d, dev)[:keep],
                "init_raw": init_raw,
                "val_hist": (None if val_history is None
                             else np.asarray(val_history, np.float32)),
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
        flat = tree_map(lambda a: a.reshape((r * dim,) + a.shape[2:]), members)
        preds = self._base().predict_many_fn(flat, X).reshape(r, dim, -1)
        return out + _weighted_round_sum(weights, preds).T

    @predict_program("raw")
    def predict_raw(self, X):
        f = self._raw_state(self._input(X))
        if self.dim == 1 and self.num_classes == 2:
            return torch.cat([-f, f], dim=1)
        return f

    def predict_proba(self, X):
        return self._make_loss(self.num_classes).raw2probability(self.predict_raw(X))

    def predict(self, X):
        return torch.argmax(self.predict_raw(X), dim=-1).to(torch.float32)

    def take(self, k: int) -> "GBMClassificationModel":
        """The model of the first ``k`` rounds."""
        k = min(k, self.num_members)
        vh = self.params.get("val_hist")
        return GBMClassificationModel(
            params={
                "members": _take_rounds(self.params["members"], k),
                "weights": self.params["weights"][:k],
                "masks": self.params["masks"][:k],
                "init_raw": self.params["init_raw"],
                "val_hist": None if vh is None else vh[:k],
            },
            num_features=self.num_features,
            num_classes=self.num_classes,
            num_members=k,
            dim=self.dim,
            device=self.device,
            **self.get_params(),
        )

    def fit_resume(self, X, y, n_new_rounds, sample_weight=None, device=None):
        """Continue for ``n_new_rounds`` more rounds on the same training
        data (the classifier's :meth:`GBMRegressionModel.fit_resume`).  The
        raw-score carry replays from ``init_raw`` over the [round,
        class-dim] member grid with the stored weights.  The step search's
        warm start is the last round's step, which ``weights[-1] /
        learning_rate`` gives exactly only at a power-of-two learning rate;
        so each committed round's step search runs again (the round with
        the stored member's directions in place of a fit), which gives the
        warm start bit for bit at any learning rate."""
        k, n_new = int(self.num_members), int(n_new_rounds)
        _check_resume_args(self, k, n_new, X)
        dev = resolve_device(device if device is not None else self.device)
        X32, y32 = as_f32(X, dev), as_f32(y, dev)
        n, d = X32.shape
        est = GBMClassifier(**{**self.get_params(), "num_base_learners": k + n_new})
        base = est._base().copy()
        loss = est._make_loss(self.num_classes)
        members = tree_map(lambda a: a.to(dev), self.params["members"])
        weights = self.params["weights"].to(dev, torch.float32)
        pred = self.params["init_raw"].to(dev)[None, :].expand(n, self.dim).clone()
        alpha_ws = torch.ones((self.dim,), dtype=torch.float32, device=dev)
        plan = est._resolved_sampling(n)
        round_core = make_cls_round_core(
            base, loss, self.dim, est.updates.lower(), bool(est.optimized_weights),
            est._goss(), float(est.tol), int(est.max_iter), plan,
        )
        sample = est._sampling_plan(n, d, dev)
        bag_keys, samp_keys = est._round_keys(dev, plan)
        y_enc = loss.encode_label(y32)
        w = resolve_weights(y32, sample_weight)
        for r in range(k):
            member = tree_map(lambda a: a[r], members)
            bag_w, mask = sample(r)
            _, _, _, alpha_ws = round_core(
                None, X32, y_enc, w, bag_w, (bag_keys[r], samp_keys[r]), mask,
                pred, alpha_ws, float(est.learning_rate), member=member,
            )
            dirs = base.predict_many_fn(member, X32).T
            pred = pred + weights[r][None, :] * dirs
        est._set_warm_resume(k - 1, {
            "v": 0,
            "best": 0.0,
            "val_hist": torch.zeros((0,)),
            "pred": pred,
            "pred_val": None,
            "alpha_ws": alpha_ws,
            "members_layout": self.MEMBERS_LAYOUT,
            "members": members,
            "weights": weights,
        })
        return est.fit(X, y, sample_weight=sample_weight,
                       num_classes=self.num_classes, device=dev)
