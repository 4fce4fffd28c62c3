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

Round ``i``'s key ``fold_in(PRNGKey(seed), i)`` goes to the base learner,
as in the JAX package; every round's key is hashed at fit start.  Any
base learner fits (a learner without routing reuse fits, then predicts).

The round loop is the JAX package's ``_drive_boosting_rounds`` on the
port's ``RoundExecutor``: chunks of ``scan_chunk`` rounds (a one-round
probe first for SAMME and Drucker, ``ramp``), each committed with one host
read of its stats, weight masses and finite flags, and the stopping rules
replayed on the host.  ``checkpoint_dir`` resumes a preempted fit,
``fit_resume`` continues a fitted model from its boosting-weight carry
(replayed over the stored members), and ``on_nonfinite`` drops a poisoned
round.  With telemetry each committed chunk's kept rounds become
``round_start`` / ``round_end`` events (loss: SAMME's weighted error,
Drucker's estimator error; step size: the estimator weight), its wall time
divided by the rounds the chunk computed.

``fit(X, y, mesh=...)`` shards the rows and the boosting weights over the
mesh's row axes (zero-weight padding included; every rank passes the same
global arrays): the weight masses and the weighted errors are reduced
across the ranks in rank order, Drucker's ``maxError`` is their max (the
padding rows masked out), and the base fit reduces its statistics.  So
every rank replays the same stopping rules on the same values and returns
the same model.  A checkpoint under a mesh holds the global padded boosting
weights (``parallel/mesh.CheckpointBlocks``), each rank writing its own
``checkpoint_dir``.
"""

from __future__ import annotations

import logging
import time

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
    predict_program,
    program_call,
    resolve_device,
    resolve_weights,
    stack_members,
    tree_map,
)
from spark_ensemble_tpu_torch.models.gbm import _check_resume_args, _concat
from spark_ensemble_tpu_torch.ops.collective import pairwise_sum, pmax_reduce, preduce
from spark_ensemble_tpu_torch.parallel.mesh import CheckpointBlocks
from spark_ensemble_tpu_torch.telemetry.events import FitTelemetry
from spark_ensemble_tpu_torch.utils.instrumentation import instrumented_fit
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
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
    return None if members is None else tree_map(lambda a: a[:m], members)


def _samme_update(w_norm, pred, y, k, ax=None):
    """SAMME's round statistics from the member's class predictions ->
    (err, est_weight, new_bw); shared by the fit and ``fit_resume``'s
    replay, so both take the same f32 steps.  Under a mesh the error is
    reduced over the row axis ``ax``."""
    miss = (pred != y).to(torch.float32)
    err = preduce(torch.sum(w_norm * miss), ax)
    beta = err / torch.clamp((1.0 - err) * (k - 1.0), min=1e-30)
    inv = 1.0 / torch.maximum(beta, _f32(1e-300, y))
    est_weight = torch.where(beta == 0.0, _f32(1.0, y), torch.log(inv))
    return err, est_weight, w_norm * torch.pow(inv, miss)


def _samme_r_update(w_norm, proba, y_int, codes, k, ax=None):
    """SAMME.R's round statistics from the member's class probabilities
    -> (err, new_bw)."""
    miss = (torch.argmax(proba, dim=-1) != y_int).to(torch.float32)
    err = preduce(torch.sum(w_norm * miss), ax)
    ll = torch.sum(codes * torch.log(torch.clamp(proba, min=EPSILON)), dim=-1)
    return err, w_norm * torch.exp(-((k - 1.0) / k) * ll)


def _drucker_update(w_norm, pred, y, loss_name, valid=None, ax=None):
    """Drucker R2's round statistics from the member's predictions ->
    (max_error, est_err, est_weight, new_bw).  Under a mesh ``valid``
    masks the padding rows out of ``maxError`` (a padded row's error means
    nothing), which is the max over the ranks, and ``estErr`` is reduced."""
    errors = torch.abs(y - pred)
    if valid is not None:
        errors = valid * errors
    max_error = pmax_reduce(torch.max(errors), ax)
    rel = torch.where(
        max_error > 0, errors / torch.clamp(max_error, min=1e-30), errors
    )
    if loss_name == "exponential":
        losses = 1.0 - torch.exp(-rel)
    elif loss_name == "squared":
        losses = rel * rel
    else:
        losses = rel
    est_err = preduce(torch.sum(w_norm * losses), ax)
    beta = est_err / torch.clamp(1.0 - est_err, min=1e-30)
    floor = torch.maximum(beta, _f32(1e-300, y))
    est_weight = torch.where(beta == 0.0, _f32(1.0, y), torch.log(1.0 / floor))
    new_bw = w_norm * torch.pow(floor, 1.0 - losses)
    new_bw = torch.where(beta == 0.0, torch.zeros_like(new_bw), new_bw)
    return max_error, est_err, est_weight, new_bw


def _normalized(bw, ax=None):
    return bw / torch.clamp(preduce(torch.sum(bw), ax), min=1e-30)


class _BoostingParams(CheckpointableParams, Estimator):
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
        doc="max rounds per chunk; the data-dependent aborts (SAMME err >= "
        "1-1/K, Drucker est_err >= 0.5, zero weight mass, perfect fit) are "
        "replayed on the host after each chunk, so rounds past a stop are "
        "dropped and no result depends on it",
    )
    ramp = Param(
        "auto", in_array(["auto", "off"]),
        doc="chunk schedule of the abort-prone flavors (SAMME, Drucker): "
        "'auto' runs a one-round probe chunk first, then full chunks; 'off' "
        "always runs full chunks.  SAMME.R never probes",
    )
    checkpoint_interval = Param(
        10, gt_eq(1), doc="rounds between training-state checkpoints"
    )
    checkpoint_dir = Param(
        None,
        doc="when set, training state (round, members, boosting weights) is "
        "checkpointed every checkpoint_interval rounds and fit() resumes "
        "from the latest checkpoint",
    )
    aggregation_depth = Param(2, gt_eq(1), doc="API parity; reductions are sums")
    seed = Param(0, doc="PRNG seed of the round keys")

    def _prepare(self, X, y, sample_weight, mesh, device):
        dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        X, y = as_f32(X, dev), as_f32(y, dev)
        self._validate_fit_inputs(X, y)
        return dev, X, y, resolve_weights(y, sample_weight)

    @staticmethod
    def _shard(mesh, base, ctx, X, y, w):
        """This rank's rows under a mesh -> ``(ctx, X, y, w, valid, ax)``
        (all whole and ``ax`` None without one)."""
        if mesh is None:
            return ctx, X, y, w, None, None
        from spark_ensemble_tpu_torch.parallel.mesh import setup_row_sharding

        ctx, X, ax, _, (y, w, valid) = setup_row_sharding(
            mesh, base, ctx, X, y.shape[0], (y, w, torch.ones_like(y)))
        return ctx, X, y, w, valid, ax

    def _round_keys(self, device):
        """Every round's key ``fold_in(PRNGKey(seed), i)``, in one hash."""
        m = int(self.num_base_learners)
        return fold_in(PRNGKey(self.seed, device), torch.arange(m, device=device))

    def _checkpoint(self, dev, mesh, n, d, *parts, telem):
        """The fit's checkpointer and its carry blocks: under a mesh a
        checkpoint holds the global padded ``bw`` (``n_pad`` enters the
        fingerprint; ``parallel/mesh.CheckpointBlocks``)."""
        blocks = CheckpointBlocks(mesh, n)
        ckpt = self._checkpointer(dev, n, d, *parts, blocks.n_pad, telem=telem,
                                  axis=blocks.axis)
        return ckpt, blocks

    def _resume(self, ckpt, bw, telem, blocks):
        """The loaded checkpoint or warm-resume state -> ``(start round,
        bw, chunks)``; a fresh fit starts at round 0 from ``bw``."""
        chunks = {"members": [], "weights": []}
        resumed = self._load_resume(ckpt, telem, blocks.axis)
        if resumed is None:
            return 0, bw, chunks
        last_round, st = resumed
        chunks["members"], chunks["weights"] = self._resume_chunks(
            st, weights_key="est_weights")
        logger.info("%s resuming from round %d", type(self).__name__,
                    last_round + 1)
        return last_round + 1, blocks.own(st["bw"].to(bw.device)), chunks

    def _drive_boosting_rounds(self, ckpt, bw, chunks, run_chunk, replay,
                               start_i: int, ramp: bool, guard, telem,
                               ax=None, *, blocks) -> int:
        """The chunked round loop of both Boosting flavors, behind the
        port's :class:`RoundExecutor` (the JAX package's
        ``_drive_boosting_rounds``).  ``run_chunk(i0, c, bw) -> (params
        [c, ...], est_ws f32[c], sum_bws f32[c], bw, extras)`` runs rounds
        ``i0 .. i0+c`` from the boosting weights ``bw``; ``replay(extras,
        sum_bws, c, i) -> (kept, stop)`` applies the flavor's stopping
        rules to a chunk's host values.  Committing a chunk reads its
        finite flags, stats and weight masses in one host transfer; kept
        rounds append to ``chunks``; a save round writes a checkpoint.

        Robustness: each chunk runs under the retry layer, and a guard hit
        rewinds ``bw`` to the chunk start and replays the clean prefix
        (same absolute round keys, same rounds).  A poisoned member is
        dropped on ``skip_round`` (SAMME.R ignores estimator weights, so a
        zero-weight member would still vote), and ``halve_step`` degrades
        to ``skip_round`` (a Boosting round has no scalable step).

        ``ramp``: the abort-prone flavors (SAMME, Drucker R2) run a
        one-round probe chunk first, committed alone, then full chunks: an
        abort on round 0, the common case, then wastes nothing.  Returns
        the final round count."""
        from spark_ensemble_tpu_torch.robustness.chaos import controller
        from spark_ensemble_tpu_torch.robustness.retry import retry_call

        ctl = controller()
        retry_policy = self._retry_policy()
        label = type(self).__name__
        guard_on = guard.active
        chunk = int(self.scan_chunk)
        depth = _execution.resolve_pipeline_depth()
        probe = ramp and self.ramp == "auto" and start_i == 0

        # a chunk is one call of the JAX package's chunk program; a
        # committed chunk's call joins its round_end events
        tag = "boosting_cls_chunk" if self.is_classifier else "boosting_reg_chunk"
        programs = {}  # chunk start -> its program call, until committed

        def dispatch(i0, c, bw_in):
            site = f"{label}:round:{i0}"

            def attempt():
                ctl.transient(site)
                with program_call(tag, bw_in, c, self) as call:
                    out = run_chunk(i0, c, bw_in)
                programs[i0] = call
                return out

            params_c, est_ws, sum_bws, bw_out, extras = retry_call(
                attempt, policy=retry_policy, op=f"{label}.round_chunk",
                telem=telem,
            )
            return (ctl.poison_member_stack(site, params_c), est_ws, sum_bws,
                    bw_out, extras)

        def read(params_c, est_ws, sum_bws, extras):
            """One host read -> (first bad round | None, sum_bws, extras)."""
            ex = list(extras) if isinstance(extras, tuple) else [extras]
            c = est_ws.shape[0]
            parts = [sum_bws.to(torch.float32)] + [e.to(torch.float32) for e in ex]
            if guard_on:
                parts.append(guard.flags(params_c, est_ws, sum_bws, *ex)
                             .to(torch.float32))
            host = torch.cat(parts).tolist()
            rows = [host[j * c:(j + 1) * c] for j in range(len(parts))]
            bad = None
            if guard_on:
                bad = next((j for j, f in enumerate(rows.pop()) if f), None)
            ex_host = tuple(rows[1:]) if isinstance(extras, tuple) else rows[1]
            return bad, rows[0], ex_host

        def commit_chunk(i, c, bw_prev, t_chunk, params_c, est_ws, sum_bws,
                         bw_out, extras):
            """One launched chunk's bookkeeping (guard scan, abort replay,
            telemetry, append, gated save, preemption point) -> (i, bw,
            stop, rewound)."""
            bw = bw_out
            stop = halt = rewound = False
            skip_after = 0  # a guard-dropped round: its index, no member
            if telem.enabled:
                # host-blocked accounting: the read this commit waits on
                telem.blocking_read((params_c, est_ws, sum_bws, extras))
            bad, sum_h, ex_h = read(params_c, est_ws, sum_bws, extras)
            if bad is not None:
                rewound = True
                if guard.policy == "raise":
                    guard.raise_error(i + bad)
                action = "stop_early" if guard.policy == "stop_early" else "skip_round"
                extra = ({"degraded_from": "halve_step"}
                         if guard.policy == "halve_step" else {})
                guard.record(i + bad, action, member_dropped=True, **extra)
                # rewind to the chunk-start weights and replay the clean
                # prefix (same keys -> same rounds)
                bw, c = bw_prev, bad
                if c > 0:
                    params_c, est_ws, sum_bws, bw, extras = dispatch(i, c, bw)
                    _, sum_h, ex_h = read(params_c, est_ws, sum_bws, extras)
                if action == "stop_early":
                    halt = True
                else:
                    skip_after = 1
            if c > 0:
                kept, stop = replay(ex_h, sum_h, c, i)
                if telem.enabled:
                    # the classifier's stats are its per-round errors,
                    # Drucker's (max_errs, est_errs): the estimator error
                    # is the loss
                    losses = ex_h[1] if isinstance(ex_h, tuple) else ex_h
                    telem.round_chunk(
                        i, kept, t_chunk, fence=(params_c, est_ws),
                        losses=losses[:kept],
                        step_sizes=est_ws[:kept] if kept > 0 else None,
                        divisor=c, program=programs.pop(i, None),
                    )
                if not stop:
                    # the loop guard of the next round: weight mass after
                    # this chunk's last kept round stays positive
                    stop = sum_h[c - 1] <= 0
                if kept > 0:
                    chunks["members"].append(tree_map(lambda a: a[:kept], params_c))
                    chunks["weights"].append(est_ws[:kept])
                i += kept
            stop = stop or halt
            if not stop:
                i += skip_after
            if not stop and i > start_i and ckpt.should_save(i - 1):
                ckpt.save(i - 1, {
                    "bw": blocks.whole(bw),
                    "members_layout": self.MEMBERS_LAYOUT,
                    "members": _concat(chunks["members"]),
                    "est_weights": torch.cat(chunks["weights"]),
                })
            if not stop:
                ctl.preempt(f"{label}:after_round:{i}")
                if self._is_refresh_fit:
                    # refresh-only kill site: a warm-start refresh fit dies
                    # mid-fit, and the served model must stay untouched
                    ctl.refresh_crash(f"{label}:refresh_round:{i}")
            return i, bw, stop, rewound

        drv = self

        class _Adapter(_execution.RoundAdapter):
            """Chunk ``j+1`` is launched on chunk ``j``'s weight tensor
            before any host read of chunk ``j``; an abort, a guard rewind or
            a weight-mass stop drops everything in flight."""

            def __init__(self):
                self.depth = depth
                self.telem = telem  # the executor traces chunk spans
                self.i, self.bw = start_i, bw
                self.stop = float(preduce(torch.sum(bw), ax)) <= 0
                self.i_disp, self.bw_frontier = start_i, bw
                self.cur = 1 if probe else chunk
                self.probe_pending = probe

            def should_continue(self):
                return self.i < drv.num_base_learners and not self.stop

            def can_launch(self):
                return self.i_disp < drv.num_base_learners

            def window(self):
                return 1 if self.probe_pending else self.depth + 1

            def launch(self):
                c = min(self.cur, drv.num_base_learners - self.i_disp)
                self.cur = chunk
                if ckpt.enabled:
                    c = min(c, ckpt.rounds_until_save(self.i_disp))
                bw_prev = self.bw_frontier
                t0 = time.perf_counter()
                out = dispatch(self.i_disp, c, bw_prev)
                entry = (self.i_disp, c, bw_prev, t0) + out
                self.i_disp += c
                self.bw_frontier = out[3]
                return entry

            def commit(self, entry, speculated):
                self.probe_pending = False
                self.i, self.bw, self.stop, rewound = commit_chunk(*entry)
                return rewound or self.stop

            def reset_frontier(self):
                self.i_disp, self.bw_frontier = self.i, self.bw

            def finish(self):
                ckpt.wait()

        try:
            return _execution.RoundExecutor(_Adapter()).run().i
        except BaseException:
            ckpt.abandon()
            raise

    def _model_params(self, chunks, dev):
        return {
            "members": _concat(chunks["members"]),
            "weights": (torch.cat(chunks["weights"]) if chunks["weights"]
                        else torch.zeros((0,), dtype=torch.float32, device=dev)),
        }

    @staticmethod
    def _rounds(run_round, keys, c_extras, ax=None):
        """A chunk runner over ``run_round(bw, key) -> (params, est_weight,
        new_bw, stats)``: rounds ``i0 .. i0+c`` one after another, their
        outputs stacked, ``c_extras(stats list) -> extras``; each round's
        weight mass reduced over ``ax`` under a mesh."""

        def run_chunk(i0, c, bw):
            params_l, est_l, sums_l, stats_l = [], [], [], []
            for r in range(i0, i0 + c):
                params, est_weight, bw, stats = run_round(bw, keys[r])
                params_l.append(params)
                est_l.append(est_weight)
                sums_l.append(preduce(torch.sum(bw), ax))
                stats_l.append(stats)
            return (stack_members(params_l), torch.stack(est_l),
                    torch.stack(sums_l), bw, c_extras(stats_l))

        return run_chunk


class BoostingClassifier(_BoostingParams):
    algorithm = Param(
        "discrete", in_array(["discrete", "real"]),
        doc="'discrete' = SAMME (class votes), 'real' = SAMME.R "
        "(probability-weighted log-odds votes)",
    )

    is_classifier = True

    def _base(self) -> BaseLearner:
        return self.base_learner or DecisionTreeClassifier()

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, num_classes=None, mesh=None,
            device="cuda") -> "BoostingClassificationModel":
        dev, X, y, w = self._prepare(X, y, sample_weight, mesh, device)
        k = infer_num_classes(y, num_classes)
        n, d = X.shape
        telem = FitTelemetry.start(self, n=n, d=d, num_classes=int(k), mesh=mesh)
        base = self._base().copy()
        ctx = make_shared_fit_ctx(base, X, k)
        ctx, X, y, w, _, ax = self._shard(mesh, base, ctx, X, y, w)
        real = self.algorithm.lower() == "real"
        y_int = y.to(torch.int64)
        codes = _samme_r_codes(y_int, k)

        def run_round(bw, round_key):
            w_norm = _normalized(bw, ax)
            if real:
                params, proba = base.fit_and_proba(ctx, y, w_norm, None, X,
                                                   key=round_key, axis_name=ax)
                err, new_bw = _samme_r_update(w_norm, proba, y_int, codes, k, ax)
                est_weight = _f32(1.0, y)
            else:
                params, pred = base.fit_and_direction(ctx, y, w_norm, None, X,
                                                      key=round_key, axis_name=ax)
                err, est_weight, new_bw = _samme_update(w_norm, pred, y, k, ax)
            return params, est_weight, new_bw, err

        def replay(errs, sum_bws, c, i):
            """The per-round stopping rules over a chunk's host values ->
            (rounds kept, stop); rounds past a stop never ran in the
            sequential loop and are dropped."""
            kept = 0
            for j in range(c):
                if j > 0 and sum_bws[j - 1] <= 0:
                    return kept, True  # the loop guard: weight mass 0
                err = errs[j]
                if not real and err >= 1.0 - 1.0 / k:
                    logger.info("BoostingClassifier round %d aborted: err=%.4f",
                                i + j, err)
                    return kept, True  # abort the round, drop its model
                kept = j + 1
                logger.info("BoostingClassifier round %d: err=%.4f", i + j, err)
                if err <= 0:
                    return kept, True
            return kept, False

        ckpt, blocks = self._checkpoint(dev, mesh, n, d, k, telem=telem)
        start_i, bw, chunks = self._resume(ckpt, w, telem, blocks)
        run_chunk = self._rounds(run_round, self._round_keys(dev), torch.stack, ax)
        guard = self._numeric_guard(telem)
        telem.phase_mark("setup")
        self._drive_boosting_rounds(ckpt, bw, chunks, run_chunk, replay,
                                    start_i, ramp=not real, guard=guard,
                                    telem=telem, ax=ax, blocks=blocks)
        ckpt.delete()
        params = self._model_params(chunks, dev)
        model = _with_guard_events(guard, BoostingClassificationModel(
            params=params, num_features=d, num_classes=k,
            num_members=params["weights"].shape[0], device=dev,
            **self.get_params(),
        ))
        telem.finish(model=model, members=model.num_members)
        return model


def _samme_r_codes(y_int, k):
    return torch.where(
        torch.nn.functional.one_hot(y_int, k) > 0,
        _f32(1.0, y_int), _f32(-1.0 / (k - 1.0), y_int),
    )


class BoostingClassificationModel(ClassificationModel, BoostingClassifier):
    def __init__(self, num_members=0, **kwargs):
        super().__init__(**kwargs)
        self.num_members = num_members

    @predict_program("raw")
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
            # members summed by the fixed pairwise tree: a row's raw score
            # does not depend on how many rows share the call
            return (k - 1.0) * pairwise_sum(decisions)
        preds = base.predict_many_fn(members, X).to(torch.int64)
        onehot = torch.nn.functional.one_hot(preds, k)
        votes = torch.where(onehot > 0, _f32(1.0, X), _f32(-1.0 / (k - 1.0), X))
        return pairwise_sum(self.params["weights"][:, None, None] * votes)

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

    def fit_resume(self, X, y, n_new_rounds, sample_weight=None, device=None):
        """Continue this SAMME ensemble for ``n_new_rounds`` more rounds on
        the same training data: bit-identical to one longer fit, since
        round keys derive from absolute round indices and the
        boosting-weight carry replays over the stored members by the
        round's own update.  A fit that stopped converged (its last round's
        error is 0) is its own continuation: it comes back unchanged."""
        k, n_new = int(self.num_members), int(n_new_rounds)
        _check_resume_args(self, k, n_new, X)
        dev = resolve_device(device if device is not None else self.device)
        X32, y32 = as_f32(X, dev), as_f32(y, dev)
        base = self._base().copy()
        members = tree_map(lambda a: a.to(dev), self.params["members"])
        real, nc = self.algorithm.lower() == "real", int(self.num_classes)
        y_int = y32.to(torch.int64)
        codes = _samme_r_codes(y_int, nc)
        bw = resolve_weights(y32, sample_weight)
        for r in range(k):
            member = tree_map(lambda a: a[r], members)
            w_norm = _normalized(bw)
            if real:
                err, bw = _samme_r_update(
                    w_norm, base.predict_proba_fn(member, X32), y_int, codes, nc)
            else:
                err, _, bw = _samme_update(
                    w_norm, base.predict_fn(member, X32), y32, nc)
        if float(err) <= 0.0:
            return self
        est = BoostingClassifier(**{**self.get_params(), "num_base_learners": k + n_new})
        est._set_warm_resume(k - 1, {
            "bw": bw,
            "members_layout": self.MEMBERS_LAYOUT,
            "members": members,
            "est_weights": self.params["weights"].to(dev, torch.float32),
        })
        return est.fit(X, y, sample_weight=sample_weight, num_classes=nc,
                       device=dev)


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
    def _replay(extras, sum_bws, c, i):
        """Drucker's stopping rules over a chunk's host values -> (rounds
        kept, stop)."""
        max_errs, est_errs = extras
        kept = 0
        for j in range(c):
            if j > 0 and sum_bws[j - 1] <= 0:
                return kept, True
            if max_errs[j] == 0.0:
                # degenerate perfect fit: keep the round, stop
                logger.info("BoostingRegressor round %d: maxError=0, stopping",
                            i + j)
                return j + 1, True
            if est_errs[j] >= 0.5:
                logger.info("BoostingRegressor round %d dropped: est_err=%.4f",
                            i + j, est_errs[j])
                return kept, True  # drop the round and stop
            kept = j + 1
            logger.info("BoostingRegressor round %d: est_err=%.4f", i + j,
                        est_errs[j])
        return kept, False

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, mesh=None,
            device="cuda") -> "BoostingRegressionModel":
        dev, X, y, w = self._prepare(X, y, sample_weight, mesh, device)
        n, d = X.shape
        telem = FitTelemetry.start(self, n=n, d=d, mesh=mesh)
        base = self._base().copy()
        ctx = make_shared_fit_ctx(base, X)
        ctx, X, y, w, valid, ax = self._shard(mesh, base, ctx, X, y, w)
        loss_name = self.loss.lower()

        def run_round(bw, round_key):
            w_norm = _normalized(bw, ax)
            params, pred = base.fit_and_direction(ctx, y, w_norm, None, X,
                                                  key=round_key, axis_name=ax)
            max_error, est_err, est_weight, new_bw = _drucker_update(
                w_norm, pred, y, loss_name, valid, ax)
            return params, est_weight, new_bw, (max_error, est_err)

        def extras(stats):
            return (torch.stack([s[0] for s in stats]),
                    torch.stack([s[1] for s in stats]))

        ckpt, blocks = self._checkpoint(dev, mesh, n, d, telem=telem)
        start_i, bw, chunks = self._resume(ckpt, w, telem, blocks)
        run_chunk = self._rounds(run_round, self._round_keys(dev), extras, ax)
        guard = self._numeric_guard(telem)
        telem.phase_mark("setup")
        self._drive_boosting_rounds(ckpt, bw, chunks, run_chunk,
                                    self._replay, start_i, ramp=True,
                                    guard=guard, telem=telem, ax=ax,
                                    blocks=blocks)
        ckpt.delete()
        params = self._model_params(chunks, dev)
        model = _with_guard_events(guard, BoostingRegressionModel(
            params=params, num_features=d,
            num_members=params["weights"].shape[0], device=dev,
            **self.get_params(),
        ))
        telem.finish(model=model, members=model.num_members)
        return model


class BoostingRegressionModel(RegressionModel, BoostingRegressor):
    def __init__(self, num_members=0, **kwargs):
        super().__init__(**kwargs)
        self.num_members = num_members

    def member_predictions(self, X):
        """Per-member predictions ``f32[m, n]``."""
        return self._base().predict_many_fn(self.params["members"], self._input(X))

    @predict_program("members")
    def predict(self, X):
        X = self._input(X)
        if self.num_members == 0:
            return torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
        preds = self.member_predictions(X)
        weights = self.params["weights"]
        if self.voting_strategy.lower() == "mean":
            return pairwise_sum(weights[:, None] * preds) / torch.clamp(
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

    def fit_resume(self, X, y, n_new_rounds, sample_weight=None, device=None):
        """Continue this Drucker ensemble for ``n_new_rounds`` more rounds
        on the same training data, bit-identical to one longer fit (see
        :meth:`BoostingClassificationModel.fit_resume`)."""
        k, n_new = int(self.num_members), int(n_new_rounds)
        _check_resume_args(self, k, n_new, X)
        dev = resolve_device(device if device is not None else self.device)
        X32, y32 = as_f32(X, dev), as_f32(y, dev)
        base = self._base().copy()
        members = tree_map(lambda a: a.to(dev), self.params["members"])
        bw = resolve_weights(y32, sample_weight)
        for r in range(k):
            pred = base.predict_fn(tree_map(lambda a: a[r], members), X32)
            bw = _drucker_update(_normalized(bw), pred, y32, self.loss.lower())[3]
        est = BoostingRegressor(**{**self.get_params(), "num_base_learners": k + n_new})
        est._set_warm_resume(k - 1, {
            "bw": bw,
            "members_layout": self.MEMBERS_LAYOUT,
            "members": members,
            "est_weights": self.params["weights"].to(dev, torch.float32),
        })
        return est.fit(X, y, sample_weight=sample_weight, device=dev)
