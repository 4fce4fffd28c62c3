"""Megabatch sweep: fit a whole hyperparameter sweep of GBM candidates in
lockstep, each round's trees for every candidate in ONE forest fit
(PyTorch port of ``models/gbm_sweep.py``).

The tuners (``tuning.py``) fit ``maps x folds`` candidates that share the
binned feature matrix and differ only in per-candidate values: learning
rate, seed, subsample and subspace draws, round count, patience, and the
fold's zero-weight mask.  The JAX package ``vmap``s its round program over
a leading candidate axis.  The port's kernels are called through ctypes,
which ``vmap`` cannot batch, so here the candidate axis folds into the
forest fit's member axis: a slab of S candidates ("lanes") of K members
each (K = the class dims of a classifier, 1 for a regressor) fits as one
forest of M = S * K members, with ``fit_forest(..., lanes=S)``.  Every
kernel then sums each lane's rows in the order its own K-member fit takes
(``ops/hist_kernels.py``), so one round launches the fused tier's 5
histogram, 4 route and 1 leaf kernels for all S candidates.

What is per lane runs per lane, on the lane's own tensors and with the
sequential fit's own code (``make_reg_round_core``/``make_cls_round_core``:
``targets``, ``step``, ``step_problem``): pseudo-residuals, the line
search's objectives, the prediction update and validation.  The
classifier's projected Newton searches run together
(``projected_newton_box_lanes``), one host read per iteration for every
lane.  So each candidate's members, weights, validation history and
early-stop round are bit-identical to its own ``fit``.

Each lane has its own learning rate, draws, round count and patience.  A
lane that has stopped (its patience ran out, or it has fewer rounds) rides
the remaining rounds at scale 0, and its trailing members are trimmed by
the sequential fit's ``keep = i - v`` rule.  Base learners other than the
histogram trees fit lane by lane inside the lockstep round.  Gradient
sampling (``sampling`` goss/mvs) and linear leaves have no swept round and
stay sequential, as in the JAX package (``sweep_unsupported_reason``).
Slabs hold at most ``configs_per_dispatch`` lanes (the tunable; 32,
``_CONFIGS_PER_DISPATCH``, unless tuned); a short last slab is
not padded (the JAX package pads it to keep one compiled program shape,
which eager launches do not need).

With ``mesh`` the config axis shards over the mesh's "member" axis
(``_config_axis``): member rank ``m`` fits the ``m``-th contiguous block of
each slab's lanes on the whole rows, and the fitted lanes are gathered so
that every rank returns every model.  Each lane's sums run on its own
columns, so a lane fitted in a block equals its lane of the unsharded
sweep bit for bit.  A member axis of one rank, or one that does not divide
the slab, runs the unsharded sweep on every rank.

Telemetry: the sweep is one fit on the stream (family
``GBMSweep[<estimator>]``, with ``candidates``), each lockstep round a
``sweep_chunk`` event (its fenced wall time over the lanes live in it),
and every candidate model carries the shared ``drift_ref_`` and an empty
``fit_history_`` (per-candidate rounds do not exist inside a lockstep
round), as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence

import torch

from spark_ensemble_tpu_torch.autotune.resolve import resolve as _tuned
from spark_ensemble_tpu_torch.models.base import (
    as_f32,
    infer_num_classes,
    make_shared_fit_ctx,
    mesh_device,
    program_call,
    resolve_device,
    resolve_weights,
    stack_members,
    tree_map,
)
from spark_ensemble_tpu_torch.models.gbm import (
    GBMClassifier,
    GBMRegressor,
    _fitted_values,
    _make_reg_loss,
    _split_validation,
    alpha_carry,
    make_cls_round_core,
    make_reg_round_core,
)
from spark_ensemble_tpu_torch.models.tree import _TreeLearner
from spark_ensemble_tpu_torch.ops.collective import (
    gather_objects,
    model_bytes,
    model_from_bytes,
)
from spark_ensemble_tpu_torch.ops.linesearch import projected_newton_box_lanes
from spark_ensemble_tpu_torch.ops.tree import leaf_values_at
from spark_ensemble_tpu_torch.telemetry.events import FitTelemetry, empty_history
from spark_ensemble_tpu_torch.telemetry.quality import drift_reference_from_ctx
from spark_ensemble_tpu_torch.utils.quantile import weighted_quantile

#: lanes per slab (the ``configs_per_dispatch`` tunable's default)
_CONFIGS_PER_DISPATCH = 32

#: params that may differ within one swept group: per-lane values the
#: lockstep round reads (learning_rate), draws (seed, subsample_ratio,
#: subspace_ratio), or host bookkeeping (round counts, patience)
SWEEP_BATCHED_PARAMS = (
    "learning_rate",
    "seed",
    "subsample_ratio",
    "subspace_ratio",
    "num_base_learners",
    "num_rounds",
    "validation_tol",
)


def sweep_group_key(estimator) -> tuple:
    """Structural fingerprint of a candidate: its ``config_key`` with every
    batchable param pinned to a sentinel value.  Candidates with equal
    group keys sweep together; a grid that also varies structural params
    (loss, depth, base learner, ...) splits into one sweep per group."""
    return estimator.copy(
        learning_rate=1.0,
        seed=0,
        subsample_ratio=1.0,
        subspace_ratio=1.0,
        num_base_learners=1,
        num_rounds=1,
        validation_tol=0.01,
    ).config_key()


def sweep_unsupported_reason(estimator, mesh=None) -> Optional[str]:
    """Why this estimator cannot ride the megabatch sweep (None = it can).
    The tuners fall back to sequential fits on a reason under
    ``megabatch="auto"`` and raise it under ``megabatch="on"``."""
    if not isinstance(estimator, (GBMRegressor, GBMClassifier)):
        return (
            f"{type(estimator).__name__} has no megabatch sweep support "
            "(GBMRegressor/GBMClassifier only)"
        )
    if estimator.checkpoint_dir:
        return "checkpoint_dir is set (sweep candidates are not checkpointable)"
    if estimator.profile_dir:
        return "profile_dir is set (per-candidate profiling needs sequential fits)"
    if estimator.on_nonfinite not in ("raise", "off"):
        return (
            f"on_nonfinite={estimator.on_nonfinite!r} needs the sequential "
            "recovery driver (sweeps support 'raise'/'off' only)"
        )
    if str(estimator.sampling).lower() != "none":
        return (
            f"sampling={estimator.sampling!r} compacts rows per round "
            "(models/gbm.py GOSS/MVS) and has no megabatch round core yet"
        )
    if str(estimator.leaf_model).lower() == "linear":
        return (
            "leaf_model='linear' fits ridge leaves outside the fused "
            "forest kernel and has no megabatch round core yet"
        )
    return None


class _Lane:
    """One candidate's state in the lockstep round loop."""

    def __init__(self, est, w, sample, masks, bag_keys, samp_keys):
        self.est = est
        self.w = w
        self.sample = sample
        self.masks = masks
        self.bag_keys = bag_keys
        self.samp_keys = samp_keys
        self.m = int(est.num_base_learners)
        self.lr = float(est.learning_rate)
        self.patience = int(est.num_rounds)
        self.val_tol = float(est.validation_tol)
        self.members: List[Any] = []
        self.weights: List[torch.Tensor] = []
        self.val_hist: List[float] = []
        self.deltas: List[torch.Tensor] = []
        self.i = 0
        self.v = 0
        self.best = 0.0

    @property
    def active(self) -> bool:
        return self.i < self.m and self.v < self.patience

    def draws(self, r):
        """Round ``r``'s bag weights, mask and keys; a lane past its round
        count repeats its last round's (it rides at scale 0)."""
        j = min(r, self.m - 1)
        bag_w, mask = self.sample(j)
        return bag_w, mask, self.bag_keys[j], self.samp_keys[j]


def _lane_masks(masks, K, d, device):
    """Per-lane feature masks -> one ``[S * K, d]`` member mask (None when
    no lane draws a subspace)."""
    if all(m is None for m in masks):
        return None
    full = [torch.ones((d,), dtype=torch.bool, device=device) if m is None else m
            for m in masks]
    return torch.stack(full).repeat_interleave(K, dim=0)


def _swept_forest(base, ctx, labels, fit_ws, masks, X, keys, K):
    """Every lane's round fit -> ``(per-lane params, per-lane directions
    [n, K] or [n])``.  Histogram trees fit all lanes in one forest
    (``lanes=S``); other learners fit lane by lane with the sequential
    fit's own call."""
    S = len(labels)
    single = labels[0].dim() == 1  # a regressor: one tree per lane
    if isinstance(base, _TreeLearner) and not base.leaf_params:
        ys = torch.stack(labels, dim=1) if single else torch.cat(labels, dim=1)
        ws = torch.stack(fit_ws, dim=1) if single else torch.cat(fit_ws, dim=1)
        d = X.shape[1]
        fit_base = base
        if single and base.hist_precision.lower() == "pallas" and base.hist.lower() != "fused":
            # a single tree at "pallas" runs the 'high' tier (fit_tree)
            fit_base = base.copy(hist_precision="high")
        trees, node = fit_base.fit_many_from_ctx(
            ctx, ys.contiguous(), ws.contiguous(), _lane_masks(masks, K, d, X.device),
            return_leaf=True, lanes=S,
        )
        dirs = base._direction_from_leaf(leaf_values_at(trees, node))
        if single:
            return ([tree_map(lambda a: a[s], trees) for s in range(S)],
                    [dirs[:, s].contiguous() for s in range(S)])
        return ([tree_map(lambda a: a[s * K:(s + 1) * K], trees) for s in range(S)],
                [dirs[:, s * K:(s + 1) * K].contiguous() for s in range(S)])
    out = [
        base.fit_and_direction(ctx, lab, fw, mask, X, key=key) if single
        else base.fit_many_and_directions(ctx, lab, fw, mask, X, keys=key)
        for lab, fw, mask, key in zip(labels, fit_ws, masks, keys)
    ]
    return [p for p, _ in out], [dr for _, dr in out]


def _check_finite(live, weights, params, r, label):
    """The numeric guard over the round's live lanes, in one host read."""
    flags = torch.stack([
        torch.stack([torch.isfinite(t).all() for t in [w, *_fitted_values(p)]]).all()
        for w, p in zip(weights, params)
    ]).tolist()
    for on, ok in zip(live, flags):
        if on and not ok:
            raise FloatingPointError(
                f"{label} round {r} produced non-finite member params or "
                "step sizes (on_nonfinite='raise')"
            )


def _stacked(lane):
    """A lane's round-stacked members and weights (None before round 0)."""
    if not lane.members:
        return None, None
    return stack_members(lane.members), torch.stack(lane.weights)


def _commit(lanes, live, params, weights, errs=None):
    """The round's members of the lanes live at its start, and their
    validation losses (one host read for all) into the patience
    bookkeeping of the sequential fit (``_patience_step``); a stopped
    lane's round is dropped."""
    for lane, on, p, w in zip(lanes, live, params, weights):
        if on:
            lane.members.append(p)
            lane.weights.append(w)
            lane.i += 1
    if errs is None:
        return
    values = torch.stack(errs).tolist()
    for lane, on, err in zip(lanes, live, values):
        if on:
            lane.val_hist.append(err)
            lane.best, lane.v = lane.est._patience_step(
                lane.best, err, lane.v, lane.val_tol)


def _emit_sweep_round(telem, r, live, t0, fence):
    """One lockstep round as a ``sweep_chunk`` event: fence on its outputs,
    then charge its wall time to the lanes live in it."""
    if not telem.enabled:
        return
    telem.blocking_read(fence)
    wall = time.perf_counter() - t0
    active = int(sum(live))
    telem.emit(
        "sweep_chunk",
        start_round=r,
        rounds=1,
        candidates=len(live),
        active_lane_rounds=active,
        wall_s=wall,
        per_candidate_round_s=wall / max(1, active),
    )


def _scaled(on, weight):
    # a stopped lane rides the round at scale 0
    return weight if on else weight * 0.0


def fit_sweep(
    estimators: Sequence[Any],
    X,
    y,
    sample_weights: Optional[Sequence[Any]] = None,
    num_classes: Optional[int] = None,
    validation_indicator=None,
    mesh=None,
    telemetry_path: Optional[str] = None,
    device="cuda",
) -> List[Any]:
    """Fit every candidate estimator on the SAME feature matrix in
    lockstep rounds; returns fitted models in candidate order, each
    bit-identical to ``estimators[b].fit(X, y,
    sample_weight=sample_weights[b], ...)``.

    Candidates must share every structural param (``sweep_group_key``);
    they may differ in ``SWEEP_BATCHED_PARAMS``.  ``sample_weights`` is one
    weight vector per candidate (the tuners' zero-weight fold masks), or
    None for unit weights everywhere."""
    ests = list(estimators)
    if not ests:
        return []
    est0 = ests[0]
    reason = sweep_unsupported_reason(est0, mesh)
    if reason is not None:
        raise ValueError(f"fit_sweep: {reason}")
    gk = sweep_group_key(est0)
    for est in ests[1:]:
        if sweep_group_key(est) != gk:
            raise ValueError(
                "fit_sweep candidates must share every structural param; "
                "only " + ", ".join(SWEEP_BATCHED_PARAMS) + " may differ "
                "within one batch (group structurally-distinct candidates "
                "with sweep_group_key)"
            )
    B = len(ests)
    dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
    X, y = as_f32(X, dev), as_f32(y, dev)
    est0._validate_fit_inputs(X, y)
    if sample_weights is None:
        sample_weights = [None] * B
    if len(sample_weights) != B:
        raise ValueError(
            f"sample_weights must have one entry per candidate "
            f"({B}); got {len(sample_weights)}"
        )
    w_full = [resolve_weights(y, sw) for sw in sample_weights]
    splits = [_split_validation(X, y, wb, validation_indicator) for wb in w_full]
    Xt, yt, _, X_val, y_val = splits[0]
    w_list = [sp[2] for sp in splits]
    if est0.is_classifier:
        k = infer_num_classes(y, num_classes)
        fit = _fit_cls_slab
    else:
        k = None
        fit = _fit_reg_slab
    telem = FitTelemetry.start(
        est0, family=f"GBMSweep[{type(est0).__name__}]", n=Xt.shape[0],
        d=Xt.shape[1], telemetry_path=telemetry_path, mesh=mesh, candidates=B,
    )
    try:
        base = est0._base().copy()
        ctx = make_shared_fit_ctx(base, Xt)
        drift_ref = drift_reference_from_ctx(ctx)
        telem.phase_mark("setup")
        models: List[Any] = []
        cpd = max(1, int(_tuned("configs_per_dispatch", _CONFIGS_PER_DISPATCH,
                                n=Xt.shape[0])))
        for lo in range(0, B, cpd):
            sl = slice(lo, lo + cpd)
            slab_ests, slab_w = ests[sl], w_list[sl]
            axis = _config_axis(mesh, len(slab_ests))
            if axis is None:
                models += fit(slab_ests, slab_w, base, ctx, Xt, yt, X_val, y_val,
                              k, dev, telem)
                continue
            # this member rank's contiguous block of lanes, rows whole
            per = len(slab_ests) // axis.size
            mine = slice(axis.index * per, (axis.index + 1) * per)
            own = fit(slab_ests[mine], slab_w[mine], base, ctx, Xt, yt, X_val,
                      y_val, k, dev, telem)
            for m, blobs in enumerate(gather_objects(
                    [model_bytes(x) for x in own], axis)):
                models += (own if m == axis.index
                           else [model_from_bytes(b, dev) for b in blobs])
    except BaseException as e:  # a terminal telemetry record, then re-raise
        telem.abort(e, candidates=B)
        raise
    for model in models:
        if drift_ref is not None:
            model.drift_ref_ = drift_ref
        # per-candidate round rows do not exist inside a lockstep round:
        # sweep models carry an empty (not missing) history
        model.fit_history_ = empty_history()
    telem.finish(candidates=B)
    return models


def _config_axis(mesh, slab: int):
    """The mesh's "member" axis when it shards a slab of ``slab`` lanes
    (the JAX package's ``_config_sharder``), else None: no mesh, a member
    axis of one rank, or one that does not divide the slab.  Each member
    rank fits a contiguous block of the slab's lanes on the whole rows, so
    every lane's reductions run as in the unsharded sweep."""
    axis = None if mesh is None else mesh.member_axis
    if axis is None or axis.size <= 1 or slab % axis.size != 0:
        return None
    return axis


def _new_lanes(ests, w_list, n, d, dev):
    lanes = []
    for e, w in zip(ests, w_list):
        bag_keys, samp_keys = e._round_keys(dev, None)
        lanes.append(_Lane(e, w, e._sampling_plan(n, d, dev), e._model_masks(d, dev),
                           bag_keys, samp_keys))
    return lanes


def _fit_reg_slab(ests, w_list, base, ctx, Xt, yt, X_val, y_val, k, dev, telem):
    """One slab of regressor lanes (the sequential ``GBMRegressor.fit``'s
    round loop in lockstep)."""
    est0 = ests[0]
    n, d = Xt.shape
    loss_name = est0.loss.lower()
    alpha_q = float(est0.alpha)
    huber = loss_name == "huber"
    round_core = make_reg_round_core(
        base, loss_name, alpha_q, est0.updates.lower(),
        bool(est0.optimized_weights), est0._goss(), float(est0.tol),
        int(est0.max_iter),
    )
    lanes = _new_lanes(ests, w_list, n, d, dev)
    inits = [e._fit_init(Xt, yt, lane.w, dev) for e, lane in zip(ests, lanes)]
    preds = [im.predict(Xt).clone() for im in inits]
    delta0 = (weighted_quantile(torch.cat([yt, y_val]) if y_val is not None else yt,
                                alpha_q)
              if huber else torch.zeros((), device=dev))
    deltas = [delta0] * len(lanes)
    with_validation = X_val is not None
    if with_validation:
        y_val_enc = y_val[:, None]
        preds_val = [im.predict(X_val).clone() for im in inits]
        for lane, pv in zip(lanes, preds_val):
            lane.best = float(torch.mean(
                _make_reg_loss(loss_name, alpha_q, delta0).loss(y_val_enc, pv[:, None])))
    ones = torch.ones_like(yt)
    check = str(est0.on_nonfinite).lower() == "raise"
    r = 0
    while any(lane.active for lane in lanes):
        live = [lane.active for lane in lanes]
        t0 = time.perf_counter()
        labels, fit_ws, bag_ws, masks, keys, losses = [], [], [], [], [], []
        for s, lane in enumerate(lanes):
            bag_w, mask, bag_key, samp_key = lane.draws(r)
            if huber:
                deltas[s] = weighted_quantile(torch.abs(yt - preds[s]), alpha_q,
                                              weights=ones)
                if live[s]:
                    lane.deltas.append(deltas[s])
            loss = _make_reg_loss(loss_name, alpha_q, deltas[s])
            lab, fw, bw = round_core.targets(loss, yt, preds[s], bag_w, lane.w, samp_key)
            labels.append(lab)
            fit_ws.append(fw)
            bag_ws.append(bw)
            masks.append(mask)
            keys.append(bag_key)
            losses.append(loss)
        # one call of the JAX package's swept round program; the lanes'
        # shared base learner keys it (a lane's own rate is an operand)
        with program_call("gbm_reg_sweep", Xt, len(lanes), base):
            params, dirs = _swept_forest(base, ctx, labels, fit_ws, masks, Xt, keys, 1)
        weights = []
        for s, lane in enumerate(lanes):
            alpha = round_core.step(losses[s], yt, preds[s], bag_ws[s], dirs[s])
            weight = _scaled(live[s], lane.lr * alpha)
            preds[s] = preds[s] + weight * dirs[s]
            weights.append(weight)
        if check:
            _check_finite(live, weights, params, r, type(est0).__name__)
        errs = None
        if with_validation:
            errs = []
            for s in range(len(lanes)):
                preds_val[s] = preds_val[s] + weights[s] * base.predict_fn(params[s], X_val)
                errs.append(torch.mean(losses[s].loss(y_val_enc, preds_val[s][:, None])))
        _commit(lanes, live, params, weights, errs)
        _emit_sweep_round(telem, r, live, t0, (params, weights))
        r += 1
    return [
        lane.est._model(*_stacked(lane), lane.i - lane.v, d, dev,
                        lane.val_hist if with_validation else None,
                        init_model=init_model,
                        huber_delta=torch.stack(lane.deltas) if huber else None)
        for lane, init_model in zip(lanes, inits)
    ]


def _fit_cls_slab(ests, w_list, base, ctx, Xt, yt, X_val, y_val, k, dev, telem):
    """One slab of classifier lanes (the sequential ``GBMClassifier.fit``'s
    round loop in lockstep, every lane's class dims in one forest)."""
    est0 = ests[0]
    n, d = Xt.shape
    loss = est0._make_loss(k)
    dim = loss.dim
    optimized = bool(est0.optimized_weights)
    max_iter, tol = int(est0.max_iter), float(est0.tol)
    round_core = make_cls_round_core(
        base, loss, dim, est0.updates.lower(), optimized, est0._goss(), tol,
        max_iter,
    )
    lanes = _new_lanes(ests, w_list, n, d, dev)
    inits = [e._init_raw_scores(Xt, yt, lane.w, k, dim, dev)
             for e, lane in zip(ests, lanes)]
    y_enc = loss.encode_label(yt)
    preds = [ir[None, :].expand(n, dim).clone() for _, ir in inits]
    alpha_ws = [torch.ones((dim,), dtype=torch.float32, device=dev) for _ in lanes]
    with_validation = X_val is not None
    if with_validation:
        y_enc_val = loss.encode_label(y_val)
        preds_val = [ir[None, :].expand(X_val.shape[0], dim).clone() for _, ir in inits]
        for lane, pv in zip(lanes, preds_val):
            lane.best = float(torch.mean(loss.loss(y_enc_val, pv)))
    check = str(est0.on_nonfinite).lower() == "raise"
    r = 0
    while any(lane.active for lane in lanes):
        live = [lane.active for lane in lanes]
        t0 = time.perf_counter()
        labels, fit_ws, bag_ws, masks, keys = [], [], [], [], []
        for lane, pred in zip(lanes, preds):
            bag_w, mask, bag_key, samp_key = lane.draws(r)
            lab, fw, bw = round_core.targets(y_enc, pred, bag_w, lane.w, samp_key)
            labels.append(lab)
            fit_ws.append(fw)
            bag_ws.append(bw)
            masks.append(mask)
            keys.append(bag_key)
        with program_call("gbm_cls_sweep", Xt, len(lanes), base):
            params, dirs = _swept_forest(base, ctx, labels, fit_ws, masks, Xt, keys, dim)
        if optimized:
            problems = [round_core.step_problem(y_enc, preds[s], bag_ws[s], dirs[s])
                        for s in range(len(lanes))]
            alphas = projected_newton_box_lanes(
                [p[0] for p in problems], torch.stack(alpha_ws),
                max_iter=min(max_iter, 25), tol=tol,
                grad_hess=[p[1] for p in problems],
            )
        else:
            alphas = torch.ones((len(lanes), dim), dtype=torch.float32, device=dev)
        weights = []
        for s, lane in enumerate(lanes):
            weight = _scaled(live[s], lane.lr * alphas[s])
            preds[s] = preds[s] + weight[None, :] * dirs[s]
            alpha_ws[s] = alpha_carry(alphas[s])
            weights.append(weight)
        if check:
            _check_finite(live, weights, params, r, type(est0).__name__)
        errs = None
        if with_validation:
            errs = []
            for s in range(len(lanes)):
                dirs_val = base.predict_many_fn(params[s], X_val).T
                preds_val[s] = preds_val[s] + weights[s][None, :] * dirs_val
                errs.append(torch.mean(loss.loss(y_enc_val, preds_val[s])))
        _commit(lanes, live, params, weights, errs)
        _emit_sweep_round(telem, r, live, t0, (params, weights))
        r += 1
    return [
        lane.est._model(*_stacked(lane), lane.i - lane.v, d, dev,
                        lane.val_hist if with_validation else None,
                        init_raw=init_raw, num_classes=k, dim=dim)
        for lane, (_, init_raw) in zip(lanes, inits)
    ]
