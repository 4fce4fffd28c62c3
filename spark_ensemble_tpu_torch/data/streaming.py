"""Out-of-core GBM training over bit-packed shard stores (PyTorch port of
``data/streaming.py``).

The resident ``hist="stream"`` tier (``ops/tree._fit_forest_streamed``)
computes each tree level as one pass over row chunks of the binned
feature matrix, but the matrix itself lives on the device.  Here the
packed bin matrix stays on disk (``data/shards.py``), a prefetcher
(``data/prefetch.py``) streams shards ahead of the device, and each level
is one SHARD SWEEP through the same loop, ``ops/tree.stream_forest``:
the same ``stream_level_step`` / ``stream_leaf_step`` calls on the same
operands in the same order, on the same CUDA stream.  That is the whole
bit-identity argument: a streaming fit and a resident ``hist="stream"``
fit whose ``stream_chunk_rows`` equals the store's ``shard_rows`` take
the same f32 products on the same shapes, so the fitted params are EQUAL,
not close.  Three details keep the shapes equal: the last, ragged shard
is sliced to its own rows (the resident tier's last chunk is a shorter
slice, not a padded one), each shard is unpacked to the same int32 bin
ids the resident tier upcasts its uint8 bins to, and the value channels
are the resident tier's, rounded the same way.

The per-shard node ids ``node_all [S, R, M]`` and value channels
``vals_all [S, R, M, C]`` stay resident, with the labels, weights and
carried predictions: ``O(n)`` tensors beside the ``n*d`` bin matrix.

The round loop is the resident fit's own (``GBMRegressor._fit_rounds`` /
``GBMClassifier._fit_rounds`` on ``_drive_rounds`` and the
``RoundExecutor``), with the shard sweep standing in for the base tree, so
chunked dispatch, patience early stop, checkpoint cadence, numeric-guard
recovery and chaos semantics are shared, and checkpoints are
interchangeable with resident ones (the same fingerprint): a fit killed
mid-shard resumes from the last round boundary like any other fit.  The
chaos sites ``<Family>:stream_round:<r>:level:<l>:shard:<s>`` and
``<Family>:stream_round:<r>:leaf:shard:<s>`` are the JAX package's.

Telemetry: a streaming fit is a fit of its own on the stream
(``fit_start`` with the store's rows, then ``streaming_config``), its
prefetcher mirrors each shard's I/O into ``global_metrics()`` and the
trace (``data/prefetch.py``), and each round emits its shard I/O as
``shard_load`` / ``shard_prefetch_hit`` / ``shard_wait_us`` events, as the
JAX package's ``_emit_shard_io`` does.  A streaming fit captures no
``drift_ref_``, as in the JAX package.

With ``mesh=`` the shard sweeps span the mesh's ranks
(``parallel/elastic.DistributedSweep``): each rank prefetches and opens only
its round-robin slice of the manifest (``data/partition.py``), and the
ranks fold their per-step histograms in global shard order, so the fit is
bit-identical to the single-process one under ``reduce="ordered"``.  The
labels, weights and carried predictions stay whole on every rank, so the
round loop and its checkpoints are the single-process ones: a checkpoint
has no mesh component, and an elastic rewind resumes it at another width.
"""

from __future__ import annotations

import torch

from spark_ensemble_tpu_torch.data.prefetch import ShardPrefetcher
from spark_ensemble_tpu_torch.models.base import (
    as_f32,
    infer_num_classes,
    mesh_device,
    resolve_device,
    resolve_weights,
)
from spark_ensemble_tpu_torch.models.linear_tree import LinearTreeRegressor
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor
from spark_ensemble_tpu_torch.ops.binning import CompressedBins, unpack_bins
from spark_ensemble_tpu_torch.ops.tree import (
    Tree,
    _bf16_round,
    leaf_values_at,
    stream_forest,
    stream_vals_prep,
)
from spark_ensemble_tpu_torch.telemetry.events import FitTelemetry
from spark_ensemble_tpu_torch.utils.instrumentation import Instrumentation


def _emit_shard_io(telem, prefetch):
    """One round's shard I/O as events on the fit's stream
    (``tools/telemetry_report.py`` folds them into the shard-I/O share)."""
    st = prefetch.take_stats()
    if not telem.enabled or not st["loads"]:
        return
    telem.emit(
        "shard_load", count=st["loads"], bytes=st["bytes"],
        duration_us=int(st["load_s"] * 1e6),
    )
    telem.emit(
        "shard_prefetch_hit", hits=st["hits"], misses=st["misses"],
    )
    telem.emit("shard_wait_us", wait_us=int(st["wait_s"] * 1e6))


class _ShardTrees:
    """The base tree as the GBM round cores call it, each round's trees
    fitted by sweeps over the shard store instead of over resident bins.
    ``site`` names the round for the chaos sites (set before each round);
    each round's shard I/O goes to ``telem`` after the round."""

    def __init__(self, base, store, prefetch, ctl, label, device, telem,
                 dist=None):
        self.base, self.store, self.prefetch, self.ctl = base, store, prefetch, ctl
        #: the distributed sweep under a mesh (None on one process), and the
        #: axis its ranks agree on a resume over
        self.dist = dist
        self.agree_axis = None if dist is None else dist.axis
        self.label = label
        self.telem = telem
        self.thresholds = torch.as_tensor(store.thresholds, device=device)
        hp = str(base.hist_precision).lower()
        # the stream tier's precisions (ops/tree.fit_forest): triangular
        # prefix sums below "highest", bf16 statistics at "default"
        self.triangular = hp != "highest"
        self.round_bf16 = hp == "default"
        self.rows = [int(store.shard_meta(s)["rows"]) for s in range(store.num_shards)]
        self.site = label

    def begin_round(self, r: int) -> None:
        self.site = f"{self.label}:stream_round:{r}"

    def end_round(self, r: int) -> None:
        _emit_shard_io(self.telem, self.prefetch)

    def _sweep_forest(self, Y, w, feature_mask):
        """Fit ``M`` trees (``Y [n, M, k]``, ``w [n, M]``) in ``max_depth +
        1`` shard sweeps -> ``(Tree [M, ...], node [n, M])`` leaf ids."""
        store = self.store
        n, M, _ = Y.shape
        d, S, R = store.d, store.num_shards, store.shard_rows
        dev = Y.device
        if feature_mask is None:
            feature_mask = torch.ones((M, d), dtype=torch.bool, device=dev)
        elif feature_mask.dim() == 1:
            feature_mask = feature_mask[None, :].expand(M, d)
        _, y_mean, vals = stream_vals_prep(Y, w)
        if self.round_bf16:
            vals = _bf16_round(vals)
        C = vals.shape[2]
        vals_all = torch.zeros((S * R, M, C), dtype=torch.float32, device=dev)
        vals_all[:n] = vals
        vals_all = vals_all.reshape(S, R, M, C)
        mask = feature_mask.to(torch.bool)
        if self.dist is not None:
            forest, node_all = self.dist.sweep_forest(
                self.prefetch, self.ctl, self.site, vals_all, y_mean, mask,
                self.thresholds, rows=self.rows, d=d, bits=store.bits,
                max_depth=int(self.base.max_depth), max_bins=store.max_bins,
                min_info_gain=float(self.base.min_info_gain),
                triangular=self.triangular, round_bf16=self.round_bf16,
            )
            return forest, node_all.reshape(S * R, M)[:n]
        node_all = torch.zeros((S, R, M), dtype=torch.int32, device=dev)

        def sweep(tag):
            for s, words in self.prefetch.sweep():
                # a mid-shard kill lands between two accumulations: the
                # resume replays the round from its last checkpoint
                self.ctl.preempt(f"{self.site}:{tag}:shard:{s}")
                r = self.rows[s]
                xb = unpack_bins(CompressedBins(words[:r], store.bits, d))
                yield xb, node_all[s, :r], vals_all[s, :r]

        forest = stream_forest(
            sweep, y_mean, self.thresholds, mask, d=d,
            max_depth=int(self.base.max_depth), max_bins=store.max_bins,
            min_info_gain=float(self.base.min_info_gain),
            triangular=self.triangular, round_bf16=self.round_bf16,
        )
        return forest, node_all.reshape(S * R, M)[:n]

    # -- the round cores' calls (models/tree._TreeLearner's, by leaf ids) --

    def fit_and_direction(self, ctx, y, w, feature_mask, X, key=None,
                          axis_name=None):
        # under a mesh only the sweep is distributed: the rows are whole
        mask = None if feature_mask is None else feature_mask.reshape(1, -1)
        forest, node = self._sweep_forest(y[:, None, None], w[:, None], mask)
        tree = Tree(*(a[0] for a in forest))
        return tree, self.base._direction_from_leaf(tree.leaf_value[node[:, 0].long()])

    def fit_many_and_directions(self, ctx, ys, ws, feature_masks, X, keys=None,
                                axis_name=None):
        forest, node = self._sweep_forest(ys[:, :, None], ws, feature_masks)
        return forest, self.base._direction_from_leaf(leaf_values_at(forest, node))


def _check_store(est, store, y):
    base = est._base().copy()
    if not isinstance(base, DecisionTreeRegressor) or isinstance(base, LinearTreeRegressor):
        raise ValueError(
            "fit_streaming supports histogram DecisionTreeRegressor base "
            f"learners; got {type(base).__name__}"
        )
    if int(base.max_bins) != store.max_bins:
        raise ValueError(
            f"base learner max_bins={base.max_bins} does not match the "
            f"shard store's max_bins={store.max_bins}; the store's "
            "thresholds were computed at write_shards time"
        )
    if y.shape[0] != store.n:
        raise ValueError(f"y has {y.shape[0]} rows, shard store has {store.n}")
    return base


def _streaming_fit(est, store, y, sample_weight, X_val, y_val, device, run,
                   num_classes=None, mesh=None, reduce="ordered"):
    """Shared set-up: checks, the fit's telemetry, the shard sweep (the
    distributed one under ``mesh``) and its prefetcher, and a placeholder
    feature matrix of the store's shape (one zero broadcast, no memory; the
    init fits read only its shape) -> ``run(X_ph, y, w, X_val, y_val, base,
    trees, telem)``'s model.  ``num_classes(y)`` gives a classifier's class
    count.  Under a mesh every rank streams its own telemetry."""
    from spark_ensemble_tpu_torch.robustness.chaos import controller

    dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
    y = as_f32(y, dev)
    base = _check_store(est, store, y)
    if str(getattr(est, "init_strategy", "")).lower() == "base":
        raise ValueError(
            "init_strategy='base' needs resident features; use "
            "'constant' or 'zero' for streaming fits"
        )
    w = resolve_weights(y, sample_weight)
    if X_val is not None:
        X_val, y_val = as_f32(X_val, dev), as_f32(y_val, dev)
    X_ph = torch.zeros((), dtype=torch.float32, device=dev).expand(store.n, store.d)
    label = type(est).__name__
    k = None if num_classes is None else num_classes(y)
    instr = Instrumentation(f"{label}.fit_streaming")
    instr.log_params(est.get_params())
    instr.log_dataset(store.n, store.d, k)
    meta = {} if k is None else {"num_classes": int(k)}
    telem = FitTelemetry.start(est, n=store.n, d=store.d, **meta)
    telem.emit(
        "streaming_config", shards=store.num_shards,
        shard_rows=store.shard_rows, bits=store.bits,
        packed_bytes=store.packed_nbytes,
    )
    dist = None
    if mesh is not None:
        from spark_ensemble_tpu_torch.parallel.elastic import DistributedSweep

        dist = DistributedSweep(mesh, store, reduce=reduce, telem=telem)
        dist.check_agreement()
    # under a mesh each rank prefetches only its slice of the manifest
    prefetch = ShardPrefetcher(store if dist is None else dist.reader(),
                               device=dev, telem=telem)
    try:
        trees = _ShardTrees(base, store, prefetch, controller(), label, dev, telem,
                            dist=dist)
        model = run(X_ph, y, w, X_val, y_val, base, trees, telem, k)
    finally:
        prefetch.close()
        if dist is not None:
            from spark_ensemble_tpu_torch.parallel.elastic import _record_fit_stats

            _record_fit_stats(dist)
    instr.log_outcome(kept_members=model.num_members)
    return model


def fit_streaming_regressor(est, store, y, sample_weight=None, X_val=None,
                            y_val=None, mesh=None, reduce="ordered", device="cuda"):
    """Out-of-core ``GBMRegressor`` fit over a ``ShardStore``: the
    streaming twin of ``GBMRegressor.fit``, bit-identical to a resident
    ``hist="stream"`` fit at matched chunk rows.  With ``mesh`` the shard
    sweeps span its ranks (still bit-identical under ``reduce="ordered"``,
    allclose under ``"psum"``)."""
    def run(X_ph, y, w, X_val, y_val, base, trees, telem, k):
        return est._fit_rounds(X_ph, y, w, X_val, y_val, base, None, X_ph.device,
                               telem, trees=trees)

    return _streaming_fit(est, store, y, sample_weight, X_val, y_val, device, run,
                          mesh=mesh, reduce=reduce)


def fit_streaming_classifier(est, store, y, sample_weight=None, X_val=None,
                             y_val=None, num_classes=None, mesh=None,
                             reduce="ordered", device="cuda"):
    """Out-of-core ``GBMClassifier`` fit over a ``ShardStore``; the class
    dims fold into the sweep's member axis, as in the resident forest.
    ``mesh`` and ``reduce`` as in :func:`fit_streaming_regressor`."""
    def run(X_ph, y, w, X_val, y_val, base, trees, telem, k):
        return est._fit_rounds(X_ph, y, w, X_val, y_val, k, base, None,
                               X_ph.device, telem, trees=trees)

    return _streaming_fit(est, store, y, sample_weight, X_val, y_val, device, run,
                          num_classes=lambda y: infer_num_classes(y, num_classes),
                          mesh=mesh, reduce=reduce)
