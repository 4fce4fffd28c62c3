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

Not ported yet: ``mesh=`` (the distributed sweep, ROADMAP queue 1, item
18) and the telemetry events (``streaming_config``, per-round shard I/O;
Slice F).
"""

from __future__ import annotations

import torch

from spark_ensemble_tpu_torch.data.prefetch import ShardPrefetcher
from spark_ensemble_tpu_torch.models.base import (
    as_f32,
    infer_num_classes,
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


class _ShardTrees:
    """The base tree as the GBM round cores call it, each round's trees
    fitted by sweeps over the shard store instead of over resident bins.
    ``site`` names the round for the chaos sites (set before each round)."""

    def __init__(self, base, store, prefetch, ctl, label, device):
        self.base, self.store, self.prefetch, self.ctl = base, store, prefetch, ctl
        self.label = label
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
            sweep, y_mean, self.thresholds, feature_mask.to(torch.bool), d=d,
            max_depth=int(self.base.max_depth), max_bins=store.max_bins,
            min_info_gain=float(self.base.min_info_gain),
            triangular=self.triangular, round_bf16=self.round_bf16,
        )
        return forest, node_all.reshape(S * R, M)[:n]

    # -- the round cores' calls (models/tree._TreeLearner's, by leaf ids) --

    def fit_and_direction(self, ctx, y, w, feature_mask, X, key=None):
        mask = None if feature_mask is None else feature_mask.reshape(1, -1)
        forest, node = self._sweep_forest(y[:, None, None], w[:, None], mask)
        tree = Tree(*(a[0] for a in forest))
        return tree, self.base._direction_from_leaf(tree.leaf_value[node[:, 0].long()])

    def fit_many_and_directions(self, ctx, ys, ws, feature_masks, X, keys=None):
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


def _streaming_fit(est, store, y, sample_weight, X_val, y_val, device, run):
    """Shared set-up: checks, the shard sweep and its prefetcher, and a
    placeholder feature matrix of the store's shape (one zero broadcast,
    no memory; the init fits read only its shape) -> ``run(X_ph, y, w,
    X_val, y_val, base, trees)``'s model."""
    from spark_ensemble_tpu_torch.robustness.chaos import controller

    dev = resolve_device(device)
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
    prefetch = ShardPrefetcher(store, device=dev)
    try:
        trees = _ShardTrees(base, store, prefetch, controller(), label, dev)
        return run(X_ph, y, w, X_val, y_val, base, trees)
    finally:
        prefetch.close()


def fit_streaming_regressor(est, store, y, sample_weight=None, X_val=None,
                            y_val=None, device="cuda"):
    """Out-of-core ``GBMRegressor`` fit over a ``ShardStore``: the
    streaming twin of ``GBMRegressor.fit``, bit-identical to a resident
    ``hist="stream"`` fit at matched chunk rows."""
    def run(X_ph, y, w, X_val, y_val, base, trees):
        return est._fit_rounds(X_ph, y, w, X_val, y_val, base, None, X_ph.device,
                               trees=trees, on_round=trees.begin_round)

    return _streaming_fit(est, store, y, sample_weight, X_val, y_val, device, run)


def fit_streaming_classifier(est, store, y, sample_weight=None, X_val=None,
                             y_val=None, num_classes=None, device="cuda"):
    """Out-of-core ``GBMClassifier`` fit over a ``ShardStore``; the class
    dims fold into the sweep's member axis, as in the resident forest."""
    def run(X_ph, y, w, X_val, y_val, base, trees):
        k = infer_num_classes(y, num_classes)
        return est._fit_rounds(X_ph, y, w, X_val, y_val, k, base, None,
                               X_ph.device, trees=trees, on_round=trees.begin_round)

    return _streaming_fit(est, store, y, sample_weight, X_val, y_val, device, run)
