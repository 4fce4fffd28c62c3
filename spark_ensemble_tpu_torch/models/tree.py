"""Decision-tree base learners over the histogram trees in ``ops/tree.py``
(PyTorch port of ``models/tree.py``).

The variance (regression) and gini (classification) criteria are both the
sum-of-squares gain of ``ops.tree.fit_forest`` over k target columns: the
regressor fits one column, the classifier the one-hot class columns
(C = 1 + K statistics per row).  ``DecisionTreeRegressor`` is the GBM base
learner; ``DecisionTreeClassifier`` is Boosting's default base and
Bagging's for classification.  Defaults mirror Spark MLlib:
``max_depth=5``, ``min_info_gain=0.0``; ``max_bins`` defaults to 64.
"""

from __future__ import annotations

import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    ClassificationModel,
    RegressionModel,
)
from spark_ensemble_tpu_torch.ops.binning import bin_features, compute_bins
from spark_ensemble_tpu_torch.ops.tree import (
    Tree,
    feature_gains,
    fit_forest,
    fit_tree,
    leaf_values_at,
    predict_forest,
    predict_tree,
)
from spark_ensemble_tpu_torch.params import Param, gt_eq, in_array, in_range


def _renorm_proba(p):
    """Leaf class distribution -> probability vector: clip tiny negative
    fallback artifacts, renormalize.  One definition, so predict_proba and
    the leaf-id reuse of ``fit_and_proba`` stay exactly in sync."""
    p = torch.clamp(p, min=0.0)
    return p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)


class _TreeLearner(BaseLearner):
    # params are a bare Tree (False) or a dict around one (linear leaves)
    leaf_params = False

    max_depth = Param(
        5, in_range(1, 20),
        doc="tree depth; the dense heap layout always allocates "
        "2^max_depth leaves (static shapes)",
    )
    max_bins = Param(
        64, gt_eq(2),
        doc="histogram bins per feature (quantile binning at fit time)",
    )
    min_info_gain = Param(
        0.0, gt_eq(0.0), doc="minimum split gain; below it a node leafs"
    )
    hist_precision = Param(
        "highest",
        in_array(["highest", "high", "default", "pallas"]),
        doc="precision of the histogram statistics: 'highest' = true f32; "
        "'high' = true f32 with histogram subtraction (right children as "
        "parent - left) and triangular-matmul prefix sums; 'default' = "
        "the same with the statistic operands rounded to bf16 (f32 "
        "accumulation); 'pallas' = the level histograms of a forest fit "
        "come from the CUDA kernel that replaces the JAX package's pallas "
        "kernel (ops/hist_kernels.py, bf16 hi + lo statistics), and a "
        "single tree runs at 'high'; past the one-hot budget of "
        "hist='auto' the stream tier wins, at 'high'.  'high' and "
        "'default' change only the matmul, stream and fused tiers, and "
        "only the matmul tier subtracts histograms (ops/tree.py)",
    )
    hist = Param(
        "auto",
        in_array(["auto", "scatter", "matmul", "stream", "fused"]),
        doc="histogram tier (ops/tree.py): 'auto' = scatter on the CPU, "
        "matmul on CUDA up to 2^28 one-hot cells (n * d * max_bins) and "
        "'stream' past them; 'stream' = the matmul tier over row chunks "
        "(no [n, d*max_bins] one-hot); 'fused' = per level a route kernel "
        "and a histogram kernel over bit-packed 4/8-bit bins "
        "(max_bins <= 256)",
    )
    seed = Param(0, doc="unused by the deterministic kernels; API parity")

    def make_fit_ctx(self, X, num_classes=None):
        bins = compute_bins(X, self.max_bins)
        return {
            "Xb": bin_features(X, bins),
            "thresholds": bins.thresholds,
            "num_classes": num_classes,
        }

    def _fit_kw(self, return_leaf):
        return dict(
            max_depth=self.max_depth,
            max_bins=self.max_bins,
            min_info_gain=self.min_info_gain,
            hist=self.hist,
            hist_precision=self.hist_precision,
            return_leaf=return_leaf,
        )

    def _targets(self, ctx, y):
        """``[n]`` labels -> ``[n, k]`` tree targets."""
        raise NotImplementedError

    def _targets_many(self, ctx, ys):
        """``[n, M]`` member target columns -> ``[n, M, k]`` tree targets."""
        raise NotImplementedError

    def _direction_from_leaf(self, pred):
        """Leaf-value selection ``[..., k]`` -> the member's prediction."""
        raise NotImplementedError

    def ctx_gather_rows(self, ctx, idx):
        """Compact the binned matrix only; thresholds and num_classes are
        shared (GBM's gradient row sampling, models/gbm.py)."""
        return {**ctx, "Xb": ctx["Xb"][idx]}

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None,
                     return_leaf=False):
        return fit_tree(
            ctx["Xb"], self._targets(ctx, y), w, ctx["thresholds"],
            feature_mask, **self._fit_kw(return_leaf),
        )

    def fit_many_from_ctx(self, ctx, ys, ws, feature_masks, keys=None,
                          return_leaf=False, lanes=1):
        """All members in ONE forest fit (``ops.tree.fit_forest``); with
        ``lanes`` (a megabatch sweep) every lane of M / lanes members fits
        as it would alone."""
        return fit_forest(
            ctx["Xb"], self._targets_many(ctx, ys), ws, ctx["thresholds"],
            feature_masks, lanes=lanes, **self._fit_kw(return_leaf),
        )

    def _fit_and_leaf_pred(self, ctx, y, w, feature_mask):
        """Fit + each row's selected leaf-value vector -> (tree, [n, k]),
        read off the leaf ids the fit computed instead of re-walking the
        tree (an exact selection, as the JAX package's one-hot contraction)."""
        tree, node = self.fit_from_ctx(ctx, y, w, feature_mask, return_leaf=True)
        return tree, tree.leaf_value[node.long()]

    def fit_and_direction(self, ctx, y, w, feature_mask, X, key=None):
        """Fit + the fitted predictions on the same rows (leaf-id reuse)."""
        tree, pred = self._fit_and_leaf_pred(ctx, y, w, feature_mask)
        return tree, self._direction_from_leaf(pred)

    def fit_many_and_directions(self, ctx, ys, ws, feature_masks, X,
                                keys=None, lanes=1):
        trees, node = self.fit_many_from_ctx(
            ctx, ys, ws, feature_masks, return_leaf=True, lanes=lanes
        )
        return trees, self._direction_from_leaf(leaf_values_at(trees, node))

    def feature_gains_fn(self, params: Tree, d: int):
        return feature_gains(params, d)


class DecisionTreeRegressor(_TreeLearner):
    is_classifier = False

    def _targets(self, ctx, y):
        return y[:, None]

    def _targets_many(self, ctx, ys):
        return ys[:, :, None]

    def _direction_from_leaf(self, pred):
        return pred[..., 0]

    def predict_fn(self, params: Tree, X):
        return predict_tree(params, X)[:, 0]

    def predict_many_fn(self, params: Tree, X):
        return predict_forest(params, X)[:, :, 0]

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return DecisionTreeRegressionModel(
            params=params, num_features=num_features, device=device,
            **self.get_params(),
        )


class DecisionTreeRegressionModel(RegressionModel, DecisionTreeRegressor):
    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))


def _argmax_f32(scores):
    # the first maximum, as jnp.argmax takes it
    return torch.argmax(scores, dim=-1).to(torch.float32)


class DecisionTreeClassifier(_TreeLearner):
    """Gini tree: the leaf values are weighted one-hot class means."""

    is_classifier = True

    def _targets(self, ctx, y):
        # one-hot classes, for [n] labels and [n, M] member columns alike
        return torch.nn.functional.one_hot(
            y.to(torch.int64), int(ctx["num_classes"])
        ).to(torch.float32)

    _targets_many = _targets

    def _direction_from_leaf(self, pred):
        # parity with predict_fn: argmax over the leaf class distribution
        return _argmax_f32(pred)

    def fit_and_proba(self, ctx, y, w, feature_mask, X, key=None):
        """Leaf-id reuse for SAMME.R: the selected leaf distribution,
        renormalized exactly like ``predict_proba_fn``."""
        tree, pred = self._fit_and_leaf_pred(ctx, y, w, feature_mask)
        return tree, _renorm_proba(pred)

    def predict_raw_fn(self, params: Tree, X):
        return predict_tree(params, X)

    def predict_proba_fn(self, params: Tree, X):
        # weighted one-hot means: a probability vector up to zero-weight
        # fallbacks; renormalized defensively
        return _renorm_proba(predict_tree(params, X))

    def predict_fn(self, params: Tree, X):
        return _argmax_f32(predict_tree(params, X))

    def predict_many_fn(self, params: Tree, X):
        return _argmax_f32(predict_forest(params, X))

    def predict_proba_many_fn(self, params: Tree, X):
        return _renorm_proba(predict_forest(params, X))

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return DecisionTreeClassificationModel(
            params=params, num_features=num_features,
            num_classes=num_classes or 2, device=device, **self.get_params(),
        )


class DecisionTreeClassificationModel(ClassificationModel, DecisionTreeClassifier):
    def predict_proba(self, X):
        return self.predict_proba_fn(self.params, self._input(X))

    def predict_raw(self, X):
        return self.predict_raw_fn(self.params, self._input(X))

    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))
