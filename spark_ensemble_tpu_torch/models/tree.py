"""Decision-tree base learner over the histogram trees in ``ops/tree.py``
(PyTorch port of ``models/tree.py``).

The slice ports ``DecisionTreeRegressor``, the GBM base learner; the
classifier tree waits for the other families (ROADMAP queue 1, item 13).
Defaults mirror Spark MLlib: ``max_depth=5``, ``min_info_gain=0.0``;
``max_bins`` defaults to 64.
"""

from __future__ import annotations

from spark_ensemble_tpu_torch.models.base import BaseLearner, RegressionModel
from spark_ensemble_tpu_torch.ops.binning import bin_features, compute_bins
from spark_ensemble_tpu_torch.ops.tree import (
    Tree,
    fit_forest,
    fit_tree,
    leaf_values_at,
    predict_forest,
    predict_tree,
)
from spark_ensemble_tpu_torch.params import Param, gt_eq, in_array, in_range


class _TreeLearner(BaseLearner):
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
        "'pallas' = the level histograms of a forest fit come from the "
        "CUDA kernel that replaces the JAX package's pallas kernel "
        "(ops/hist_kernels.py, bf16 hi + lo statistics); 'high' and "
        "'default' (histogram subtraction) are not ported yet",
    )
    hist = Param(
        "auto",
        in_array(["auto", "scatter", "matmul", "stream", "fused"]),
        doc="histogram tier (ops/tree.py): 'auto' = scatter on the CPU, "
        "matmul on CUDA; 'fused' = per level a route kernel and a "
        "histogram kernel over bit-packed 4/8-bit bins (max_bins <= 256); "
        "'stream' is not ported yet",
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


class DecisionTreeRegressor(_TreeLearner):
    is_classifier = False

    def fit_from_ctx(self, ctx, y, w, feature_mask, return_leaf=False):
        return fit_tree(
            ctx["Xb"], y[:, None], w, ctx["thresholds"], feature_mask,
            **self._fit_kw(return_leaf),
        )

    def fit_many_from_ctx(self, ctx, ys, ws, feature_masks, return_leaf=False):
        """All members in ONE forest fit (``ops.tree.fit_forest``)."""
        return fit_forest(
            ctx["Xb"], ys[:, :, None], ws, ctx["thresholds"], feature_masks,
            **self._fit_kw(return_leaf),
        )

    def fit_and_direction(self, ctx, y, w, feature_mask, X):
        """Fit + the fitted values on the same rows, read off the leaf ids
        the fit computed instead of re-walking the tree."""
        tree, node = self.fit_from_ctx(ctx, y, w, feature_mask, return_leaf=True)
        return tree, tree.leaf_value[node.long(), 0]

    def fit_many_and_directions(self, ctx, ys, ws, feature_masks, X):
        trees, node = self.fit_many_from_ctx(
            ctx, ys, ws, feature_masks, return_leaf=True
        )
        return trees, leaf_values_at(trees, node)[:, :, 0]

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
