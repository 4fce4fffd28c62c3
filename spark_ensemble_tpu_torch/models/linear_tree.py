"""Linear-leaf regression trees: a piece-wise linear base learner
(PyTorch port of ``models/linear_tree.py``).

"Gradient Boosting With Piece-Wise Linear Regression Trees" (Shi et al.,
arXiv:1802.05640): a small ridge regression in each leaf captures smooth
trends that constant leaves need many rounds for.  As in the JAX package:

1. the histogram tree is fitted exactly as ``DecisionTreeRegressor`` fits
   it (``ops.tree.fit_tree``, any tier);
2. rows are routed to leaves by their bins (``ops.tree.leaf_one_hot``);
3. every leaf's weighted normal equations ``[leaves, d+1, d+1]`` come from
   two one-hot contractions in f32, and are solved by a batched
   Cholesky-Crout over the leaves (``ops.linesearch.chol_solve_psd_lanes``,
   the JAX package's arithmetic: a leaf whose matrix is not positive
   definite comes out non-finite, not as an error);
4. leaves with too little weight for a d+1-parameter model, or a
   non-finite solve, keep the tree's constant value.

Prediction selects each row's coefficients by its routed leaf id (an exact
selection, as the JAX package's one-hot matmul is) and dots them with the
standardized features; rows with a non-finite feature take the constant
leaf value.
"""

from __future__ import annotations

import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    RegressionModel,
    as_f32,
)
from spark_ensemble_tpu_torch.models.linear import _apply_mask, _feature_stats
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor
from spark_ensemble_tpu_torch.ops.collective import preduce
from spark_ensemble_tpu_torch.ops.linesearch import chol_solve_psd_lanes
from spark_ensemble_tpu_torch.ops.tree import (
    _PREDICT_MAX_CELLS,
    Tree,
    _clamp_features,
    _leaf_ids,
    feature_gains,
    leaf_one_hot,
)
from spark_ensemble_tpu_torch.params import Param, gt_eq, in_range


class LinearTreeRegressor(DecisionTreeRegressor):
    """Histogram tree with ridge-regression leaves (a regressor: GBM's
    members are regressors)."""

    leaf_params = True

    reg_param = Param(1e-3, gt_eq(0.0), doc="leaf ridge strength")
    min_leaf_weight = Param(
        8.0,
        gt_eq(0.0),
        doc="minimum EFFECTIVE row support for a linear leaf: leaves whose "
        "weight is below min_leaf_weight times the mean positive row "
        "weight keep the constant tree value (a d+1-parameter model needs "
        "that much support).  Relative to the mean weight so normalized "
        "weight vectors (boosting's w/sum(w)) behave like unit weights",
    )
    max_depth = Param(
        5, in_range(1, 10),
        doc="tree depth (shallower cap than constant-leaf trees: every "
        "leaf carries a d+1-dim ridge model)",
    )

    def make_fit_ctx(self, X, num_classes=None):
        ctx = super().make_fit_ctx(X, num_classes)
        ctx["X"] = as_f32(X)  # raw features for the leaf models
        return ctx

    def ctx_gather_rows(self, ctx, idx):
        """The leaf solves read the raw rows too: gather both matrices."""
        return {**super().ctx_gather_rows(ctx, idx), "X": ctx["X"][idx]}

    def ctx_row_leaves(self, ctx):
        """The bins and the raw rows are row-indexed."""
        return {k: k in ("Xb", "X") for k in ctx}

    def _leaf_models(self, ctx, tree: Tree, y, w, feature_mask, axis_name=None):
        """The leaf-regression stage on a fitted constant-leaf tree; under a
        mesh the moments and every leaf's normal equations are reduced over
        ``axis_name`` before the solves."""
        X = _apply_mask(ctx["X"], feature_mask)
        n, d = X.shape
        mu, sd = _feature_stats(X, w, axis_name)
        Xs = torch.cat(
            [(X - mu[None, :]) / sd[None, :], torch.ones((n, 1), dtype=X.dtype, device=X.device)],
            dim=1,
        )  # [n, d+1]
        oh = leaf_one_hot(tree, ctx["Xb"], binned=True)  # [n, leaves], exact
        Xw = Xs * w[:, None]
        # every leaf's normal equations in two one-hot contractions (f32)
        A, b, leaf_w, n_pr, w_sum = preduce(
            [(oh.T @ (Xw[:, :, None] * Xs[:, None, :]).reshape(n, -1)).reshape(-1, d + 1, d + 1),
             oh.T @ (Xw * y[:, None]), oh.T @ w,
             torch.sum((w > 0).to(torch.float32))[None], torch.sum(w)[None]],
            axis_name,
        )
        # penalize SLOPES only: a feature constant within a leaf (collinear
        # with the bias column) gets slope exactly 0
        ridge = torch.diag(torch.cat([
            torch.full((d,), self.reg_param + 1e-6, dtype=X.dtype, device=X.device),
            torch.tensor([1e-8], dtype=X.dtype, device=X.device),
        ]))
        beta = chol_solve_psd_lanes(A + ridge, b)  # [leaves, d+1]
        # the support bar is in EFFECTIVE rows (weight over the mean
        # positive weight); strict, so an empty leaf falls back even at
        # min_leaf_weight=0
        n_present = torch.clamp(n_pr[0], min=1.0)
        w_bar = w_sum[0] / n_present
        const = torch.cat(
            [torch.zeros((tree.leaf_value.shape[0], d), dtype=X.dtype, device=X.device),
             tree.leaf_value[:, :1]],
            dim=1,
        )
        ok = (leaf_w > self.min_leaf_weight * w_bar)[:, None]
        beta = torch.where(ok & torch.isfinite(beta).all(dim=1, keepdim=True), beta, const)
        mask = (feature_mask.to(torch.float32) if feature_mask is not None
                else torch.ones((d,), dtype=torch.float32, device=X.device))
        return {"tree": tree, "beta": beta, "x_mu": mu, "x_sd": sd, "mask": mask}

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None, axis_name=None):
        tree = super().fit_from_ctx(ctx, y, w, feature_mask, axis_name=axis_name)
        return self._leaf_models(ctx, tree, y, w, feature_mask, axis_name)

    # the tree learner's leaf-id shortcuts return constant-leaf directions:
    # keep the generic fit-then-predict
    fit_and_direction = BaseLearner.fit_and_direction
    fit_many_and_directions = BaseLearner.fit_many_and_directions

    def fit_many_from_ctx(self, ctx, ys, ws, feature_masks, keys=None,
                          axis_name=None):
        """One forest fit for every member's tree (``fit_forest``), then
        each member's leaf stage, stacked along a leading member axis."""
        trees = super().fit_many_from_ctx(ctx, ys, ws, feature_masks,
                                          axis_name=axis_name)
        M = ys.shape[1]
        if feature_masks is not None and feature_masks.dim() == 1:
            feature_masks = feature_masks[None, :].expand(M, -1)
        models = [
            self._leaf_models(ctx, Tree(*(a[m] for a in trees)), ys[:, m], ws[:, m],
                              None if feature_masks is None else feature_masks[m],
                              axis_name)
            for m in range(M)
        ]
        return {
            "tree": trees,
            **{k: torch.stack([mm[k] for mm in models]) for k in ("beta", "x_mu", "x_sd", "mask")},
        }

    def predict_fn(self, params, X):
        stacked = {"tree": Tree(*(a[None] for a in params["tree"])),
                   **{k: params[k][None] for k in ("beta", "x_mu", "x_sd", "mask")}}
        return self.predict_many_fn(stacked, X)[0]

    def predict_many_fn(self, params, X):
        """Members' predictions ``[M, n]``: every member routed at once by
        leaf ids, then each row's selected coefficients dotted with its
        standardized (masked) features, in row chunks."""
        X = as_f32(X)
        trees = params["tree"]
        M = trees.split_feature.shape[0]
        m = torch.arange(M, device=X.device)[None, :]
        chunk = max(1, _PREDICT_MAX_CELLS // max(M * (X.shape[1] + 1), 1))
        outs = []
        for r0 in range(0, X.shape[0], chunk):
            Xr = X[r0:r0 + chunk]
            # a row with a non-finite feature takes the constant leaf value:
            # a clamped 3e38 would explode through the linear term
            finite_row = torch.isfinite(Xr).all(dim=1)
            Xc = _clamp_features(Xr)
            leaf = _leaf_ids(trees, Xc, binned=False)  # [rows, M]
            beta_row = params["beta"][m, leaf]  # [rows, M, d+1]
            Xs = ((Xc[:, None, :] * params["mask"][None, :, :] - params["x_mu"][None, :, :])
                  / params["x_sd"][None, :, :])
            lin = torch.sum(Xs * beta_row[:, :, :-1], dim=-1) + beta_row[:, :, -1]
            const = trees.leaf_value[m, leaf, 0]
            outs.append(torch.where(finite_row[:, None], lin, const))
        if not outs:
            return X.new_zeros((M, 0))
        return torch.cat(outs, dim=0).T

    def feature_gains_fn(self, params, d: int):
        # importances come from the tree's split gains
        return feature_gains(params["tree"], d)

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return LinearTreeRegressionModel(
            params=params, num_features=num_features, device=device,
            **self.get_params(),
        )


class LinearTreeRegressionModel(RegressionModel, LinearTreeRegressor):
    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))
