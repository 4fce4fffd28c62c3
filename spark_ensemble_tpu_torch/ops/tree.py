"""Histogram decision trees: level-wise forest fit and predict (PyTorch
port of ``ops/tree.py``).

Same structure as the JAX package: a dense complete binary tree in heap
layout (``2^depth - 1`` internal nodes, ``2^depth`` leaves), targets
``Y[n, M, k]`` for M trees fit at once on shared binned features, and the
split score ``sum_k (S_L^2/W_L + S_R^2/W_R)`` over per-level histograms of
``(w, w * y_centered)``.

Histogram tiers (``hist`` x ``hist_precision``):

- ``scatter``: ``index_add_`` in f32 — the JAX package's CPU ``auto`` tier.
- ``matmul``: the one-hot matmul ``A^T @ bin_onehot`` in true f32 (TF32 is
  off on CUDA, ``models/base.resolve_device``) — the JAX package's GPU
  ``auto`` tier.
- ``pallas`` (``hist_precision="pallas"`` on the matmul tier): the level
  histogram comes from ``ops/hist_kernels.hist_level_pallas`` (CUDA kernel
  on the card), statistics split into bf16 hi + lo.  The other statistic
  math of this tier (triangular prefix sums, leaf sums) runs at ``HIGH``
  (bf16x3) in the JAX package; here it is f32, at least as exact.
- ``fused``: one ``fused_round_level`` per level over bit-packed bins (route
  launch + histogram launch; the leaf pass sums in exact f32).

The fast precisions ``high`` and ``default`` on the matmul tier compute
only the left children's histograms at each level >= 1 and derive the
right siblings as ``parent - left`` (histogram subtraction).  A derived
empty child carries the subtraction's rounding noise, so its weight floor
is the parent's floor plus ``rel * parent weight`` (rel 1e-6 at 'high',
1e-2 at 'default'), accumulated down the chain of derived children; left
children keep the direct 1e-12.  Their prefix sums are one matmul against
a triangular 0/1 matrix, as on the pallas precision.  The precision map,
on every device (the histogram product itself is ``torch.matmul``, as the
JAX package's is an XLA dot outside any Pallas kernel):

- ``high``: true f32 (TF32 off).  The JAX package's HIGH is bf16x3,
  whose three bf16 terms hold an f32's 24-bit significand.
- ``default``: the statistic operand (the histogram's ``A``, the
  histogram entering the prefix sums, the leaf sums' statistics) is
  rounded to bf16 before the product, with f32 accumulation; the one-hot
  side is exact in bf16.  This is the JAX package's single-pass DEFAULT
  (which JAX on the CPU ignores, computing f32 there).

On the fused tier they change only the prefix sums (its kernel computes
every level directly, so the direct floors apply); on the scatter tier
both are the exact tier, as in the JAX package.  A
single tree (``fit_tree``) at ``hist_precision="pallas"`` runs on this
'high' matmul path, as the JAX package's does; a forest at "pallas"
launches the kernel.

Routing is an integer-exact gather, the same function as the JAX
package's one-hot contraction.  :func:`feature_gains` sums split gains per
feature for ``feature_importances_``.  Still to port:
``predict_tree_binned`` and ``leaf_one_hot`` (with linear leaves, ROADMAP
queue 1, item 12) and the ``stream`` tier (Slice B).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spark_ensemble_tpu_torch.ops.binning import pack_bins, pack_width
from spark_ensemble_tpu_torch.ops.hist_kernels import (
    fused_round_level,
    hist_level_pallas,
    hist_plain,
    leaf_plain,
)


class Tree(NamedTuple):
    """Fitted tree (or, with leading axes, a stack of trees)."""

    split_feature: torch.Tensor  # i32[..., 2^depth - 1]
    split_bin: torch.Tensor  # i32; max_bins-1 encodes "always left"
    split_threshold: torch.Tensor  # f32; +inf encodes "always left"
    leaf_value: torch.Tensor  # f32[..., 2^depth, k]
    split_gain: torch.Tensor  # f32[..., 2^depth - 1]; 0 at no-split nodes


# bin-one-hot budget of the matmul tier under hist="auto": past it the JAX
# package takes the row-chunked stream tier, which the port lacks yet
_MATMUL_HIST_MAX_CELLS = 2**28
_ROUTING_EXACT_MAX_BINS = 256
# clamp for non-finite features at predict: NaN/+inf go right at every
# real split, -inf goes left (the JAX package's rule)
_F32_MAX = 3.0e38
# rows x trees per predict chunk (bounds the [rows, trees] id tensors)
_PREDICT_MAX_CELLS = 2**22


def _not_ported(param, value, item):
    raise NotImplementedError(
        f"{param}={value!r} is not supported by the PyTorch port yet "
        f"(ROADMAP {item})"
    )


# the relative weight floor of a subtraction-derived child, per precision
_DERIVED_FLOOR_REL = {"high": 1e-6, "default": 1e-2}


def _derived_hist_weight_floor(hist_precision, parent_w):
    """Weight floor for a SUBTRACTION-derived histogram: an empty child
    computed directly weighs exactly 0.0, but ``parent - left`` carries the
    tier's rounding noise at the tree-parent's magnitude ``parent_w``.
    Children below that noise level are treated as empty."""
    return _DERIVED_FLOOR_REL[hist_precision] * parent_w


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 (ties to even), kept in f32: the
    operand rounding of a single-pass bf16 product."""
    return x.to(torch.bfloat16).to(torch.float32)


def resolve_forest_tier(hist: str, hist_precision: str, device, n: int,
                        d: int, B: int) -> str:
    """The tier ``fit_forest`` runs: ``scatter``, ``matmul``, ``pallas`` or
    ``fused``.  Mirrors the JAX package's resolution, minus the tiers the
    port lacks (which raise) and minus the VMEM gates, which do not carry
    over: a CUDA kernel tiles its output across CTAs."""
    hp, h = hist_precision.lower(), hist.lower()
    if h == "fused":
        if B > _ROUTING_EXACT_MAX_BINS:
            raise ValueError(
                f"hist='fused' packs bin ids into 4/8-bit lanes: max_bins={B} "
                "exceeds the packable range (256)"
            )
        return "fused"
    if h == "auto":
        if torch.device(device).type == "cpu" and hp != "pallas":
            h = "scatter"
        elif n * d * B <= _MATMUL_HIST_MAX_CELLS:
            h = "matmul"
        else:
            h = "stream"
    if h == "stream":
        _not_ported("hist", h, "Slice B")
    if hp == "pallas" and h == "matmul":
        return "pallas"
    return h


def _bin_one_hot(Xb: torch.Tensor, B: int) -> torch.Tensor:
    """Row-to-bin one-hot ``f32[n, d*B]``, the matmul tier's RHS."""
    n, d = Xb.shape
    return (
        Xb[:, :, None] == torch.arange(B, device=Xb.device, dtype=Xb.dtype)
    ).to(torch.float32).reshape(n, d * B)


def _level_hist(tier, Xb, bin_oh, node, vals, n_nodes, B, prev_H=None):
    """Level histogram ``H f32[M, n_nodes, C, d, B]`` of the non-fused
    tiers.  With ``prev_H`` (the parents' histograms, fast precisions on
    the matmul tier) only the left children are computed and the right
    siblings are ``parent - left``."""
    if tier == "scatter":
        return hist_plain(Xb, node, vals, n_nodes, B, 1)
    if tier == "pallas":
        return hist_level_pallas(Xb, node, vals, n_nodes=n_nodes, max_bins=B)
    n, M, C = vals.shape
    d = Xb.shape[1]
    if prev_H is None:
        node_oh = torch.nn.functional.one_hot(node.long(), n_nodes).to(torch.float32)
        A = (node_oh[:, :, :, None] * vals[:, :, None, :]).reshape(n, M * n_nodes * C)
        return (A.T @ bin_oh).reshape(M, n_nodes, C, d, B)
    half = n_nodes // 2
    left_oh = torch.nn.functional.one_hot((node >> 1).long(), half).to(torch.float32)
    left_oh = left_oh * (1 - (node & 1)).to(torch.float32)[:, :, None]
    A = (left_oh[:, :, :, None] * vals[:, :, None, :]).reshape(n, M * half * C)
    Hl = (A.T @ bin_oh).reshape(M, half, C, d, B)
    # interleave: children 2p (left), 2p+1 (right)
    return torch.stack([Hl, prev_H - Hl], dim=2).reshape(M, n_nodes, C, d, B)


def _route_members(Xb, node, best_f, best_t):
    """``node [n, M]`` level ids -> child-level ids: left iff the row's bin
    at the node's split feature is <= the split bin."""
    M = node.shape[1]
    m = torch.arange(M, device=node.device)[None, :]
    nl = node.long()
    xb_f = Xb.gather(1, best_f[m, nl].long())
    return (2 * node + (xb_f > best_t[m, nl]).to(torch.int32)).to(torch.int32)


def _prefix_sums(hist_w, hist_wy, triangular, round_bf16=False):
    """Left-prefix sums over the bins axis: ``cumsum`` on the exact tiers,
    or one matmul against a triangular 0/1 matrix on the tiers whose JAX
    counterpart takes that form (matmul, pallas and fused below
    "highest"), with the histogram rounded to bf16 first at 'default'."""
    if not triangular:
        return torch.cumsum(hist_w, dim=3), torch.cumsum(hist_wy, dim=3)
    if round_bf16:
        hist_w, hist_wy = _bf16_round(hist_w), _bf16_round(hist_wy)
    B = hist_w.shape[3]
    tri = torch.triu(torch.ones((B, B), dtype=torch.float32, device=hist_w.device))
    cw = torch.einsum("...b,bc->...c", hist_w, tri)
    cwy = torch.einsum("...bk,bc->...ck", hist_wy, tri)
    return cw, cwy


def _level_split_tables(H, feature_mask, node_floor, min_info_gain,
                        thresholds, B, triangular, round_bf16=False):
    """Candidate-split scoring for one level: ``H [M, nodes, 1+k, d, B]``
    -> best-split tables + per-node statistics.  The argmax is the first
    maximum over the flat ``(d, B-1)`` axis, as in the JAX package."""
    M, n_nodes, _, d, _ = H.shape
    hist_w = H[:, :, 0]  # [M, nodes, d, B]
    hist_wy = torch.movedim(H[:, :, 1:], 2, -1)  # [M, nodes, d, B, k]
    cw, cwy = _prefix_sums(hist_w, hist_wy, triangular, round_bf16)
    W = cw[:, :, :1, -1:]
    S = cwy[:, :, :1, -1:, :]
    WL = cw[:, :, :, : B - 1]
    SL = cwy[:, :, :, : B - 1, :]
    WR = W - WL
    SR = S - SL

    def score(s, wgt):
        return torch.sum(s * s, dim=-1) / torch.clamp(wgt, min=1e-12)

    parent_score = score(S[:, :, 0, 0, :], W[:, :, 0, 0])[:, :, None, None]
    gain = score(SL, WL) + score(SR, WR) - parent_score  # [M, nodes, d, B-1]
    wf = node_floor[:, :, None, None]
    valid = (WL > wf) & (WR > wf) & feature_mask[:, None, :, None]
    gain = torch.where(valid, gain, torch.tensor(-float("inf"), device=H.device))

    flat = gain.reshape(M, n_nodes, d * (B - 1))
    best = torch.argmax(flat, dim=2)
    best_gain = torch.gather(flat, 2, best[:, :, None])[:, :, 0]
    best_f = torch.div(best, B - 1, rounding_mode="floor").to(torch.int32)
    best_t = (best % (B - 1)).to(torch.int32)

    do_split = best_gain > min_info_gain
    best_f = torch.where(do_split, best_f, 0).to(torch.int32)
    best_t = torch.where(do_split, best_t, B - 1).to(torch.int32)
    thr = torch.where(
        do_split,
        thresholds[best_f.long(), torch.clamp(best_t, max=B - 2).long()],
        torch.tensor(float("inf"), device=H.device),
    )
    node_w = cw[:, :, 0, -1]  # [M, nodes]
    node_wy = cwy[:, :, 0, -1, :]  # [M, nodes, k]
    return best_f, best_t, thr, do_split, best_gain, node_w, node_wy


def fit_forest(
    Xb: torch.Tensor,  # i32[n, d] binned features, shared by all members
    Y: torch.Tensor,  # f32[n, M, k] per-member targets
    w: torch.Tensor,  # f32[n, M] per-member sample weights
    thresholds: torch.Tensor,  # f32[d, max_bins-1]
    feature_mask: Optional[torch.Tensor] = None,  # bool[M, d] | bool[d]
    *,
    max_depth: int = 5,
    max_bins: int = 64,
    min_info_gain: float = 0.0,
    hist: str = "auto",
    hist_precision: str = "highest",
    return_leaf: bool = False,  # also return row leaf ids i32[n, M]
):
    """Fit M trees at once on shared binned features -> stacked ``Tree``
    (leading member axis), optionally with each row's leaf id per member.

    One loop serves every tier: the fused tier's branches are the JAX
    package's ``_fit_forest_fused`` (bins packed once; each level routes
    by the previous level's tables inside ``fused_round_level``), the
    others its dense ``fit_forest`` path, with histogram subtraction and
    its floors at the fast precisions on the matmul tier."""
    n, d = Xb.shape
    _, M, k = Y.shape
    B = max_bins
    J = 2**max_depth - 1
    dev = Xb.device
    hp = hist_precision.lower()
    tier = resolve_forest_tier(hist, hp, dev, n, d, B)
    triangular = hp != "highest" and tier != "scatter"
    # 'default' rounds the statistic operands of the dense products to bf16
    round_bf16 = hp == "default" and tier != "scatter"
    subtract = hp in ("high", "default") and tier == "matmul"

    if feature_mask is None:
        feature_mask = torch.ones((M, d), dtype=torch.bool, device=dev)
    elif feature_mask.dim() == 1:
        feature_mask = feature_mask[None, :].expand(M, d)
    feature_mask = feature_mask.to(torch.bool)

    w = w.to(torch.float32)
    w_tot = torch.sum(w, dim=0)  # [M]
    y_mean = torch.sum(w[:, :, None] * Y, dim=0) / torch.clamp(
        w_tot[:, None], min=1e-30
    )  # [M, k]
    vals = torch.cat(
        [w[:, :, None], w[:, :, None] * (Y - y_mean[None, :, :])], dim=2
    ).contiguous()  # [n, M, 1+k]

    stat_vals = _bf16_round(vals) if round_bf16 else vals

    split_feature = torch.zeros((M, J), dtype=torch.int32, device=dev)
    split_bin = torch.zeros((M, J), dtype=torch.int32, device=dev)
    split_threshold = torch.zeros((M, J), dtype=torch.float32, device=dev)
    split_gain = torch.zeros((M, J), dtype=torch.float32, device=dev)
    node = torch.zeros((n, M), dtype=torch.int32, device=dev)
    parent_value = y_mean[:, None, :]  # [M, 1, k]
    bin_oh = _bin_one_hot(Xb, B) if tier == "matmul" else None
    if tier == "fused":
        bits = pack_width(B)
        # loop-invariant: packed once, read by every level's kernels
        packed = pack_bins(Xb, B, bits).packed
    tables = (None, None)  # previous level's (best_f, best_t), fused tier
    # the parents' histograms, weights and floors (histogram subtraction)
    prev_H = prev_W = prev_floor = None

    for level in range(max_depth):
        n_nodes = 2**level
        derived = subtract and level >= 1
        if tier == "fused":
            H, node = fused_round_level(
                packed, node, vals, tables[0], tables[1], n_nodes=n_nodes,
                max_bins=B, bits=bits, num_features=d,
            )
        else:
            H = _level_hist(tier, Xb, bin_oh, node, stat_vals, n_nodes, B,
                            prev_H if derived else None)
        if derived:
            # left children are direct (an empty one reads exactly 0.0);
            # right children accumulate their parents' floors plus this
            # level's rounding at the parent's weight: the sum, not a max
            right_floor = prev_floor + _derived_hist_weight_floor(hp, prev_W)
            node_floor = torch.stack(
                [torch.full_like(right_floor, 1e-12), right_floor], dim=-1
            ).reshape(M, n_nodes)
        else:
            node_floor = torch.full((M, n_nodes), 1e-12, dtype=torch.float32, device=dev)
        best_f, best_t, thr, do_split, best_gain, node_w, node_wy = (
            _level_split_tables(
                H, feature_mask, node_floor, min_info_gain, thresholds, B,
                triangular, round_bf16,
            )
        )
        heap = slice(2**level - 1, 2**level - 1 + n_nodes)
        split_feature[:, heap] = best_f
        split_bin[:, heap] = best_t
        split_threshold[:, heap] = thr
        split_gain[:, heap] = torch.where(do_split, best_gain, 0.0)
        if tier == "fused":
            tables = (best_f.contiguous(), best_t.contiguous())  # routed in-kernel
        else:
            node = _route_members(Xb, node, best_f, best_t)
        node_val = node_wy / torch.clamp(node_w[:, :, None], min=1e-30)
        node_val = torch.where(
            node_w[:, :, None] > node_floor[:, :, None], node_val, parent_value
        )
        parent_value = torch.repeat_interleave(node_val, 2, dim=1)
        prev_H, prev_W, prev_floor = H, node_w, node_floor

    num_leaves = 2**max_depth
    if tier == "fused":
        L, node = fused_round_level(
            packed, node, vals, tables[0], tables[1], n_nodes=num_leaves,
            max_bins=B, bits=bits, num_features=d, leaf=True,
        )
    elif tier == "scatter":
        L = leaf_plain(node, vals, num_leaves)
    else:
        leaf_oh = torch.nn.functional.one_hot(node.long(), num_leaves).to(torch.float32)
        L = torch.einsum("nml,nmc->mlc", leaf_oh, stat_vals)
    leaf_w = L[:, :, 0]  # [M, L]
    leaf_wy = L[:, :, 1:]  # [M, L, k]
    leaf_value = leaf_wy / torch.clamp(leaf_w[:, :, None], min=1e-30)
    leaf_value = torch.where(leaf_w[:, :, None] > 1e-12, leaf_value, parent_value)
    tree = Tree(
        split_feature=split_feature,
        split_bin=split_bin,
        split_threshold=split_threshold,
        leaf_value=leaf_value + y_mean[:, None, :],
        split_gain=split_gain,
    )
    # the final `node` is each row's leaf id: a fit-then-predict on the
    # same rows (the GBM round) reads leaf values by it instead of re-routing
    return (tree, node) if return_leaf else tree


def fit_tree(Xb, Y, w, thresholds, feature_mask=None, *, max_depth=5,
             max_bins=64, min_info_gain=0.0, hist="auto",
             hist_precision="highest", return_leaf=False):
    """One tree (``Y f32[n, k]``, ``w f32[n]``): ``fit_forest`` with M=1.

    As in the JAX package, a single tree at ``hist_precision="pallas"``
    runs on the 'high' matmul tier with histogram subtraction, not on the
    kernel (the fused tier keeps its kernels)."""
    if hist_precision.lower() == "pallas" and hist.lower() != "fused":
        hist_precision = "high"
    mask = None if feature_mask is None else feature_mask.reshape(1, -1)
    out = fit_forest(
        Xb, Y[:, None, :], w[:, None], thresholds, mask,
        max_depth=max_depth, max_bins=max_bins, min_info_gain=min_info_gain,
        hist=hist, hist_precision=hist_precision, return_leaf=return_leaf,
    )
    if return_leaf:
        forest, node = out
        return Tree(*(a[0] for a in forest)), node[:, 0]
    return Tree(*(a[0] for a in out))


def leaf_values_at(trees: Tree, node: torch.Tensor) -> torch.Tensor:
    """``leaf_value[m, node[r, m]]`` -> ``[n, M, k]``: each row's fitted
    value per member, read off the leaf ids a fit returned (an exact
    selection, like the JAX package's one-hot contraction)."""
    M = node.shape[1]
    m = torch.arange(M, device=node.device)[None, :]
    return trees.leaf_value[m, node.long()]


def feature_gains(trees: Tree, d: int) -> torch.Tensor:
    """Per-feature summed split gains ``f32[..., d]`` of one tree or a
    stack of trees (any leading axes).  No-split nodes carry gain 0 at
    feature 0, so they add nothing."""
    sf = trees.split_feature
    out = torch.zeros(sf.shape[:-1] + (d,), dtype=torch.float32, device=sf.device)
    return out.scatter_add_(-1, sf.long(), trees.split_gain.to(torch.float32))


def predict_forest(trees: Tree, X: torch.Tensor) -> torch.Tensor:
    """Member predict for a stacked ``Tree`` on raw features ``X[n, d]`` ->
    ``f32[M, n, k]``: a heap walk by gathers, bit-identical to the JAX
    package's path-scoring matmuls (both select one leaf value exactly)."""
    M, J = trees.split_feature.shape
    depth = (J + 1).bit_length() - 1
    Xc = torch.nan_to_num(
        X.to(torch.float32), nan=_F32_MAX, posinf=_F32_MAX, neginf=-_F32_MAX
    )
    n = Xc.shape[0]
    m = torch.arange(M, device=Xc.device)[None, :]
    sf = trees.split_feature.long()
    chunk = max(1, _PREDICT_MAX_CELLS // max(M, 1))
    outs = []
    for r0 in range(0, n, chunk):
        Xr = Xc[r0:r0 + chunk]
        node = torch.zeros((Xr.shape[0], M), dtype=torch.long, device=Xc.device)
        for _ in range(depth):
            x = Xr.gather(1, sf[m, node])
            node = 2 * node + torch.where(x <= trees.split_threshold[m, node], 1, 2)
        outs.append(trees.leaf_value[m, node - J])  # [rows, M, k]
    return torch.cat(outs, dim=0).permute(1, 0, 2) if outs else (
        trees.leaf_value.new_zeros((M, 0, trees.leaf_value.shape[-1]))
    )


def predict_tree(tree: Tree, X: torch.Tensor) -> torch.Tensor:
    """``f32[n, k]`` leaf values of one tree on raw features ``X[n, d]``."""
    return predict_forest(Tree(*(a[None] for a in tree)), X)[0]
