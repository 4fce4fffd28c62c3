"""Histogram decision trees: level-wise forest fit and predict (PyTorch
port of ``ops/tree.py``).

Same structure as the JAX package: a dense complete binary tree in heap
layout (``2^depth - 1`` internal nodes, ``2^depth`` leaves), targets
``Y[n, M, k]`` for M trees fit at once on shared binned features, and the
split score ``sum_k (S_L^2/W_L + S_R^2/W_R)`` over per-level histograms of
``(w, w * y_centered)``.

Histogram tiers (``hist`` x ``hist_precision``):

- ``scatter``: ``index_add_`` in f32 — the JAX package's CPU ``auto`` tier.
  On CUDA, where ``index_add_`` adds by atomics in an order that changes
  from run to run, it is the sort-based ``index_put_`` accumulation, so a
  fit repeats bit for bit there too.
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

- ``stream``: the HBM-scale tier, which ``hist="auto"`` takes on CUDA past
  ``_MATMUL_HIST_MAX_CELLS`` one-hot cells (the JAX package's
  ``_fit_forest_streamed``). Each level is one pass over row chunks of
  ``stream_chunk_rows`` (``_STREAM_CHUNK_ROWS`` unless
  ``autotune.resolve.override`` sets it): the chunk is routed through
  the previous level's tables, and its histogram is one ``torch.matmul``
  over the chunk's one-hots, accumulated in chunk order. No ``[n, d*B]``
  tensor exists; bins are kept as uint8 when ``max_bins <= 256``. Its
  floors are the direct 1e-12 (no histogram subtraction), and its prefix
  sums follow the precision as on the matmul tier. At
  ``hist_precision="pallas"`` the stream tier wins, at the 'high'
  statistic precision, as in the JAX package: no kernel launches there.

Lanes (``fit_forest(..., lanes=S)``): a megabatch sweep fits S
candidates' K members each as one forest of M = S * K members, and every
member comes out bit-identical to its candidate's own K-member fit.  The
kernels sum each lane's rows in its K-member order
(``ops/hist_kernels.py``); the scatter tier's per-cell sums run in row
order whatever M is; and the steps whose reduction order a wider M could
change run once per lane on the lane's own slice: the per-member weight
sums and means, the prefix sums (CUDA's ``cumsum`` along the bins summed
a 312-member view in another order than its 26-member slices on an H100)
and the matmul and stream tiers' products (a batched product over the
lanes summed in another order than a lane's own product on the CPU).

Routing is an integer-exact gather, the same function as the JAX
package's one-hot contraction.  :func:`leaf_one_hot` and
:func:`leaf_one_hot_forest` are the one-hots of the routed leaf ids, equal
to the JAX package's path-score one-hots (the linear-leaf learner's
routing); :func:`feature_gains` sums split gains per feature for
``feature_importances_``.

Work: the matmul and stream tiers report each one-hot product's operand
bytes and ``2*m*k*n`` flops (``hist_kernels.report_work("matmul", ...)``)
to the program inventory's hook, as the kernel wrappers report theirs.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from spark_ensemble_tpu_torch.autotune.resolve import resolve as _tuned
from spark_ensemble_tpu_torch.ops.binning import pack_bins, pack_width
from spark_ensemble_tpu_torch.ops.collective import preduce
from spark_ensemble_tpu_torch.ops.hist_kernels import (
    fused_round_level,
    hist_level_pallas,
    hist_plain,
    leaf_plain,
    level_knobs,
    report_work,
    _WORK_HOOK,
)
from spark_ensemble_tpu_torch.telemetry.trace import span


class Tree(NamedTuple):
    """Fitted tree (or, with leading axes, a stack of trees)."""

    split_feature: torch.Tensor  # i32[..., 2^depth - 1]
    split_bin: torch.Tensor  # i32; max_bins-1 encodes "always left"
    split_threshold: torch.Tensor  # f32; +inf encodes "always left"
    leaf_value: torch.Tensor  # f32[..., 2^depth, k]
    split_gain: torch.Tensor  # f32[..., 2^depth - 1]; 0 at no-split nodes

    @classmethod
    def _persist_defaults(cls, fields: dict) -> dict:
        """Persistence format evolution (``utils/persist._decode``): saves
        made before ``split_gain`` existed load with zero gains
        (predictions unaffected; importances degrade to zeros)."""
        if "split_gain" not in fields and "split_threshold" in fields:
            fields["split_gain"] = torch.zeros_like(fields["split_threshold"])
        return fields

    @property
    def depth(self) -> int:
        return self.leaf_value.shape[-2].bit_length() - 1

    @property
    def num_outputs(self) -> int:
        return self.leaf_value.shape[-1]


# bin-one-hot budget of the matmul tier under hist="auto": past it the
# row-chunked stream tier runs (the JAX package's rule)
_MATMUL_HIST_MAX_CELLS = 2**28
# rows per chunk of the stream tier (the "stream_chunk_rows" tunable's
# default): bounds the chunk's one-hots (bin_oh [chunk, d*B], A [chunk,
# M*nodes*(1+k)]); data/shards.DEFAULT_SHARD_ROWS mirrors it
_STREAM_CHUNK_ROWS = 32768
# the leaf one-hots (linear leaves) serve trees up to this depth, as the
# JAX package's path-scoring matmuls do
_MATMUL_PREDICT_MAX_DEPTH = 10
_ROUTING_EXACT_MAX_BINS = 256
# clamp for non-finite features at predict: NaN/+inf go right at every
# real split, -inf goes left (the JAX package's rule)
_F32_MAX = 3.0e38
# rows x trees per predict chunk (bounds the [rows, trees] id tensors; the
# "predict_fused_max_cells" tunable's default)
_PREDICT_MAX_CELLS = 2**22


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
    """The tier ``fit_forest`` runs: ``scatter``, ``matmul``, ``stream``,
    ``pallas`` or ``fused``.  Mirrors the JAX package's resolution, minus
    the VMEM gates, which do not carry over: a CUDA kernel tiles its output
    across CTAs.  ``auto`` past the one-hot budget is ``stream``, at
    ``hist_precision="pallas"`` too (the stream tier wins).

    Under ``hist="auto"`` a measured winner for this device and shape class
    (the ``hist_tier`` tunable) replaces the heuristic; an explicit
    ``hist`` never reads it.  A tuned ``"fused"`` past 256 bins falls back
    to the heuristic with a warning, as the JAX package's fused gate does;
    an explicit ``hist="fused"`` there raises."""
    hp, h = hist_precision.lower(), hist.lower()
    if h == "fused":
        if B > _ROUTING_EXACT_MAX_BINS:
            raise ValueError(
                f"hist='fused' packs bin ids into 4/8-bit lanes: max_bins={B} "
                "exceeds the packable range (256)"
            )
        return "fused"
    if h == "auto":
        tuned = _tuned("hist_tier", "auto", n=n)
        if tuned == "fused" and B <= _ROUTING_EXACT_MAX_BINS:
            return "fused"
        if tuned == "fused":
            warnings.warn(
                f"tuned hist_tier 'fused' falls back to the heuristic tier: "
                f"max_bins={B} exceeds the packable range (256)", stacklevel=2,
            )
        elif tuned in ("scatter", "matmul", "stream"):
            h = tuned
    if h == "auto":
        if torch.device(device).type == "cpu" and hp != "pallas":
            h = "scatter"
        elif n * d * B <= _MATMUL_HIST_MAX_CELLS:
            h = "matmul"
        else:
            h = "stream"
    if hp == "pallas" and h == "matmul":
        return "pallas"
    return h


#: per-card (float32 peak flop/s, memory bytes/s) for the round cost model,
#: from NVIDIA's data sheet (SXM part, dense, at the full 700 W limit).  A
#: card not listed here reports no peak, so its rounds carry no mfu_est.
_CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 3.35e12)}

#: the JAX package's CPU placeholders for a CPU fit's cost model
_CPU_PEAKS = (1e12, 5e10)


def round_cost_est(n: int, d: int, k: int, M: int, max_depth: int,
                   max_bins: int, hist: str = "auto",
                   hist_precision: str = "highest", sampled_rows: int = None,
                   device="cuda") -> dict:
    """Static per-round cost estimate from shapes and the resolved tier
    (the JAX package's ``round_cost_est``, on the port's tiers):
    ``{"hist_tier", "pack_bits", "hbm_bytes_est", "flops_est"}`` plus
    ``peak_flops`` / ``hbm_bw_est`` where the device's figures are known
    (``_CARD_PEAKS``; the CPU keeps the JAX package's placeholders).
    ``hbm_bytes_est`` models each tier's reads of row-sized operands over
    the tree's levels plus the leaf pass; ``flops_est`` is the
    histogram-contraction MAC count (2 flops each), the same on every
    tier.  With ``sampled_rows`` (a GOSS/MVS compaction bucket) the
    histogram costs are modeled at the bucket plus one full-row feature
    pass, and ``hbm_saved_est`` is the predicted saving."""
    B = max_bins
    C = 1 + k

    def cost_at(n_rows: int):
        tier = resolve_forest_tier(hist, hist_precision, device, n_rows, d, B)
        bits = pack_width(B) if tier == "fused" else 0
        lanes = 32 // bits if bits else 1
        words = -(-d // lanes)

        def level_bytes(nodes: int, leaf: bool) -> int:
            flat = {
                "scatter": n_rows * d * (C + 1) * 4,
                "stream": n_rows * ((d if B <= 256 else d * 4) + M * 4 + M * C * 4),
                "pallas": n_rows * (d * 4 + M * 4 + M * C * 4),
                "fused": n_rows * (words * 4 + M * 4 + M * C * 4),
            }
            if tier != "matmul":
                return flat[tier]
            if leaf:
                return n_rows * M * (nodes + C) * 4
            return n_rows * (d * B * 4 + M * nodes * C * 4)

        hbm = sum(level_bytes(2**level, False) for level in range(max_depth)
                  ) + level_bytes(2**max_depth, True)
        flops = sum(2.0 * n_rows * (M * 2**level * C) * (d * B)
                    for level in range(max_depth)) + 2.0 * n_rows * M * 2**max_depth * C
        return tier, bits, hbm, flops

    tier, bits, hbm, flops = cost_at(n)
    saved = None
    if sampled_rows is not None and int(sampled_rows) < n:
        hbm_full = hbm
        tier, bits, hbm, flops = cost_at(int(sampled_rows))
        hbm += n * d * 4
        saved = max(int(hbm_full) - int(hbm), 0)
    out = {
        "hist_tier": tier,
        "pack_bits": bits,
        "hbm_bytes_est": int(hbm),
        "flops_est": float(flops),
    }
    dev = torch.device(device)
    peaks = (_CPU_PEAKS if dev.type == "cpu"
             else _CARD_PEAKS.get(torch.cuda.get_device_name(dev)))
    if peaks is not None:
        out["peak_flops"], out["hbm_bw_est"] = float(peaks[0]), float(peaks[1])
    if saved is not None:
        out["hbm_saved_est"] = int(saved)
    return out


def _bin_one_hot(Xb: torch.Tensor, B: int) -> torch.Tensor:
    """Row-to-bin one-hot ``f32[n, d*B]``, the matmul tier's RHS."""
    n, d = Xb.shape
    return (
        Xb[:, :, None] == torch.arange(B, device=Xb.device, dtype=Xb.dtype)
    ).to(torch.float32).reshape(n, d * B)


def _level_hist(tier, Xb, bin_oh, node, vals, n_nodes, B, prev_H=None,
                lanes=1, reduce=None, knobs=None):
    """Level histogram ``H f32[M, n_nodes, C, d, B]`` of the non-fused
    tiers.  With ``prev_H`` (the parents' histograms, fast precisions on
    the matmul tier) only the left children are computed and the right
    siblings are ``parent - left``.  With lanes, the matmul tier runs each
    lane's product on the lane's own columns (one batched product may sum
    in another order than the lane's own).  ``reduce`` (a mesh fit's
    cross-rank sum) applies to what this rank computed, before the
    subtraction: right siblings are reduced parents minus reduced left
    children, as in the JAX package.  ``knobs``: the pallas kernel's plan
    knobs (``hist_kernels.level_knobs``)."""
    red = reduce if reduce is not None else (lambda t: t)
    if tier == "scatter":
        return red(hist_plain(Xb, node, vals, n_nodes, B, 1, ordered=True))
    if tier == "pallas":
        return red(hist_level_pallas(Xb, node, vals, n_nodes=n_nodes, max_bins=B,
                                     lanes=lanes, knobs=knobs))
    if lanes > 1:
        parts = zip(node.chunk(lanes, dim=1), vals.chunk(lanes, dim=1),
                    prev_H.chunk(lanes) if prev_H is not None else [None] * lanes)
        return torch.cat([
            _level_hist(tier, Xb, bin_oh, nd.contiguous(), vl.contiguous(), n_nodes, B, ph,
                        reduce=reduce)
            for nd, vl, ph in parts
        ])
    n, M, C = vals.shape
    d = Xb.shape[1]
    if prev_H is None:
        node_oh = torch.nn.functional.one_hot(node.long(), n_nodes).to(torch.float32)
        A = (node_oh[:, :, :, None] * vals[:, :, None, :]).reshape(n, M * n_nodes * C)
        if _WORK_HOOK[0] is not None:
            report_work("matmul", m=M * n_nodes * C, k=n, n=d * B)
        return red((A.T @ bin_oh).reshape(M, n_nodes, C, d, B))
    half = n_nodes // 2
    left_oh = torch.nn.functional.one_hot((node >> 1).long(), half).to(torch.float32)
    left_oh = left_oh * (1 - (node & 1)).to(torch.float32)[:, :, None]
    A = (left_oh[:, :, :, None] * vals[:, :, None, :]).reshape(n, M * half * C)
    if _WORK_HOOK[0] is not None:
        report_work("matmul", m=M * half * C, k=n, n=d * B)
    Hl = red((A.T @ bin_oh).reshape(M, half, C, d, B))
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


def _per_lane(fn, lanes, *tensors):
    """``fn`` on each lane's slice of the leading member axis, the outputs
    concatenated: the lane's own shapes, so its own reduction order."""
    if lanes == 1:
        return fn(*tensors)
    outs = [fn(*parts) for parts in zip(*(t.chunk(lanes) for t in tensors))]
    return tuple(torch.cat(o) for o in zip(*outs))


def _prefix_sums(hist_w, hist_wy, triangular, round_bf16=False, lanes=1):
    """Left-prefix sums over the bins axis: ``cumsum`` on the exact tiers,
    or one matmul against a triangular 0/1 matrix on the tiers whose JAX
    counterpart takes that form (matmul, pallas and fused below
    "highest"), with the histogram rounded to bf16 first at 'default'.
    Both run per lane: a product's sum order may follow its rows, and so
    does CUDA's ``cumsum`` along the last axis (an H100 summed the rows of
    a [312, ...] view in another order than those of its [26, ...]
    slices)."""
    if not triangular:
        return _per_lane(lambda hw, hwy: (torch.cumsum(hw, dim=3), torch.cumsum(hwy, dim=3)),
                         lanes, hist_w, hist_wy)
    if round_bf16:
        hist_w, hist_wy = _bf16_round(hist_w), _bf16_round(hist_wy)
    B = hist_w.shape[3]
    tri = torch.triu(torch.ones((B, B), dtype=torch.float32, device=hist_w.device))
    return _per_lane(
        lambda hw, hwy: (torch.einsum("...b,bc->...c", hw, tri),
                         torch.einsum("...bk,bc->...ck", hwy, tri)),
        lanes, hist_w, hist_wy,
    )


def _level_split_tables(H, feature_mask, node_floor, min_info_gain,
                        thresholds, B, triangular, round_bf16=False, lanes=1):
    """Candidate-split scoring for one level: ``H [M, nodes, 1+k, d, B]``
    -> best-split tables + per-node statistics.  The argmax is the first
    maximum over the flat ``(d, B-1)`` axis, as in the JAX package."""
    M, n_nodes, _, d, _ = H.shape
    hist_w = H[:, :, 0]  # [M, nodes, d, B]
    hist_wy = torch.movedim(H[:, :, 1:], 2, -1)  # [M, nodes, d, B, k]
    cw, cwy = _prefix_sums(hist_w, hist_wy, triangular, round_bf16, lanes)
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


def stream_vals_prep(Y: torch.Tensor, w: torch.Tensor, lanes: int = 1,
                     axis_name=None):
    """Per-row statistics of a forest fit -> ``(w_tot [M], y_mean [M, k],
    vals [n, M, 1+k])``: the weight channel and the weighted targets
    centred at each member's root mean.  Every tier takes them from here;
    with lanes, each lane's sums over the rows run on its own columns.
    Under a mesh (``axis_name``) both sums are reduced across the ranks,
    so the rows are centred at the global mean."""
    if lanes > 1:
        parts = [stream_vals_prep(Yl.contiguous(), wl.contiguous(),
                                  axis_name=axis_name)
                 for Yl, wl in zip(Y.chunk(lanes, dim=1), w.chunk(lanes, dim=1))]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts], dim=1))
    w = w.to(torch.float32)
    w_tot = torch.sum(w, dim=0)
    wy = torch.sum(w[:, :, None] * Y, dim=0)
    if axis_name is not None:
        w_tot, wy = preduce([w_tot, wy], axis_name)
    y_mean = wy / torch.clamp(w_tot[:, None], min=1e-30)
    vals = torch.cat(
        [w[:, :, None], w[:, :, None] * (Y - y_mean[None, :, :])], dim=2
    ).contiguous()
    return w_tot, y_mean, vals


def _leaf_onehot_sums(node, vals, num_leaves, lanes=1):
    """Leaf sums ``[M, leaves, C]`` as the one-hot contraction of the
    matmul and stream tiers (per lane: a batched product over the members
    may sum in another order for another member count)."""
    if lanes > 1:
        return torch.cat([
            _leaf_onehot_sums(nd.contiguous(), vl.contiguous(), num_leaves)
            for nd, vl in zip(node.chunk(lanes, dim=1), vals.chunk(lanes, dim=1))
        ])
    leaf_oh = torch.nn.functional.one_hot(node.long(), num_leaves).to(torch.float32)
    n, M, C = vals.shape
    if _WORK_HOOK[0] is not None:
        report_work("matmul", m=num_leaves, k=n, n=C, batch=M)
    return torch.einsum("nml,nmc->mlc", leaf_oh, vals)


def stream_level_step(acc, xb, nd, vl, *, n_nodes, tables, max_bins,
                      lanes=1):
    """One row chunk's share of one level's histogram: route the chunk
    (``xb`` i32 bins, ``nd`` node ids) through the PREVIOUS level's tables,
    then add ``A^T @ bin_oh`` of the chunk into ``acc [M, n_nodes, C, d,
    B]`` -> ``(acc, nd)``."""
    if tables is not None:
        nd = _route_members(xb, nd, tables[0], tables[1])
    acc.add_(_level_hist("matmul", xb, _bin_one_hot(xb, max_bins), nd, vl,
                         n_nodes, max_bins, lanes=lanes))
    return acc, nd


def stream_leaf_step(acc, xb, nd, vl, *, num_leaves, tables, lanes=1):
    """One row chunk's share of the leaf sums: route through the LAST
    level's tables and add into ``acc [M, leaves, C]`` -> ``(acc, nd)``."""
    nd = _route_members(xb, nd, tables[0], tables[1])
    acc.add_(_leaf_onehot_sums(nd, vl, num_leaves, lanes))
    return acc, nd


def _write_level(H, node_floor, feature_mask, min_info_gain, thresholds, B,
                 triangular, round_bf16, level, parent_value, out, lanes=1):
    """Score one level and write its heap rows into ``out`` (the split
    tensors, in place) -> ``(best_f, best_t, node_w, parent_value)``, the
    last being the children's fallback values."""
    M, n_nodes = H.shape[0], H.shape[1]
    best_f, best_t, thr, do_split, best_gain, node_w, node_wy = (
        _level_split_tables(H, feature_mask, node_floor, min_info_gain,
                            thresholds, B, triangular, round_bf16, lanes)
    )
    heap = slice(2**level - 1, 2**level - 1 + n_nodes)
    split_feature, split_bin, split_threshold, split_gain = out
    split_feature[:, heap] = best_f
    split_bin[:, heap] = best_t
    split_threshold[:, heap] = thr
    split_gain[:, heap] = torch.where(do_split, best_gain, 0.0)
    node_val = node_wy / torch.clamp(node_w[:, :, None], min=1e-30)
    node_val = torch.where(
        node_w[:, :, None] > node_floor[:, :, None], node_val, parent_value
    )
    return best_f, best_t, node_w, torch.repeat_interleave(node_val, 2, dim=1)


def stream_level_update(H, feature_mask, min_info_gain, thresholds, B,
                        triangular, round_bf16, level, parent_value, out,
                        lanes=1):
    """Score one level's accumulated histograms with the direct 1e-12
    floors (no histogram subtraction on this tier) and write its heap rows
    into ``out`` -> ``(tables, parent_value)``; ``tables = (best_f,
    best_t)`` route the next level's chunks."""
    M, n_nodes = H.shape[0], H.shape[1]
    floor = torch.full((M, n_nodes), 1e-12, dtype=torch.float32, device=H.device)
    best_f, best_t, _, parent_value = _write_level(
        H, floor, feature_mask, min_info_gain, thresholds, B, triangular,
        round_bf16, level, parent_value, out, lanes,
    )
    return (best_f, best_t), parent_value


def stream_leaf_values(leaf_w, leaf_wy, parent_value, y_mean):
    """Leaf sums -> leaf values (an empty leaf takes its parent's value),
    re-centred at the root mean."""
    leaf_value = leaf_wy / torch.clamp(leaf_w[:, :, None], min=1e-30)
    leaf_value = torch.where(leaf_w[:, :, None] > 1e-12, leaf_value, parent_value)
    return leaf_value + y_mean[:, None, :]


def _empty_splits(M, J, dev):
    return (
        torch.zeros((M, J), dtype=torch.int32, device=dev),
        torch.zeros((M, J), dtype=torch.int32, device=dev),
        torch.zeros((M, J), dtype=torch.float32, device=dev),
        torch.zeros((M, J), dtype=torch.float32, device=dev),
    )


def stream_forest(sweep, y_mean, thresholds, feature_mask, *, d, max_depth,
                  max_bins, min_info_gain, triangular, round_bf16, lanes=1,
                  axis_name=None):
    """The stream tier's passes over a source of row chunks -> ``Tree [M,
    ...]``.  ``sweep(tag)`` yields, for every chunk in row order, ``(xb
    i32[r, d], nd i32[r, M], vl f32[r, M, C])``, ``nd`` a view of the
    caller's node ids that each pass writes in place; ``tag`` is
    ``"level:<l>"`` or ``"leaf"``.  Each level is one pass: a chunk is
    routed through the previous level's tables, then its histogram is one
    matmul over its one-hots, added to the level's accumulator in chunk
    order; the leaf pass routes the last level and sums the leaves the same
    way.  The resident tier (:func:`_fit_forest_streamed`) and the shard
    sweep (``data/streaming.py``) both run this loop, so at equal chunks
    they take the same products in the same order, bit for bit.  Under a
    mesh each level's and the leaves' sums over this rank's chunks are
    reduced across the ranks (``axis_name``), as the JAX package psums
    after its chunk scan."""
    M, C = y_mean.shape[0], 1 + y_mean.shape[1]
    B = max_bins
    dev = y_mean.device
    out = _empty_splits(M, 2**max_depth - 1, dev)
    parent_value = y_mean[:, None, :]
    tables = None
    for level in range(max_depth):
        with span("tree.level"):
            n_nodes = 2**level
            H = torch.zeros((M, n_nodes, C, d, B), dtype=torch.float32, device=dev)
            for xb, nd, vl in sweep(f"level:{level}"):
                H, nd[...] = stream_level_step(
                    H, xb, nd, vl, n_nodes=n_nodes, tables=tables, max_bins=B,
                    lanes=lanes,
                )
            H = preduce(H, axis_name)
            with span("tree.split"):
                tables, parent_value = stream_level_update(
                    H, feature_mask, min_info_gain, thresholds, B, triangular,
                    round_bf16, level, parent_value, out, lanes,
                )
    L = torch.zeros((M, 2**max_depth, C), dtype=torch.float32, device=dev)
    for xb, nd, vl in sweep("leaf"):
        L, nd[...] = stream_leaf_step(
            L, xb, nd, vl, num_leaves=2**max_depth, tables=tables, lanes=lanes,
        )
    L = preduce(L, axis_name)
    return Tree(
        *out[:3],
        leaf_value=stream_leaf_values(L[:, :, 0], L[:, :, 1:], parent_value, y_mean),
        split_gain=out[3],
    )


def _fit_forest_streamed(Xb, vals, y_mean, thresholds, feature_mask, *,
                         max_depth, max_bins, min_info_gain, triangular,
                         round_bf16, return_leaf, lanes=1, axis_name=None):
    """The stream tier over resident bins: :func:`stream_forest` over row
    chunks of ``stream_chunk_rows`` (``_STREAM_CHUNK_ROWS`` unless an
    autotune override sets it).  Only a chunk's one-hots ever exist
    (``[chunk, d*B]``), never the matmul tier's ``[n, d*B]``, and nothing
    in the chunk loop reads a value back to the host.  The ragged last
    chunk is a shorter slice: the JAX package pads it with zero-weight
    rows, which add exactly 0."""
    n, d = Xb.shape
    M = vals.shape[1]
    # the chunk loop reads the bins once a level: kept as uint8 when ids
    # 0..B-1 fit, and upcast per chunk (a uint8 index would be a mask)
    if max_bins <= 256:
        Xb = Xb.to(torch.uint8)
    chunk = min(int(_tuned("stream_chunk_rows", _STREAM_CHUNK_ROWS, n=n)), n)
    spans = [(r0, min(r0 + chunk, n)) for r0 in range(0, n, chunk)]
    node = torch.zeros((n, M), dtype=torch.int32, device=Xb.device)

    def sweep(_tag):
        for r0, r1 in spans:
            yield Xb[r0:r1].to(torch.int32), node[r0:r1], vals[r0:r1]

    tree = stream_forest(
        sweep, y_mean, thresholds, feature_mask, d=d, max_depth=max_depth,
        max_bins=max_bins, min_info_gain=min_info_gain, triangular=triangular,
        round_bf16=round_bf16, lanes=lanes, axis_name=axis_name,
    )
    return (tree, node) if return_leaf else tree


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
    lanes: int = 1,  # M = lanes * K: each lane sums as its own K-member fit
    axis_name=None,  # a mesh fit's row axis (ops/collective.Axis)
):
    """Fit M trees at once on shared binned features -> stacked ``Tree``
    (leading member axis), optionally with each row's leaf id per member.

    One loop serves the dense tiers: the fused tier's branches are the JAX
    package's ``_fit_forest_fused`` (bins packed once; each level routes
    by the previous level's tables inside ``fused_round_level``), the
    others its dense ``fit_forest`` path, with histogram subtraction and
    its floors at the fast precisions on the matmul tier.  The stream tier
    is :func:`_fit_forest_streamed`.  With ``lanes`` every member equals
    the one its lane's own fit of K = M / lanes members gives, bit for bit
    (see the module docstring).

    Under a mesh, ``Xb``, ``Y`` and ``w`` hold this rank's rows and
    ``axis_name`` is the row axis: the root sums, every level histogram
    and the leaf sums are reduced across the ranks exactly where the JAX
    package psums them, so every rank takes the same splits; the tier
    resolves from the local row count, as shard_map's local shapes make it
    in the JAX package.  Each rank's kernels run on its own rows."""
    n, d = Xb.shape
    _, M, k = Y.shape
    B = max_bins
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

    if M % lanes:
        raise ValueError(f"{M} members do not split into {lanes} lanes")
    _, y_mean, vals = stream_vals_prep(Y, w, lanes, axis_name)
    stat_vals = _bf16_round(vals) if round_bf16 else vals
    if tier == "stream":
        return _fit_forest_streamed(
            Xb, stat_vals, y_mean, thresholds, feature_mask,
            max_depth=max_depth, max_bins=B, min_info_gain=min_info_gain,
            triangular=triangular, round_bf16=round_bf16,
            return_leaf=return_leaf, lanes=lanes, axis_name=axis_name,
        )
    red = None if axis_name is None else (lambda t: preduce(t, axis_name))

    out = _empty_splits(M, 2**max_depth - 1, dev)
    node = torch.zeros((n, M), dtype=torch.int32, device=dev)
    parent_value = y_mean[:, None, :]  # [M, 1, k]
    bin_oh = _bin_one_hot(Xb, B) if tier == "matmul" else None
    # the kernels' plan knobs, resolved once a fit (not once a launch)
    knobs = (level_knobs(3 if tier == "fused" else 2, n)
             if tier in ("pallas", "fused") and dev.type == "cuda" else None)
    if tier == "fused":
        bits = pack_width(B)
        # loop-invariant: packed once, read by every level's kernels
        packed = pack_bins(Xb, B, bits).packed
    tables = (None, None)  # previous level's (best_f, best_t), fused tier
    # the parents' histograms, weights and floors (histogram subtraction)
    prev_H = prev_W = prev_floor = None

    for level in range(max_depth):
        with span("tree.level"):
            n_nodes = 2**level
            derived = subtract and level >= 1
            if tier == "fused":
                H, node = fused_round_level(
                    packed, node, vals, tables[0], tables[1], n_nodes=n_nodes,
                    max_bins=B, bits=bits, num_features=d, lanes=lanes,
                    knobs=knobs,
                )
                H = preduce(H, axis_name)
            else:
                H = _level_hist(tier, Xb, bin_oh, node, stat_vals, n_nodes, B,
                                prev_H if derived else None, lanes, reduce=red,
                                knobs=knobs)
            with span("tree.split"):
                if derived:
                    # left children are direct (an empty one reads exactly
                    # 0.0); right children accumulate their parents' floors
                    # plus this level's rounding at the parent's weight: the
                    # sum, not a max
                    right_floor = prev_floor + _derived_hist_weight_floor(hp, prev_W)
                    node_floor = torch.stack(
                        [torch.full_like(right_floor, 1e-12), right_floor], dim=-1
                    ).reshape(M, n_nodes)
                else:
                    node_floor = torch.full((M, n_nodes), 1e-12,
                                            dtype=torch.float32, device=dev)
                best_f, best_t, node_w, next_parent = _write_level(
                    H, node_floor, feature_mask, min_info_gain, thresholds, B,
                    triangular, round_bf16, level, parent_value, out, lanes,
                )
            if tier == "fused":
                tables = (best_f.contiguous(), best_t.contiguous())  # routed in-kernel
            else:
                node = _route_members(Xb, node, best_f, best_t)
            parent_value = next_parent
            prev_H, prev_W, prev_floor = H, node_w, node_floor

    num_leaves = 2**max_depth
    if tier == "fused":
        with span("tree.leaf"):
            L, node = fused_round_level(
                packed, node, vals, tables[0], tables[1], n_nodes=num_leaves,
                max_bins=B, bits=bits, num_features=d, leaf=True, lanes=lanes,
            )
    elif tier == "scatter":
        L = leaf_plain(node, vals, num_leaves, ordered=True)
    else:
        L = _leaf_onehot_sums(node, stat_vals, num_leaves, lanes)
    L = preduce(L, axis_name)
    tree = Tree(
        *out[:3],
        leaf_value=stream_leaf_values(L[:, :, 0], L[:, :, 1:], parent_value, y_mean),
        split_gain=out[3],
    )
    # the final `node` is each row's leaf id: a fit-then-predict on the
    # same rows (the GBM round) reads leaf values by it instead of re-routing
    return (tree, node) if return_leaf else tree


def fit_tree(Xb, Y, w, thresholds, feature_mask=None, *, max_depth=5,
             max_bins=64, min_info_gain=0.0, hist="auto",
             hist_precision="highest", return_leaf=False, axis_name=None):
    """One tree (``Y f32[n, k]``, ``w f32[n]``): ``fit_forest`` with M=1,
    on every tier (the stream and fused tiers' single tree is their M=1
    case, as in the JAX package).

    As in the JAX package, a single tree at ``hist_precision="pallas"``
    runs on the 'high' matmul (or stream) tier, not on the kernel (the
    fused tier keeps its kernels)."""
    if hist_precision.lower() == "pallas" and hist.lower() != "fused":
        hist_precision = "high"
    mask = None if feature_mask is None else feature_mask.reshape(1, -1)
    out = fit_forest(
        Xb, Y[:, None, :], w[:, None], thresholds, mask,
        max_depth=max_depth, max_bins=max_bins, min_info_gain=min_info_gain,
        hist=hist, hist_precision=hist_precision, return_leaf=return_leaf,
        axis_name=axis_name,
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


def _clamp_features(X: torch.Tensor) -> torch.Tensor:
    """Raw features as f32 with NaN/+inf -> +_F32_MAX and -inf ->
    -_F32_MAX: NaN/+inf go right at every real split, -inf left."""
    return torch.nan_to_num(
        X.to(torch.float32), nan=_F32_MAX, posinf=_F32_MAX, neginf=-_F32_MAX
    )


def _walk(trees: Tree, X: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Heap walk of every member -> leaf ids ``i64[n, M]``: left iff the
    row's value at the node's feature is ``<= keys[m, node]`` (thresholds
    on clamped raw features, or split bins on bin ids)."""
    M, J = trees.split_feature.shape
    depth = (J + 1).bit_length() - 1
    m = torch.arange(M, device=X.device)[None, :]
    sf = trees.split_feature.long()
    node = torch.zeros((X.shape[0], M), dtype=torch.long, device=X.device)
    for _ in range(depth):
        x = X.gather(1, sf[m, node])
        node = 2 * node + torch.where(x <= keys[m, node], 1, 2)
    return node - J


def _leaf_ids(trees: Tree, X: torch.Tensor, binned: bool) -> torch.Tensor:
    """Leaf ids ``i64[n, M]`` of a stacked Tree on raw features (clamped)
    or on bin ids (``binned``: compared with the split bins)."""
    if binned:
        return _walk(trees, X, trees.split_bin)
    return _walk(trees, _clamp_features(X), trees.split_threshold)


def leaf_one_hot_forest(trees: Tree, X: torch.Tensor, binned: bool) -> torch.Tensor:
    """Exact leaf one-hot ``f32[n, M, 2^depth]`` of every member of a
    stacked Tree, on raw (``binned=False``) or binned features: the one-hot
    of the routed leaf ids, equal to the JAX package's path-score one-hot.
    Depth above ``_MATMUL_PREDICT_MAX_DEPTH`` raises, as there."""
    depth = (trees.split_feature.shape[-1] + 1).bit_length() - 1
    if depth > _MATMUL_PREDICT_MAX_DEPTH:
        raise ValueError(
            f"leaf one-hots support depth <= {_MATMUL_PREDICT_MAX_DEPTH}; got {depth}"
        )
    leaf = _leaf_ids(trees, X, binned)
    return torch.nn.functional.one_hot(leaf, 2**depth).to(torch.float32)


def leaf_one_hot(tree: Tree, X: torch.Tensor, binned: bool) -> torch.Tensor:
    """Exact leaf one-hot ``f32[n, 2^depth]`` of one tree (see
    :func:`leaf_one_hot_forest`): the linear-leaf learner's row-to-leaf
    routing."""
    return leaf_one_hot_forest(Tree(*(a[None] for a in tree)), X, binned)[:, 0]


def predict_forest(trees: Tree, X: torch.Tensor) -> torch.Tensor:
    """Member predict for a stacked ``Tree`` on raw features ``X[n, d]`` ->
    ``f32[M, n, k]``: a heap walk by gathers, bit-identical to the JAX
    package's path-scoring matmuls (both select one leaf value exactly)."""
    M = trees.split_feature.shape[0]
    Xc = _clamp_features(X)
    m = torch.arange(M, device=Xc.device)[None, :]
    cells = int(_tuned("predict_fused_max_cells", _PREDICT_MAX_CELLS, n=Xc.shape[0]))
    chunk = max(1, cells // max(M, 1))
    outs = [trees.leaf_value[m, _walk(trees, Xc[r0:r0 + chunk], trees.split_threshold)]
            for r0 in range(0, Xc.shape[0], chunk)]  # each [rows, M, k]
    return torch.cat(outs, dim=0).permute(1, 0, 2) if outs else (
        trees.leaf_value.new_zeros((M, 0, trees.leaf_value.shape[-1]))
    )


def predict_tree(tree: Tree, X: torch.Tensor) -> torch.Tensor:
    """``f32[n, k]`` leaf values of one tree on raw features ``X[n, d]``."""
    return predict_forest(Tree(*(a[None] for a in tree)), X)[0]


def predict_tree_binned(tree: Tree, Xb: torch.Tensor) -> torch.Tensor:
    """``f32[n, k]`` leaf values of one tree on binned features ``Xb[n,
    d]`` (rows go left iff their bin is at most the split bin)."""
    stacked = Tree(*(a[None] for a in tree))
    return tree.leaf_value[_leaf_ids(stacked, Xb, binned=True)[:, 0]]
