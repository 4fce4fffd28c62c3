"""Frozen byte and operation counts of a GBM fit on the fused tier, from
shapes alone.

Every input is counted as read once and every output as written once, in
4-byte elements, and an add per statistic cell a row touches: the least
work the algorithm needs, whatever kernels carry it out.  So the counts
stay valid when a later change replaces a kernel; a roofline share of
100% means the card moved those bytes at its published rate and nothing
more.

``kernel_work`` is a frozen copy of ``ops/hist_kernels.py::kernel_work``
of the port as it stood when the benchmark was defined
(``benchmark/tests/test_counts.py`` holds the two equal at the cells'
shapes); the program's copy may change, this one may not.  The fused
tier's histogram is counted as ``n*M*C*d`` adds, not as the one-hot
multiply-adds of the matmul tier.

The round's least work (:func:`round_work`) takes the histogram's count
as it is, but counts a route and the routed leaf pass as reading only the
lane of each row that holds its split feature's bin (``bits / 8`` bytes a
row and tree), not every packed word of the row: that lane is all the
step needs.  ``kernel_work`` counts the whole row, and the route on the
card beat that count's byte bound (105.8% on ``higgs.fit``, measured on
one H100): its parent ids come from L2 behind the level histogram that
read them just before.
"""

from __future__ import annotations

from typing import Dict, Tuple


def kernel_work(kernel: str, **shapes) -> Tuple[int, int]:
    """``(bytes, ops)`` of one launch of ``kernel`` at ``shapes``.

    - ``hist_packed`` (``n, d, W, M, C, B, n_nodes``): packed bin words,
      node ids and statistics in, the histogram ``[M, n_nodes, C, d, B]``
      out; ``n*M*C*d`` adds.
    - ``route_packed`` (``n, W, M, half``): packed words, parent ids and
      the two split tables in, child ids out; ``n*M`` compares.
    - ``leaf_sums`` (``n, M, C, leaves``, and ``W, half`` when it routes):
      words, parent ids and tables in, leaf ids out (when routed),
      statistics in, sums ``[M, leaves, C]`` out; ``n*M*C`` adds."""
    g = shapes.get
    if kernel == "hist_packed":
        n, d, M, C = g("n"), g("d"), g("M"), g("C")
        out = M * g("n_nodes") * C * d * g("B")
        return 4 * (n * g("W") + n * M + n * M * C + out), n * M * C * d
    if kernel == "route_packed":
        n, M = g("n"), g("M")
        return 4 * (n * g("W") + 2 * n * M + 2 * M * g("half")), n * M
    if kernel == "leaf_sums":
        n, M, C, half = g("n"), g("M"), g("C"), g("half", 0)
        ids = n * M * (2 if half else 1)
        return (4 * (n * g("W", 0) + ids + n * M * C + 2 * M * half
                     + M * g("leaves") * C), n * M * C)
    raise ValueError(f"no work model for kernel {kernel!r}")


def lane_bits(max_bins: int) -> int:
    """Bits of one packed bin id: 4 up to 16 bins, 8 up to 256."""
    return 4 if max_bins <= 16 else 8


def packed_words(d: int, max_bins: int) -> int:
    """32-bit words a row of packed bin ids takes."""
    return -(-d // (32 // lane_bits(max_bins)))


def route_least(*, n: int, M: int, half: int, max_bins: int) -> Tuple[int, int]:
    """``(bytes, ops)`` a route needs: each row's split-feature lane per
    tree, parent ids in, child ids out, the two split tables; one compare
    a row and tree."""
    return n * M * lane_bits(max_bins) // 8 + 4 * (2 * n * M + 2 * M * half), n * M


def leaf_least(*, n: int, M: int, C: int, leaves: int, half: int, max_bins: int) -> Tuple[int, int]:
    """``(bytes, ops)`` the routed leaf pass needs: the split-feature lane,
    parent ids in and leaf ids out, statistics in, tables, sums out; one
    add a statistic a row and tree."""
    return (n * M * lane_bits(max_bins) // 8
            + 4 * (2 * n * M + n * M * C + 2 * M * half + M * leaves * C), n * M * C)


# elementwise operations per (row, class) of the round's statistics:
# softmax (exp, sum, divide), gradient, hessian, its clamp, the Newton
# label and weight, the centred weighted target
_STAT_OPS = 8


def round_work(*, n: int, d: int, K: int, max_bins: int, depth: int) -> Dict[str, Tuple[int, int]]:
    """``{part: (bytes, ops)}`` of one boosting round of a ``K``-dim
    softmax GBM whose ``K`` trees of depth ``depth`` fit on ``n x d``
    rows: the three kernels' shares (``level_hist``, ``route_packed``,
    ``leaf_sums``) and ``other`` (statistics, directions, one pass of the
    step search, the prediction update)."""
    M, C, B = K, 2, max_bins
    W = packed_words(d, B)
    hist = [kernel_work("hist_packed", n=n, d=d, W=W, M=M, C=C, B=B, n_nodes=2**lv)
            for lv in range(depth)]
    route = [route_least(n=n, M=M, half=2 ** (lv - 1), max_bins=B) for lv in range(1, depth)]
    leaf = leaf_least(n=n, M=M, C=C, leaves=2**depth, half=2 ** (depth - 1), max_bins=B)
    # statistics: predictions and labels in, [n, M, C] statistics out
    stats = (4 * (n * K + n + n * M * C), _STAT_OPS * n * K)
    # directions: each row's leaf value per tree, read off its leaf id
    direction = (4 * (n * M + n * M + M * 2**depth), 0)
    # one pass of the step search: predictions, directions and labels in,
    # per class one gradient and hessian term (4 ops) per row
    search = (4 * (2 * n * K + n), 4 * n * K)
    # the update pred += w * direction
    update = (4 * 3 * n * K, 2 * n * K)
    other = tuple(sum(p[i] for p in (stats, direction, search, update)) for i in (0, 1))
    return {
        "level_hist": tuple(sum(h[i] for h in hist) for i in (0, 1)),
        "route_packed": tuple(sum(r[i] for r in route) for i in (0, 1)),
        "leaf_sums": leaf,
        "other": other,
    }


def binning_work(*, n: int, d: int, max_bins: int) -> Tuple[int, int]:
    """``(bytes, ops)`` of a fit's binning: the raw features in once, the
    packed bin ids out once, one compare per threshold a value is placed
    against (a binary search: ``ceil(log2(max_bins))``)."""
    W = packed_words(d, max_bins)
    return 4 * (n * d + n * W), n * d * max(1, (max_bins - 1).bit_length())


def fit_work(*, n: int, d: int, K: int, max_bins: int, depth: int, rounds: int) -> Dict[str, Tuple[int, int]]:
    """``{part: (bytes, ops)}`` of a whole fit: ``rounds`` rounds and one
    binning."""
    per = round_work(n=n, d=d, K=K, max_bins=max_bins, depth=depth)
    out = {k: (v[0] * rounds, v[1] * rounds) for k, v in per.items()}
    out["binning"] = binning_work(n=n, d=d, max_bins=max_bins)
    return out


def least_seconds(work: Tuple[int, int], peaks: dict) -> Tuple[float, str]:
    """The least time the card could take for ``work`` and what bounds
    it: the larger of bytes over the memory rate and operations over the
    float32 rate outside the tensor cores."""
    t_bytes = work[0] / peaks["bytes_per_s"]
    t_ops = work[1] / peaks["f32_ops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
