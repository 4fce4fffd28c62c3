"""The fused tier's leaf mode and route on the CPU
(``spark_ensemble_tpu_torch/ops/hist_kernels.py``): the leaf pass routed
and summed in one call against the JAX package's ``fused_round_level(leaf=
True)`` in interpret mode, the table checks of that call, and the CTA plans
of the two kernels (``leaf_plan``, ``route_plan``).  The kernels themselves
(``csrc/hist.cu::leaf_sums``, ``route_packed``) run only on the card, where
chip_smoke.py holds them against these plain versions.

Tolerances: leaf ids are integer-exact (array-equal).  On dyadic statistics
every f32 sum is exact in any order, so leaf sums are array-equal too; on
random statistics only the order of the f32 sum differs (rtol 1e-6, with an
absolute floor at 1e-6 of the largest sum)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_ensemble_tpu.ops import pallas_hist as jp
from spark_ensemble_tpu.ops.binning import pack_bins as j_pack_bins
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.ops.binning import pack_bins, pack_width


def _vals(rng, n, M, C, dyadic, zero_frac):
    if dyadic:
        v = rng.randint(-8, 9, size=(n, M, C)) / 4.0
    else:
        v = np.concatenate([rng.rand(n, M, 1), rng.randn(n, M, C - 1)], axis=2)
    v = v.astype(np.float32)
    v[: int(n * zero_frac)] = 0.0
    return v


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize(
    "M,n,zero_frac,B,half",
    [
        (26, 700, 0.0, 64, 16),  # the main path's members and leaves
        (26, 677, 0.25, 16, 16),  # prime n, 4-bit lanes
        (1, 700, 0.0, 64, 16),  # the regressor
        (1, 677, 0.25, 16, 16),
        (26, 263, 0.25, 64, 0),  # max_depth = 0: no tables, one leaf
    ],
)
def test_routed_leaf_mode_matches_the_jax_kernel(M, n, zero_frac, B, half, dyadic):
    rng = np.random.RandomState(n + M + B)
    d, C = 8, 2
    bits = pack_width(B)
    Xb = rng.randint(0, B, size=(n, d)).astype(np.int32)
    vals = _vals(rng, n, M, C, dyadic, zero_frac)
    if half:
        n_nodes = 2 * half
        node = rng.randint(0, half, size=(n, M)).astype(np.int32)
        tables = (
            rng.randint(0, d, size=(M, half)).astype(np.int32),
            rng.randint(0, B, size=(M, half)).astype(np.int32),
        )
    else:
        n_nodes, node, tables = 1, np.zeros((n, M), np.int32), ()
    kw = dict(n_nodes=n_nodes, max_bins=B, bits=bits, num_features=d, leaf=True)
    jL, jleaf = jp.fused_round_level(
        j_pack_bins(jnp.asarray(Xb), B, bits).packed, jnp.asarray(node),
        jnp.asarray(vals), *[jnp.asarray(t) for t in tables], **kw,
    )
    hk.reset_launch_counts()
    tL, tleaf = hk.fused_round_level(
        pack_bins(torch.as_tensor(Xb), B, bits).packed, torch.as_tensor(node),
        torch.as_tensor(vals), *[torch.as_tensor(t) for t in tables], **kw,
    )
    assert all(v == 0 for v in hk.LAUNCHES.values())  # the plain version
    assert tL.shape == (M, n_nodes, C) and tleaf.shape == (n, M)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    jL = np.asarray(jL)
    if dyadic:
        np.testing.assert_array_equal(tL.numpy(), jL)
    else:
        np.testing.assert_allclose(tL.numpy(), jL, rtol=1e-6, atol=1e-6 * np.abs(jL).max())


def test_routed_leaf_rejects_malformed_tables():
    n, d, M, C, B, half = 64, 8, 3, 2, 16, 4
    packed = pack_bins(torch.zeros((n, d), dtype=torch.int32), B).packed
    node = torch.zeros((n, M), dtype=torch.int32)
    vals = torch.zeros((n, M, C))
    bf = torch.zeros((M, half), dtype=torch.int32)
    bt = torch.zeros((M, half), dtype=torch.int32)

    def call(f, t, n_nodes=2 * half, p=packed):
        return hk.fused_round_level(p, node, vals, f, t, n_nodes=n_nodes, max_bins=B,
                                    bits=4, num_features=d, leaf=True)

    call(bf, bt)  # well-formed
    with pytest.raises(ValueError, match="int32"):
        call(bf.long(), bt)
    with pytest.raises(ValueError, match=r"\[M, half\]"):
        call(torch.zeros((M + 1, half), dtype=torch.int32), torch.zeros((M + 1, half), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[M, half\]"):
        call(bf, torch.zeros((M, half + 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="come together"):
        call(bf, None)
    with pytest.raises(ValueError, match="route into"):
        call(bf, bt, n_nodes=half)
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.zeros((half, M), dtype=torch.int32).T, bt)
    with pytest.raises(ValueError, match="disagree on rows"):
        call(bf, bt, p=packed[:-1].contiguous())
    with pytest.raises(ValueError, match="different devices"):
        call(bf.to("meta"), bt.to("meta"))


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

# (n, M, C, leaves, half, W): the main path (15000 rows, 26 members, 32
# leaves, 16 features in 8-bit lanes), the regressor (one member), 256
# leaves, more members than lanes, more members than one tile holds, a
# prime n with C = 3, and the unrouted pass (max_depth = 0: one leaf, no
# tables)
LEAF_SHAPES = [
    (15000, 26, 2, 32, 16, 4),
    (8192, 1, 2, 32, 16, 2),
    (15000, 26, 2, 256, 128, 4),
    (15000, 40, 2, 32, 16, 4),
    (2000, 300, 2, 32, 16, 4),
    (14983, 26, 3, 64, 32, 4),
    (15000, 26, 2, 1, 0, 0),
]


def _leaf_cover(plan, n, M, leaves):
    """How often the kernel's loops visit each (row, member) in each leaf
    tile: CTA b takes rows [b, b + 1) * rows_per_cta in chunks of
    RC = steps * n_rw * S rows; lane (slot, member) of row warp rw takes row
    (u * n_rw + rw) * S + slot of a chunk at step u; member tiles of
    MT = n_mg * g members, leaf tiles of LT leaves."""
    S = 32 // plan.g
    RC = hk._LEAF_STEPS * plan.n_rw * S
    rows = np.zeros(n, np.int64)
    for b in range(plan.grid):
        r0 = min(n, b * plan.rows_per_cta)
        r1 = min(n, r0 + plan.rows_per_cta)
        for c0 in range(r0, r1, RC):
            for u in range(hk._LEAF_STEPS):
                for rw in range(plan.n_rw):
                    r = c0 + (u * plan.n_rw + rw) * S + np.arange(S)
                    rows[r[r < r1]] += 1
    members = np.zeros(M, np.int64)
    MT = plan.n_mg * plan.g
    for m0 in range(0, M, MT):
        mt = min(MT, M - m0)
        for mg in range(plan.n_mg):
            mm = mg * plan.g + np.arange(plan.g)
            members[m0 + mm[mm < mt]] += 1
    tiles = np.zeros(leaves, np.int64)
    for l0 in range(0, leaves, plan.LT):
        tiles[l0:l0 + plan.LT] += 1
    return rows, members, tiles


@pytest.mark.parametrize("n,M,C,leaves,half,W", LEAF_SHAPES)
def test_leaf_plan_fits_the_card_and_covers_every_row_member_and_leaf(n, M, C, leaves, half, W):
    plan = hk.leaf_plan(n, M, C, leaves, half, W)
    hk.leaf_plan.cache_clear()
    assert plan == hk.leaf_plan(n, M, C, leaves, half, W)  # the shapes alone
    assert plan.smem <= 227 * 1024
    MT = plan.n_mg * plan.g
    RC = hk._LEAF_STEPS * plan.n_rw * (32 // plan.g)
    # the kernel's layout: the warps' columns, the partial (one more set of
    # columns per member group), tables, two chunks of packed words, a flag
    cols = plan.LT * C * 32
    assert plan.smem == 4 * (plan.n_mg * (plan.n_rw + 1) * cols + 2 * MT * half + 2 * RC * W + 1)
    assert plan.threads == 32 * plan.n_mg * plan.n_rw <= 512
    assert 1 <= plan.g <= 32 and 1 <= plan.cs <= 8 and plan.grid % plan.cs == 0
    assert plan.LT * C * 128 <= 16 * 1024 or plan.LT == 1
    rows, members, tiles = _leaf_cover(plan, n, M, leaves)
    assert (rows == 1).all() and (members == 1).all() and (tiles == 1).all()


def test_leaf_plan_at_the_main_path_fills_the_card_in_clusters():
    """26 lanes a warp, one row a warp-step, all 32 leaves in one tile, and
    about 2 CTAs an SM in clusters of 8 (the card has 132 SMs)."""
    plan = hk.leaf_plan(15000, 26, 2, 32, 16, 4)
    assert (plan.g, plan.n_mg, plan.LT, plan.cs) == (26, 1, 32, 8)
    assert 132 <= plan.grid <= 2 * 132


@pytest.mark.parametrize(
    "args",
    [
        (100, 2, 2048, 1, 0, 0),  # one warp's column of one leaf: 256 KB
        (100, 26, 2, 2**16, 2**15, 4),  # one member group's tables: 6.8 MB
    ],
)
def test_leaf_plan_raises_where_no_tiling_fits(args):
    with pytest.raises(ValueError, match=r"shared memory \(M="):
        hk.leaf_plan(*args)


@pytest.mark.parametrize(
    "n,M,half,W",
    [(15000, 26, 8, 4), (8192, 1, 16, 2), (15000, 40, 16, 4), (14983, 26, 128, 4),
     (15000, 1000, 8, 4), (101, 26, 1, 250)],
)
def test_route_plan_fits_the_card_and_covers_every_element(n, M, half, W):
    plan = hk.route_plan(n, M, half, W)
    hk.route_plan.cache_clear()
    assert plan == hk.route_plan(n, M, half, W)
    assert plan.smem == 8 * M * half + 4 * plan.rows * W <= 227 * 1024
    assert plan.rows >= 4 and plan.rows % 4 == 0
    assert plan.rows * W * 4 <= 32 * 1024 or plan.rows == 4
    assert 1 <= plan.grid <= 132 * 8
    # CTA b takes tiles b, b + grid, ...: every tile once
    tiles = math.ceil(n / plan.rows)
    seen = np.zeros(tiles, np.int64)
    for b in range(plan.grid):
        seen[b::plan.grid] += 1
    assert (seen == 1).all()
    # a thread's quads, walked without a division as the kernel walks them,
    # land on (row, member) = divmod(element, M), every element once, in
    # the last (ragged) tile too
    T = hk._ROUTE_THREADS
    rows = n - (tiles - 1) * plan.rows
    count = rows * M
    hits = np.zeros(count, np.int64)
    for tid in range(T):
        q, r = divmod(4 * tid, M)
        dq, dr = divmod(4 * T, M)
        for e in range(4 * tid, count, 4 * T):
            row, m = q, r
            for j in range(4):
                if e + j < count:
                    assert (row, m) == divmod(e + j, M)
                    hits[e + j] += 1
                m += 1
                if m == M:
                    m, row = 0, row + 1
            q, r = q + dq, r + dr
            if r >= M:
                q, r = q + 1, r - M
    assert (hits == 1).all()


def test_route_plan_raises_where_the_tables_do_not_fit():
    with pytest.raises(ValueError, match=r"shared memory \(M="):
        hk.route_plan(100, 26, 2**11, 4)  # 26 x 2048 table entries: 425 KB
