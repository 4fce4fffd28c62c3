"""The level-histogram kernel's CTA plan
(``spark_ensemble_tpu_torch/ops/hist_kernels.py::level_plan``), checked on
the CPU: the kernel itself (``csrc/hist.cu::level_hist``) runs only on the
card, where chip_smoke.py holds it against its plain version.

Across levels 0-6, B in {16, 64, 256} and d in {1, 16, 33}, the plan is a
function of the shapes alone, fits one CTA's shared memory, uses clusters of
at most 8 CTAs that divide the grid, and its tiles cover every (member, node,
feature, row) exactly once.  At HIGGS's tall rows (10.5M x 28, one member)
a shallow level's tile takes several clusters, and the letter main path's
plans keep one.  Where a level tiles nodes and a CTA holds one member, the
plan walks row lists (``compact``): at the deep levels of the benchmark's
shapes, never on the letter main path or where a CTA holds several
members, whose plans stay as they were field by field."""

import numpy as np
import pytest
import torch

from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.ops.binning import pack_width

N, M, C = 15000, 26, 2  # the main path's rows, members and channels


def _tiles(plan, n, d, n_nodes, members=M):
    """The (member, feature, node, row) ranges of every CTA of the grid, in
    the kernel's blockIdx order: cluster rank fastest, then cluster, node
    tile, feature tile, member group."""
    n_pt = -(-n_nodes // plan.np)
    n_ft = -(-d // plan.nf)
    for bx in range(plan.grid):
        t, rank = divmod(bx, plan.cs)
        t, cl = divmod(t, plan.clusters)
        t, pt = divmod(t, n_pt)
        mt, ft = divmod(t, n_ft)
        m0, f0, p0 = mt * plan.g, ft * plan.nf, pt * plan.np
        r0 = min(n, (cl * plan.cs + rank) * plan.rows_per_chunk)
        yield (
            range(m0, min(members, m0 + plan.g)),
            range(f0, min(d, f0 + plan.nf)),
            range(p0, min(n_nodes, p0 + plan.np)),
            range(r0, min(n, r0 + plan.rows_per_chunk)),
        )


@pytest.mark.parametrize("tier", ["i32", "packed"])
@pytest.mark.parametrize("d", [1, 16, 33])
@pytest.mark.parametrize("B", [16, 64, 256])
@pytest.mark.parametrize("level", range(7))
def test_level_plan_fits_the_card_and_covers_the_level(level, B, d, tier):
    n_nodes = 2**level
    bits = 32 if tier == "i32" else pack_width(B)
    plan = hk.level_plan(N, d, M, C, B, n_nodes, bits)
    assert plan == hk.level_plan(N, d, M, C, B, n_nodes, bits)
    assert plan.smem <= 227 * 1024
    W = d if bits == 32 else -(-d // (32 // bits))
    slots = plan.nf if bits == 32 or W > plan.nf else W
    tags = plan.g * plan.nf * (-(-(plan.np * B) // 4) * 4)
    ring = hk._LEVEL_STAGES * plan.rows if plan.compact else 0  # listed rows
    assert plan.smem == tags + 4 * (
        plan.g * plan.nf * plan.np * C * B
        + hk._LEVEL_STAGES * plan.rows * (slots + plan.g + plan.g * C) + ring
    )
    assert plan.compact == (plan.np < n_nodes and plan.g == 1)
    assert plan.rows % 32 == 0
    assert 1 <= plan.cs <= 8 and plan.clusters >= 1
    assert plan.grid % (plan.cs * plan.clusters) == 0
    assert plan.threads == 32 * plan.g * plan.nf <= 512
    assert plan.cs * plan.clusters * plan.rows_per_chunk >= N
    _assert_covers(plan, N, d, M, n_nodes)


def _assert_covers(plan, n, d, members, n_nodes):
    """Every (member, feature, node) tile once per row chunk, and a tile's
    chunks, over all of its clusters, partition the rows."""
    cover = np.zeros((members, d, n_nodes), np.int64)
    rows = {}
    for ms, fs, ps, rs in _tiles(plan, n, d, n_nodes, members):
        cover[ms.start:ms.stop, fs.start:fs.stop, ps.start:ps.stop] += 1
        rows.setdefault((ms.start, fs.start, ps.start), []).append(rs)
    assert (cover == plan.cs * plan.clusters).all()
    for chunks in rows.values():
        seen = np.zeros(n, np.int64)
        for rs in chunks:
            seen[rs.start:rs.stop] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("n", [1, 127, 129, 14983])
def test_level_plan_row_chunks_at_ragged_n(n):
    """Small and prime row counts: no more chunks than row tiles, and the
    chunks still cover every row once."""
    plan = hk.level_plan(n, 16, M, C, 64, 16)
    assert plan.cs * plan.clusters <= -(-n // plan.rows)
    seen = np.zeros(n, np.int64)
    for ms, fs, ps, rs in _tiles(plan, n, 16, 16):
        if ms.start == 0 and fs.start == 0 and ps.start == 0:
            seen[rs.start:rs.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize(
    "C_,B_,d_", [(64, 4096, 4), (2, 1 << 20, 16), (1024, 64, 16)]
)
def test_level_plan_rejects_what_one_cta_cannot_hold(C_, B_, d_):
    with pytest.raises(ValueError, match="shared memory"):
        hk.level_plan(100, d_, 2, C_, B_, 1)


# higgs.fit's shapes: 10.5M rows, 28 features, one member, C = 2, 63 bins in
# 8-bit lanes, depth 8
HIGGS = dict(n=10_500_000, d=28, M=1, C=2, B=63, bits=8)


def _slots(plan):
    """The CTA slots of one wave that the plan counts."""
    per_sm = max(1, min(hk._SM_SMEM // (plan.smem + 1024), hk._SM_THREADS // plan.threads))
    return int(hk._CLUSTER_PACKING * hk._SMS * per_sm)


@pytest.mark.parametrize("level", range(8))
def test_level_plan_splits_tall_rows_over_clusters(level):
    """At HIGGS's shapes a shallow level has 2-8 tiles, so one cluster a
    tile leaves most of the card idle: levels 0-5 take several clusters a
    tile, levels 6-7 one.  The grid stays one wave, every CTA gets rows,
    and the staged-row knob moves neither the chunking nor the grid's
    clusters."""
    h, n_nodes = HIGGS, 2**level
    args = (h["n"], h["d"], h["M"], h["C"], h["B"], n_nodes, h["bits"])
    plan = hk.level_plan(*args)
    hk._level_plan.cache_clear()
    assert plan == hk.level_plan(*args)
    assert (plan.clusters > 1) == (level <= 5)
    tiles = plan.grid // (plan.cs * plan.clusters)
    assert plan.grid == tiles * plan.cs * plan.clusters <= _slots(plan)
    if plan.clusters > 1:
        # the cs one cluster a tile would take, and as many clusters as
        # fill the slots it leaves
        assert plan.clusters == _slots(plan) // (tiles * plan.cs)
    chunks = plan.cs * plan.clusters
    assert plan.rows_per_chunk == -(-h["n"] // chunks)
    assert (chunks - 1) * plan.rows_per_chunk < h["n"]  # no CTA without rows
    assert plan.rows_per_chunk >= plan.rows
    for R in (64, 256, 512):
        knob = hk.level_plan(*args, (R, hk._CTA_HIST_BYTES))
        assert (knob.cs, knob.clusters, knob.rows_per_chunk) == (
            plan.cs, plan.clusters, plan.rows_per_chunk)
        assert knob.grid // (knob.cs * knob.clusters) == tiles


@pytest.mark.parametrize("level", [0, 1, 2, 3, 5])
def test_tall_row_plans_cover_every_row_once(level):
    """The multi-cluster plans partition each tile's rows, at a row count
    small enough to walk (one member, 28 features; levels 0-5 split there
    too)."""
    n, n_nodes = 300_007, 2**level
    plan = hk.level_plan(n, 28, 1, 2, 63, n_nodes, 8)
    assert plan.clusters > 1
    _assert_covers(plan, n, 28, 1, n_nodes)


# the letter main path's plans (n = 15,000, d = 16, M = 26, C = 2, B = 64,
# 8-bit lanes) as they stood before tiles took more than one cluster:
# level -> (cs, rows_per_chunk)
LETTER_PLANS = {0: (8, 1875), 1: (8, 1875), 2: (8, 1875), 3: (8, 1875), 4: (4, 3750)}


@pytest.mark.parametrize("level", sorted(LETTER_PLANS))
def test_letter_main_path_keeps_one_cluster_a_tile(level):
    """One cluster a tile already fills the card there, so the plan, and
    with it every bit of the histograms, is unchanged."""
    plan = hk.level_plan(N, 16, M, C, 64, 2**level, 8)
    assert plan.clusters == 1
    assert (plan.cs, plan.rows_per_chunk) == LETTER_PLANS[level]
    assert plan.grid == M // plan.g * plan.cs


@pytest.mark.parametrize("lanes", [2, 12])
def test_lane_plan_takes_the_split_of_its_lane(lanes):
    """A sweep over one-member lanes at tall rows: the wide launch takes the
    one-member launch's row chunking, clusters included, so each lane sums
    as it would alone; its grid grows by its own tiles."""
    h = HIGGS
    args = (h["n"], h["d"], lanes * h["M"], h["C"], h["B"], 2, h["bits"])
    wide = hk.lane_level_plan(*args, lanes)
    lane = hk.level_plan(h["n"], h["d"], h["M"], h["C"], h["B"], 2, h["bits"])
    alone = hk.level_plan(*args)
    assert lane.clusters > 1
    assert (wide.cs, wide.clusters, wide.rows_per_chunk) == (
        lane.cs, lane.clusters, lane.rows_per_chunk)
    tiles = alone.grid // (alone.cs * alone.clusters)
    assert wide.grid == tiles * lane.cs * lane.clusters
    assert (wide.g, wide.nf, wide.np, wide.smem) == (alone.g, alone.nf, alone.np, alone.smem)


# the benchmark's shapes (benchmark/configs): one member, C = 2, 63 bins in
# 8-bit lanes, depth 8
EPSILON = dict(n=400_000, d=2_000, M=1, C=2, B=63, bits=8)


@pytest.mark.parametrize("level", range(8))
@pytest.mark.parametrize("cell", ["higgs", "epsilon"])
def test_compact_at_the_deep_levels_of_the_benchmark_shapes(cell, level):
    """Levels 6-7 tile their 64 and 128 nodes (32 a warp) at one member a
    CTA, so each node tile walks its own rows; levels 0-5 walk every row.
    A compact plan differs only by the flag and the ring of listed rows."""
    h = HIGGS if cell == "higgs" else EPSILON
    args = (h["n"], h["d"], h["M"], h["C"], h["B"], 2**level, h["bits"])
    plan = hk.level_plan(*args)
    assert plan.compact == (level >= 6)
    walk = hk._level_tiling(*args, hk._LEVEL_ROWS, hk._CTA_HIST_BYTES, compact=False)
    assert plan._replace(smem=walk.smem, compact=False) == walk
    assert plan.smem - walk.smem == (4 * hk._LEVEL_STAGES * plan.rows if plan.compact else 0)
    for R in (64, 512):  # the staged-row knob keeps the flag, as it keeps the chunking
        assert hk.level_plan(*args, (R, hk._CTA_HIST_BYTES)).compact == plan.compact


# plans as they stood before row lists (LevelPlan's fields g, nf, np, cs,
# clusters, rows_per_chunk, rows, grid, threads, smem): the letter main path
# (15,000 x 16, M = 26, B = 64, levels 0-4) and shapes whose CTAs hold
# several members (d <= 4), at (n, d, M, B, level)
UNLISTED_PLANS = {
    ("letter", 0): (1, 16, 1, 8, 1, 1875, 256, 208, 512, 30720),
    ("letter", 1): (1, 16, 2, 8, 1, 1875, 256, 208, 512, 39936),
    ("letter", 2): (1, 16, 4, 8, 1, 1875, 256, 208, 512, 58368),
    ("letter", 3): (1, 16, 8, 8, 1, 1875, 256, 208, 512, 95232),
    ("letter", 4): (1, 16, 16, 4, 1, 3750, 256, 104, 512, 168960),
    ((15000, 4, 26, 64), 6): (2, 4, 32, 4, 1, 3750, 256, 104, 256, 168960),
    ((15000, 4, 26, 64), 7): (2, 4, 32, 2, 1, 7500, 256, 104, 256, 168960),
    ((15000, 3, 2, 256), 5): (2, 3, 8, 8, 3, 625, 256, 96, 192, 132096),
    ((10_500_000, 4, 4, 63), 7): (2, 4, 32, 8, 1, 1312500, 256, 64, 256, 166656),
}


@pytest.mark.parametrize("shape,level", sorted(UNLISTED_PLANS, key=str))
def test_letter_and_multi_member_plans_walk_every_row_as_before(shape, level):
    """No row lists where a level has one node tile (the letter main path,
    at most 16 nodes) or a CTA holds several members: those plans, and with
    them every bit of their histograms, are unchanged field by field."""
    n, d, M_, B = (N, 16, M, 64) if shape == "letter" else shape
    plan = hk.level_plan(n, d, M_, C, B, 2**level, pack_width(B))
    assert not plan.compact
    assert tuple(plan)[:-1] == UNLISTED_PLANS[shape, level]


def test_lane_plan_walks_lists_where_its_lane_does():
    """One-member lanes of few features: alone, a lane's CTA holds its one
    member and walks row lists at a tiled level; the wide launch would
    hold two members a CTA, so it takes one a CTA and the lists too, with
    the lane's chunking, and each lane sums as it would alone."""
    a = dict(n=300_007, d=4, C=2, B=63, n_nodes=128, bits=8)
    lane = hk.level_plan(a["n"], a["d"], 1, a["C"], a["B"], a["n_nodes"], a["bits"])
    alone = hk.level_plan(a["n"], a["d"], 4, a["C"], a["B"], a["n_nodes"], a["bits"])
    wide = hk.lane_level_plan(a["n"], a["d"], 4, a["C"], a["B"], a["n_nodes"], a["bits"], 4)
    assert lane.compact and not alone.compact and alone.g > 1
    assert wide.compact and wide.g == 1
    assert (wide.cs, wide.clusters, wide.rows_per_chunk) == (
        lane.cs, lane.clusters, lane.rows_per_chunk)
    assert (wide.nf, wide.np, wide.rows, wide.smem) == (lane.nf, lane.np, lane.rows, lane.smem)
    assert wide.grid == 4 * lane.grid


@pytest.mark.parametrize("level", [6, 7])
def test_compact_chunks_cover_each_listed_row_once(level):
    """The kernel's walk of a compact plan: each (feature tile, node tile)
    splits its list evenly over its cs x clusters chunks; over the chunks
    every row whose node lies in the tile is taken once, and rows routed to
    -1 by none."""
    n, d, n_nodes = 50_021, 28, 2**level
    plan = hk.level_plan(n, d, 1, 2, 63, n_nodes, 8)
    assert plan.compact
    rng = np.random.RandomState(level)
    node = rng.randint(-1, n_nodes, size=(n, 1)).astype(np.int32)
    rows, offs = hk.level_rows_plain(torch.as_tensor(node), n_nodes, plan.np)
    rows, offs = rows.numpy(), offs.numpy()
    chunks = plan.cs * plan.clusters
    n_pt = -(-n_nodes // plan.np)
    for t in range(n_pt):
        count = offs[t + 1] - offs[t]
        per = -(-count // chunks)
        seen = np.zeros(n, np.int64)
        for k in range(chunks):
            lo, hi = min(count, k * per), min(count, k * per + per)
            seen[rows[offs[t] + lo:offs[t] + hi]] += 1
        mine = (node[:, 0] >= t * plan.np) & (node[:, 0] < (t + 1) * plan.np)
        assert (seen == mine).all()
