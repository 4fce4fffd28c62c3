"""The level-histogram kernel's CTA plan
(``spark_ensemble_tpu_torch/ops/hist_kernels.py::level_plan``), checked on
the CPU: the kernel itself (``csrc/hist.cu::level_hist``) runs only on the
card, where chip_smoke.py holds it against its plain version.

Across levels 0-6, B in {16, 64, 256} and d in {1, 16, 33}, the plan is a
function of the shapes alone, fits one CTA's shared memory, uses clusters of
at most 8 CTAs that divide the grid, and its tiles cover every (member, node,
feature, row) exactly once.  At HIGGS's tall rows (10.5M x 28, one member)
a shallow level's tile takes several clusters, and the letter main path's
plans keep one."""

import numpy as np
import pytest

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
    assert plan.smem == tags + 4 * (
        plan.g * plan.nf * plan.np * C * B
        + hk._LEVEL_STAGES * plan.rows * (slots + plan.g + plan.g * C)
    )
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
