"""The level-histogram kernel's CTA plan
(``spark_ensemble_tpu_torch/ops/hist_kernels.py::level_plan``), checked on
the CPU: the kernel itself (``csrc/hist.cu::level_hist``) runs only on the
card, where chip_smoke.py holds it against its plain version.

Across levels 0-6, B in {16, 64, 256} and d in {1, 16, 33}, the plan is a
function of the shapes alone, fits one CTA's shared memory, uses clusters of
at most 8 CTAs that divide the grid, and its tiles cover every (member, node,
feature, row) exactly once."""

import numpy as np
import pytest

from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.ops.binning import pack_width

N, M, C = 15000, 26, 2  # the main path's rows, members and channels


def _tiles(plan, n, d, n_nodes):
    """The (member, feature, node, row) ranges of every CTA of the grid, in
    the kernel's blockIdx order: cluster rank fastest, then node tile,
    feature tile, member group."""
    n_pt = -(-n_nodes // plan.np)
    n_ft = -(-d // plan.nf)
    for bx in range(plan.grid):
        t, rank = divmod(bx, plan.cs)
        t, pt = divmod(t, n_pt)
        mt, ft = divmod(t, n_ft)
        m0, f0, p0 = mt * plan.g, ft * plan.nf, pt * plan.np
        r0 = min(n, rank * plan.rows_per_chunk)
        yield (
            range(m0, min(M, m0 + plan.g)),
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
    assert 1 <= plan.cs <= 8 and plan.grid % plan.cs == 0
    assert plan.threads == 32 * plan.g * plan.nf <= 512
    assert plan.cs * plan.rows_per_chunk >= N
    # every (member, feature, node) tile once per row chunk, and the row
    # chunks of a cluster partition the rows
    cover = np.zeros((M, d, n_nodes), np.int64)
    rows = {}
    for ms, fs, ps, rs in _tiles(plan, N, d, n_nodes):
        cover[ms.start:ms.stop, fs.start:fs.stop, ps.start:ps.stop] += 1
        rows.setdefault((ms.start, fs.start, ps.start), []).append(rs)
    assert (cover == plan.cs).all()
    for chunks in rows.values():
        seen = np.zeros(N, np.int64)
        for rs in chunks:
            seen[rs.start:rs.stop] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("n", [1, 127, 129, 14983])
def test_level_plan_row_chunks_at_ragged_n(n):
    """Small and prime row counts: no more chunks than row tiles, and the
    chunks still cover every row once."""
    plan = hk.level_plan(n, 16, M, C, 64, 16)
    assert plan.cs <= -(-n // plan.rows)
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
