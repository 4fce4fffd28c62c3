"""The routed leaf pass on rows of any width
(``spark_ensemble_tpu_torch/ops/hist_kernels.py::leaf_plan`` and
``_leaf_routed``), and a fused fit on rows wider than the pass once took,
held to the benchmark's plain reference (``benchmark/reference/gbm.py``)
under the limits of the Epsilon-shaped cell.

The pass gathers each (row, member)'s one packed word and stages no rows,
so its plan is a function of the rows, members, statistics, leaves and
tables alone: no width raises, and every width runs the same tiling.  It
once staged two chunks of whole rows and took at most 112 words (448
features at 63 bins).  The kernel runs only on the card
(``chip_smoke.py --wide-rows`` holds it against the plain version there);
on the CPU the wrapper runs the plain version, so these tests hold the
plan, the wrapper's checks at each width and the fused path's arithmetic,
not the kernel's."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.reference import gbm as ref
from spark_ensemble_tpu_torch.models.gbm import GBMClassifier
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.ops.binning import pack_bins, pack_width

ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "epsilon.fit.json").read_text())["limits"]

# Epsilon's rows and a depth-8 tree of one member: 256 leaves from 128 parents
N, M, C, LEAVES, HALF = 400_000, 1, 2, 256, 128


def _rows_covered(plan, n):
    """How often the CTAs' row ranges cover each row; each CTA's range is
    whole chunks (``_LEAF_STEPS`` rows a lane of ``32 // g`` row slots and
    ``n_rw`` row warps) but the last."""
    RC = hk._LEAF_STEPS * plan.n_rw * (32 // plan.g)
    seen = torch.zeros(n, dtype=torch.int64)
    for b in range(plan.grid):
        r0 = min(n, b * plan.rows_per_cta)
        r1 = min(n, r0 + plan.rows_per_cta)
        seen[r0:r1] += 1
        assert (r1 - r0) % RC == 0 or r1 == n
    return seen


@pytest.mark.parametrize("W", [1, 7, 31, 112, 113, 500, 2000, 5000])
def test_leaf_plan_takes_rows_of_any_width(W):
    """The plan the routed pass launches for rows of W words fits the
    card and covers every row; the wrapper takes such rows, and routes and
    sums them as the plain versions do (257 rows, 4 features a word)."""
    plan = hk.leaf_plan(N, M, C, LEAVES, HALF)
    assert plan.smem <= hk._MAX_SMEM
    assert (_rows_covered(plan, N) == 1).all()
    n, d, B = 257, 4 * W, 63
    g = torch.Generator().manual_seed(W)
    ids = torch.randint(0, B, (n, d), generator=g, dtype=torch.int32)
    packed = pack_bins(ids, B, pack_width(B)).packed
    assert packed.shape[1] == W
    parent = torch.randint(0, HALF, (n, M), generator=g, dtype=torch.int32)
    bf = torch.randint(0, d, (M, HALF), generator=g, dtype=torch.int32)
    bt = torch.randint(0, B, (M, HALF), generator=g, dtype=torch.int32)
    vals = torch.randn((n, M, C), generator=g)
    L, leaf = hk.fused_round_level(packed, parent, vals, bf, bt, n_nodes=LEAVES, max_bins=B,
                                   bits=pack_width(B), num_features=d, leaf=True)
    want = hk.route_plain(ids, parent, bf, bt)
    assert torch.equal(leaf, want)
    assert torch.equal(L, hk.leaf_plain(want, vals, LEAVES))


@pytest.mark.parametrize(
    "shape,want",
    [
        # epsilon.fit: 400,000 rows, one tree (500 words a row: the staged
        # pass raised, needing 1,025,540 bytes)
        ((400_000, 1, 2, 256, 128),
         hk.LeafPlan(g=1, n_mg=1, n_rw=8, LT=64, cs=8, grid=104, rows_per_cta=4096,
                     threads=256, smem=148484)),
        # higgs.fit: 10.5M rows, one tree (7 words a row; staged, the pass
        # took n_rw=4, 128 threads and 140,292 bytes)
        ((10_500_000, 1, 2, 256, 128),
         hk.LeafPlan(g=1, n_mg=1, n_rw=8, LT=64, cs=8, grid=128, rows_per_cta=83968,
                     threads=256, smem=148484)),
        # letter's main path: 26 members, depth 5 (4 words a row; staged,
        # the same tiling in 79,108 bytes)
        ((15000, 26, 2, 32, 16),
         hk.LeafPlan(g=26, n_mg=1, n_rw=8, LT=32, cs=8, grid=240, rows_per_cta=64,
                     threads=256, smem=77060)),
    ],
)
def test_plans_at_the_cells_shapes_keep_every_warp(shape, want):
    hk.leaf_plan.cache_clear()
    assert hk.leaf_plan(*shape) == want


def _table(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((n, d), generator=g)
    beta = torch.randn((d,), generator=torch.Generator().manual_seed(2))
    y = ((X @ beta / d ** 0.5 + torch.randn((n,), generator=g)) > 0).to(torch.float32)
    return X, y


def test_a_fused_fit_on_rows_wider_than_any_staged_plan_matches_the_reference():
    """640 x 600 at 63 bins: 150 packed words a row, past the 112 the
    staged pass took at most.  Three rounds of depth 3 followed by the
    reference node by node."""
    n, d, depth, B, rounds = 640, 600, 3, 63, 3
    assert -(-d // (32 // pack_width(B))) == 150
    X, y = _table(n, d, seed=7)
    est = GBMClassifier(
        loss="bernoulli", updates="newton", optimized_weights=True, learning_rate=0.1,
        num_base_learners=rounds,
        base_learner=DecisionTreeRegressor(max_depth=depth, max_bins=B, hist="fused",
                                           hist_precision="highest"))
    model = est.fit(X, y, device="cpu")
    m = model.params["members"]
    arrays = {"split_feature": m.split_feature, "split_bin": m.split_bin,
              "split_threshold": m.split_threshold, "split_gain": m.split_gain,
              "leaf_value": m.leaf_value[..., 0], "weights": model.params["weights"]}
    numbers = ref.check_fit(X, y, arrays, loss="bernoulli", num_classes=2, max_bins=B,
                            learning_rate=0.1, check_rounds=range(rounds))
    assert set(numbers) >= set(LIMITS)
    assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers
