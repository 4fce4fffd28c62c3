"""PyTorch port parity: the histogram kernels' plain versions
(``spark_ensemble_tpu_torch/ops/hist_kernels.py``) against the JAX
package's Pallas kernels (``ops/pallas_hist.py``), which run in interpret
mode on the CPU as in tests/test_pallas_hist.py.

Tolerances: on dyadic values the bf16 split is exact and every f32 sum is
exact in any order, so histograms agree to 1e-5 absolute; on random values
the per-row split terms are the same and only the summation order differs
(rtol 1e-5, with an absolute floor at 1e-6 of the largest cell for cells
that cancel to near zero).  Routing is integer-exact: node ids are
array-equal.  Leaf sums are plain f32 (rtol 1e-6).

The CUDA kernels themselves run only on the card; chip_smoke.py holds each
against these plain versions there; tests/test_torch_leaf_route.py holds
the routed leaf mode and the leaf and route plans."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_ensemble_tpu.ops import pallas_hist as jp
from spark_ensemble_tpu.ops.binning import pack_bins as j_pack_bins
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.ops.binning import pack_bins, pack_width


def _vals(rng, n, M, C, dyadic, zero_frac=0.0):
    if dyadic:
        v = rng.randint(-8, 9, size=(n, M, C)) / 4.0
    else:
        v = np.concatenate(
            [rng.rand(n, M, 1), rng.randn(n, M, C - 1)], axis=2
        )
    v = v.astype(np.float32)
    v[: int(n * zero_frac)] = 0.0
    return v


def _assert_hist_close(got, ref, dyadic):
    if dyadic:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max()
        )


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize(
    "n,d,M,C,n_nodes,B,zero_frac",
    [(500, 4, 3, 2, 4, 8, 0.0), (277, 3, 2, 2, 2, 16, 0.25)],
)
def test_hist_level_pallas_plain_matches_kernel(n, d, M, C, n_nodes, B,
                                                 zero_frac, dyadic):
    rng = np.random.RandomState(n)
    Xb = rng.randint(0, B, size=(n, d)).astype(np.int32)
    node = rng.randint(0, n_nodes, size=(n, M)).astype(np.int32)
    vals = _vals(rng, n, M, C, dyadic, zero_frac)
    ref = np.asarray(jp.hist_level_pallas(
        jnp.asarray(Xb), jnp.asarray(node), jnp.asarray(vals),
        n_nodes=n_nodes, max_bins=B,
    ))
    got = hk.hist_level_pallas(
        torch.as_tensor(Xb), torch.as_tensor(node), torch.as_tensor(vals),
        n_nodes=n_nodes, max_bins=B,
    )
    assert got.shape == (M, n_nodes, C, d, B)
    _assert_hist_close(got.numpy(), ref, dyadic)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("B", [16, 64])  # 4-bit and 8-bit lanes
@pytest.mark.parametrize("mode", ["level0", "routed", "leaf"])
def test_fused_round_level_plain_matches_kernel(mode, B, dyadic):
    rng = np.random.RandomState(B + len(mode))
    n, d, M, C = 263, 6, 3, 2  # prime n
    bits = pack_width(B)
    Xb = rng.randint(0, B, size=(n, d)).astype(np.int32)
    vals = _vals(rng, n, M, C, dyadic, zero_frac=0.25)
    jpacked = j_pack_bins(jnp.asarray(Xb), B, bits).packed
    tpacked = pack_bins(torch.as_tensor(Xb), B, bits).packed
    kw = dict(max_bins=B, bits=bits, num_features=d)
    if mode == "level0":
        n_nodes, node, tables = 1, np.zeros((n, M), np.int32), ()
    else:
        half = 4
        n_nodes = 2 * half
        node = rng.randint(0, half, size=(n, M)).astype(np.int32)
        tables = (
            rng.randint(0, d, size=(M, half)).astype(np.int32),
            rng.randint(0, B, size=(M, half)).astype(np.int32),
        )
    leaf = mode == "leaf"
    jH, jnode = jp.fused_round_level(
        jpacked, jnp.asarray(node), jnp.asarray(vals),
        *[jnp.asarray(t) for t in tables], n_nodes=n_nodes, leaf=leaf, **kw,
    )
    tH, tnode = hk.fused_round_level(
        tpacked, torch.as_tensor(node), torch.as_tensor(vals),
        *[torch.as_tensor(t) for t in tables], n_nodes=n_nodes, leaf=leaf, **kw,
    )
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))
    if leaf:
        assert tH.shape == (M, n_nodes, C)
        np.testing.assert_allclose(
            tH.numpy(), np.asarray(jH), rtol=1e-6,
            atol=1e-6 * np.abs(np.asarray(jH)).max(),
        )
    else:
        assert tH.shape == (M, n_nodes, C, d, B)
        _assert_hist_close(tH.numpy(), np.asarray(jH), dyadic)


def test_split_terms_match_the_tpu_split():
    """The per-row terms the kernels sum: hi + lo (2 terms) and
    hi + lo + lo2 (3 terms) of the bf16 split, computed the way the JAX
    kernels compute them."""
    v = torch.as_tensor(np.random.RandomState(0).randn(1000).astype(np.float32))
    vj = jnp.asarray(v.numpy())
    hi = vj.astype(jnp.bfloat16).astype(jnp.float32)
    lo = (vj - hi).astype(jnp.bfloat16).astype(jnp.float32)
    lo2 = (vj - hi - lo).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(hk.split_terms(v, 2).numpy(), np.asarray(hi + lo))
    np.testing.assert_array_equal(
        hk.split_terms(v, 3).numpy(), np.asarray(hi + lo + lo2)
    )
    assert hk.split_terms(v, 1) is v


def test_wrappers_reject_what_the_kernels_do_not_take():
    n, d, M, C = 32, 4, 2, 2
    Xb = torch.zeros((n, d), dtype=torch.int32)
    node = torch.zeros((n, M), dtype=torch.int32)
    vals = torch.zeros((n, M, C))
    with pytest.raises(ValueError, match="int32"):
        hk.hist_level_pallas(Xb.long(), node, vals, n_nodes=1, max_bins=8)
    with pytest.raises(ValueError, match="contiguous"):
        hk.hist_level_pallas(
            torch.zeros((d, n), dtype=torch.int32).T, node, vals,
            n_nodes=1, max_bins=8,
        )
    with pytest.raises(ValueError, match="disagree"):
        hk.hist_level_pallas(Xb, node, torch.zeros((n, M + 1, C)),
                             n_nodes=1, max_bins=8)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        hk.hist_level_pallas(Xb.to("meta"), node.to("meta"), vals.to("meta"),
                             n_nodes=1, max_bins=8)
    with pytest.raises(ValueError, match="words per row"):
        hk.hist_level_packed(torch.zeros((n, 3), dtype=torch.int32), node, vals,
                             n_nodes=1, max_bins=16, bits=4, num_features=d)


def test_plain_versions_never_count_launches():
    hk.reset_launch_counts()
    rng = np.random.RandomState(3)
    n, d, M, B = 64, 4, 2, 16
    Xb = torch.as_tensor(rng.randint(0, B, size=(n, d)).astype(np.int32))
    node = torch.zeros((n, M), dtype=torch.int32)
    vals = torch.ones((n, M, 2))
    hk.hist_level_pallas(Xb, node, vals, n_nodes=1, max_bins=B)
    hk.fused_round_level(pack_bins(Xb, B).packed, node, vals, n_nodes=1,
                         max_bins=B, bits=4, num_features=d)
    assert all(v == 0 for v in hk.LAUNCHES.values())


@pytest.mark.parametrize(
    "n_nodes,leaf", [(1, False), (16, False), (32, True), (1024, False)]
)
def test_hist_plan_at_the_main_path_shapes(n_nodes, leaf):
    """The CTA tiling is a function of the shapes alone (so is the
    summation order), fits the card's shared memory, and covers every
    row, node and feature: the leaf pass's plan (``leaf_plan``, routed
    through 16 parents' tables over 4 packed words a row;
    tests/test_torch_leaf_route.py has more) and the level histograms'
    (``level_plan``, tests/test_torch_hist_plan.py has more)."""
    n, d, M, C, B = 15000, 16, 26, 2, 64
    if leaf:
        plan = hk.leaf_plan(n, M, C, n_nodes, n_nodes // 2, 4)
        hk.leaf_plan.cache_clear()
        assert plan == hk.leaf_plan(n, M, C, n_nodes, n_nodes // 2, 4)
        assert plan.smem <= 227 * 1024
        assert plan.grid * plan.rows_per_cta >= n
        assert (plan.grid - plan.cs) * plan.rows_per_cta < n  # no cluster without rows
        assert 1 <= plan.cs <= 8 and plan.grid % plan.cs == 0
        assert plan.threads == 32 * plan.n_mg * plan.n_rw <= 512
        assert plan.g == M and plan.n_mg == 1  # one lane per member
        assert plan.LT == n_nodes  # every leaf in one tile
        return
    plan = hk.level_plan(n, d, M, C, B, n_nodes)
    assert plan == hk.level_plan(n, d, M, C, B, n_nodes)
    assert plan.smem <= 227 * 1024
    assert plan.cs * plan.rows_per_chunk >= n
    assert (plan.cs - 1) * plan.rows_per_chunk < n
    assert 1 <= plan.cs <= 8 and plan.threads == 32 * plan.g * plan.nf <= 512
    tiles = -(-M // plan.g) * -(-d // plan.nf) * -(-n_nodes // plan.np)
    assert plan.grid == tiles * plan.cs
    assert plan.np >= 1 and plan.nf >= 1 and plan.g >= 1


def test_hist_plan_rejects_tiles_over_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        hk.leaf_plan(100, 2, 2048, 1)  # one leaf's columns of one warp: 256 KB
    with pytest.raises(ValueError, match="shared memory"):
        hk.level_plan(100, 4, 2, 64, 4096, 1)
