"""The port's cross-rank reductions (``ops/collective.py``): identities
when unsharded or on a one-rank axis; across 4 gloo ranks, ``preduce`` is
the rank-order pairwise sum of the gathered tensors, bit for bit on every
rank, ``pmax_reduce``/``pmin_reduce`` are exact, and ``pgather``
concatenates in rank order.  ``pairwise_sum`` is the sum the GBM models'
``_weighted_round_sum`` always took."""

import os

import numpy as np
import pytest
import torch

import _torch_mesh_worker as mw
from spark_ensemble_tpu_torch.models.gbm import _weighted_round_sum
from spark_ensemble_tpu_torch.ops import collective as coll


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("collective")
    try:
        mw.free_port()
    except OSError as e:  # the sandbox forbids loopback sockets
        pytest.skip(f"no loopback sockets: {e}")
    mw.spawn("collective", str(out), timeout=300)
    return [dict(np.load(os.path.join(out, f"collective_r{r}.npz"))) for r in range(mw.W)]


@pytest.mark.parametrize("fn", [coll.preduce, coll.pmax_reduce, coll.pmin_reduce])
def test_unsharded_is_the_identity(fn):
    x = torch.randn(4, 3)
    assert fn(x, None) is x


def test_pgather_unsharded_is_the_identity():
    x = torch.randn(4, 3)
    assert coll.pgather(x, None, dim=1) is x


@pytest.mark.parametrize("key", ["one_sum", "one_max", "one_min"])
def test_one_rank_axis_is_the_identity(runs, key):
    for r in range(mw.W):
        np.testing.assert_array_equal(runs[r][key], runs[r]["x"])


def _pairwise(stack):
    return coll.pairwise_sum(torch.from_numpy(np.stack(stack))).numpy()


def test_preduce_is_the_rank_order_pairwise_sum_on_every_rank(runs):
    want = _pairwise([runs[r]["x"] for r in range(mw.W)])
    for r in range(mw.W):
        np.testing.assert_array_equal(runs[r]["sum"], want)


def test_preduce_of_a_list_is_one_gather_of_the_same_sums(runs):
    xs = [runs[r]["x"] for r in range(mw.W)]
    want = np.concatenate([_pairwise(xs).reshape(-1),
                           _pairwise([2 * x[0] for x in xs]).reshape(-1)])
    for r in range(mw.W):
        np.testing.assert_array_equal(runs[r]["sum_pair"], want)
    # sum, sum_pair, gather and the one-rank sum: four gathers (max and
    # min are all_reduce)
    assert int(runs[0]["gathers"]) == 4


@pytest.mark.parametrize("key,fn", [("max", np.max), ("min", np.min)])
def test_pmax_pmin_are_exact(runs, key, fn):
    want = fn(np.stack([runs[r]["x"] for r in range(mw.W)]), axis=0)
    for r in range(mw.W):
        np.testing.assert_array_equal(runs[r][key], want)


def test_pgather_concatenates_in_rank_order(runs):
    base = np.arange(6, dtype=np.int32).reshape(2, 3)
    want = np.concatenate([base + 10 * r for r in range(mw.W)], axis=1)
    for r in range(mw.W):
        np.testing.assert_array_equal(runs[r]["gather"], want)


def test_gathered_bytes_are_counted(runs):
    # sum: 105 f32; sum_pair: 105 + 35 f32; gather: 6 i32; one-rank sum: 105 f32
    assert int(runs[0]["bytes"]) == (105 + 140 + 105) * 4 + 6 * 4


def _former_round_sum(weights, preds):
    """``_weighted_round_sum`` as it was before the helper moved."""
    terms = weights[..., None] * preds
    r = terms.shape[0]
    while r > 1:
        half = r // 2
        paired = terms[:half] + terms[half:2 * half]
        terms = torch.cat((paired, terms[2 * half:r])) if r % 2 else paired
        r = terms.shape[0]
    return terms[0]


@pytest.mark.parametrize("rounds", [1, 2, 3, 5, 64, 100])
def test_round_sum_equals_its_former_results(rounds):
    g = torch.Generator().manual_seed(rounds)
    w, p = torch.randn((rounds, 4), generator=g), torch.randn((rounds, 4, 33), generator=g)
    assert torch.equal(_weighted_round_sum(w, p), _former_round_sum(w, p))


def test_pairwise_sum_is_within_float32_rounding_of_float64():
    x = torch.randn(37, 11, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(coll.pairwise_sum(x).numpy(),
                               x.double().sum(0).numpy(), rtol=1e-5, atol=1e-5)
