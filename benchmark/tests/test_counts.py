"""The frozen work counts against the port's ``kernel_work`` as it
stands, at the cells' shapes."""

import pytest

from benchmark.counts import work
from benchmark.harness import spec
from spark_ensemble_tpu_torch.ops import hist_kernels
from spark_ensemble_tpu_torch.ops.binning import pack_width


def _fit_shapes():
    out = []
    for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]:
        cell = spec.load_cell(w["name"])
        if cell.driver != "fit":
            continue
        data, base = cell.config["data"], cell.config["base_learner"]
        d = data["numeric_features"] + sum(data.get("one_hot_groups", []))
        K = 1 if cell.config["estimator"]["loss"] == "bernoulli" else data["classes"]
        out.append(pytest.param(data["rows"], d, K, base["max_bins"], base["max_depth"], id=w["name"]))
    return out


@pytest.mark.parametrize("n,d,K,B,depth", _fit_shapes())
def test_kernel_counts_equal_the_ports(n, d, K, B, depth):
    W = work.packed_words(d, B)
    assert W == -(-d // (32 // pack_width(B)))
    for level in range(depth):
        shapes = dict(n=n, d=d, W=W, M=K, C=2, B=B, n_nodes=2**level)
        assert work.kernel_work("hist_packed", **shapes) == hist_kernels.kernel_work("hist_packed", **shapes)
        if level:
            r = dict(n=n, W=W, M=K, half=2 ** (level - 1))
            assert work.kernel_work("route_packed", **r) == hist_kernels.kernel_work("route_packed", **r)
    leaf = dict(n=n, M=K, C=2, leaves=2**depth, W=W, half=2 ** (depth - 1))
    assert work.kernel_work("leaf_sums", **leaf) == hist_kernels.kernel_work("leaf_sums", **leaf)
    assert work.kernel_work("leaf_sums", n=n, M=K, C=2, leaves=4) == hist_kernels.kernel_work(
        "leaf_sums", n=n, M=K, C=2, leaves=4)


def test_round_work_sums_the_kernels_launches():
    n, d, K, B, depth = 1000, 28, 2, 63, 8
    r = work.round_work(n=n, d=d, K=K, max_bins=B, depth=depth)
    W = work.packed_words(d, B)
    hist = sum(work.kernel_work("hist_packed", n=n, d=d, W=W, M=K, C=2, B=B, n_nodes=2**lv)[0]
               for lv in range(depth))
    assert r["level_hist"][0] == hist
    assert r["level_hist"][1] == depth * n * K * 2 * d  # one add a statistic cell a row touches
    # the route and the leaf pass read one lane of a row, not its W words
    full = work.kernel_work("route_packed", n=n, W=W, M=K, half=4)
    assert work.route_least(n=n, M=K, half=4, max_bins=B)[0] == full[0] - 4 * n * W + n * K
    leaf = work.kernel_work("leaf_sums", n=n, M=K, C=2, leaves=256, W=W, half=128)
    assert r["leaf_sums"][0] == leaf[0] - 4 * n * W + n * K
    assert work.lane_bits(16) == 4 and work.lane_bits(17) == 8
    f = work.fit_work(n=n, d=d, K=K, max_bins=B, depth=depth, rounds=3)
    assert f["route_packed"] == tuple(3 * x for x in r["route_packed"])
    assert f["binning"] == work.binning_work(n=n, d=d, max_bins=B)


def test_least_seconds_takes_the_larger_bound():
    peaks = {"bytes_per_s": 1e12, "f32_ops_per_s": 1e12}
    assert work.least_seconds((2e12, 1e12), peaks) == (2.0, "bytes")
    assert work.least_seconds((1e12, 3e12), peaks) == (3.0, "ops")


def test_unknown_kernel_raises():
    with pytest.raises(ValueError):
        work.kernel_work("matmul", m=1, k=1, n=1)
