"""The megabatch sweep's contracts in the PyTorch port
(``spark_ensemble_tpu_torch/models/gbm_sweep.py``; the JAX package pins
the same ones in ``tests/test_megabatch.py``).

A swept candidate is BIT-identical to its own sequential fit: members,
step weights, masks, validation history and early-stop round (array
equality, no tolerance), on the scatter tier (the CPU's ``hist="auto"``),
the fused tier through its kernels' plain versions, and the matmul tier.
The lane plans that make the card's kernels sum a swept lane as its own
fit are checked here as plans; ``chip_smoke.py`` checks the launches.
"""

import numpy as np
import pytest
import torch

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.models import gbm_sweep
from spark_ensemble_tpu_torch.models.base import tree_leaves
from spark_ensemble_tpu_torch.models.gbm_sweep import (
    fit_sweep,
    sweep_group_key,
    sweep_unsupported_reason,
)
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.ops.linesearch import (
    chol_solve_psd_lanes,
    projected_newton_box_lanes,
)


def _data(n=160, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] + 0.1 * rng.randn(n)).astype(np.float32)
    yc = np.digitize(X[:, 0] + 0.3 * rng.randn(n), [-0.5, 0.6]).astype(np.float32)
    return X, y, yc


def _assert_same(a, b):
    """Params dicts equal bit for bit (tensors, numpy arrays and None)."""
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
            continue
        la, lb = tree_leaves(a[k]), tree_leaves(b[k])
        assert len(la) == len(lb)
        for x, z in zip(la, lb):
            assert x.shape == z.shape
            assert torch.equal(x, z), k


def _tree(hist, depth=3):
    return st.DecisionTreeRegressor(max_depth=depth, hist=hist)


@pytest.mark.parametrize("hist", ["scatter", "fused", "matmul"])
@pytest.mark.parametrize("loss", ["squared", "huber"])
def test_regressor_sweep_bit_identical_to_sequential(hist, loss):
    X, y, _ = _data()
    base = st.GBMRegressor(num_base_learners=4, seed=3, loss=loss, base_learner=_tree(hist))
    cands = [base.copy(learning_rate=0.1, seed=1),
             base.copy(learning_rate=0.3, seed=2, subsample_ratio=0.7),
             base.copy(learning_rate=0.05, seed=3, num_base_learners=3,
                       subspace_ratio=0.6)]
    w0 = np.ones(len(y), np.float32)
    w0[10:20] = 0.0  # a tuner's zero-weight fold mask
    sws = [w0, None, None]
    for est, sw, m in zip(cands, sws, fit_sweep(cands, X, y, sample_weights=sws,
                                                 device="cpu")):
        ref = est.fit(X, y, sample_weight=sw, device="cpu")
        assert m.num_members == ref.num_members
        _assert_same(m.params, ref.params)
        assert torch.equal(m.predict(X), ref.predict(X))


@pytest.mark.parametrize("hist", ["scatter", "fused", "matmul"])
def test_classifier_sweep_bit_identical_to_sequential(hist):
    X, _, yc = _data()
    base = st.GBMClassifier(num_base_learners=3, seed=2, updates="newton",
                            base_learner=_tree(hist))
    cands = [base.copy(learning_rate=0.1), base.copy(learning_rate=0.3, seed=4,
                                                     subsample_ratio=0.8)]
    w0 = np.ones(len(yc), np.float32)
    w0[:15] = 0.0
    for est, sw, m in zip(cands, [w0, None],
                          fit_sweep(cands, X, yc, sample_weights=[w0, None], device="cpu")):
        ref = est.fit(X, yc, sample_weight=sw, device="cpu")
        _assert_same(m.params, ref.params)
        assert torch.equal(m.predict_proba(X), ref.predict_proba(X))


@pytest.mark.parametrize("family", ["GBMRegressor", "GBMClassifier"])
def test_sweep_validation_patience_equivalence(family):
    """Each lane stops at exactly the round its own fit stops, lanes that
    stop rounds apart included, and keeps the same trimmed members and
    validation history."""
    X, y, yc = _data(n=200)
    target = y if family == "GBMRegressor" else yc
    vi = np.zeros(len(y), bool)
    vi[::4] = True
    base = getattr(st, family)(num_base_learners=8, seed=3, base_learner=_tree("scatter"))
    cands = [base.copy(learning_rate=0.9, num_rounds=2, validation_tol=0.05),
             base.copy(learning_rate=0.05, num_rounds=1, validation_tol=0.2, seed=9),
             base.copy(learning_rate=0.2, num_base_learners=5, num_rounds=3)]
    for est, m in zip(cands, fit_sweep(cands, X, target, validation_indicator=vi,
                                       device="cpu")):
        ref = est.fit(X, target, validation_indicator=vi, device="cpu")
        assert m.num_members == ref.num_members
        _assert_same(m.params, ref.params)


def test_sweep_over_non_tree_members_bit_identical():
    """Learners other than the trees fit lane by lane in the lockstep
    round, with the round's bag key shared by the class dims."""
    X, _, yc = _data(n=120)
    base = st.GBMClassifier(num_base_learners=2,
                            base_learner=st.MLPRegressor(max_iter=5, hidden_layer_sizes=(4,)))
    cands = [base.copy(learning_rate=0.1), base.copy(learning_rate=0.5, seed=3,
                                                     subsample_ratio=0.9)]
    for est, m in zip(cands, fit_sweep(cands, X, yc, device="cpu")):
        _assert_same(m.params, est.fit(X, yc, device="cpu").params)


def test_sweep_slab_invariant(monkeypatch):
    """Three lanes at two lanes a slab (a short second slab) give the
    one-slab models bit for bit."""
    X, y, _ = _data()
    base = st.GBMRegressor(num_base_learners=3, seed=1, base_learner=_tree("fused"))
    cands = [base.copy(learning_rate=0.1 + 0.1 * i, seed=i) for i in range(3)]
    wide = fit_sweep([e.copy() for e in cands], X, y, device="cpu")
    monkeypatch.setattr(gbm_sweep, "_CONFIGS_PER_DISPATCH", 2)
    narrow = fit_sweep([e.copy() for e in cands], X, y, device="cpu")
    for a, b in zip(wide, narrow):
        _assert_same(a.params, b.params)


def test_sweep_rejects_structural_mix_and_unsupported():
    X, y, _ = _data()
    a = st.GBMRegressor(num_base_learners=2)
    b = a.copy(base_learner=st.DecisionTreeRegressor(max_depth=7))
    assert sweep_group_key(a) != sweep_group_key(b)
    with pytest.raises(ValueError, match="structural"):
        fit_sweep([a, b], X, y, device="cpu")
    assert sweep_group_key(a) == sweep_group_key(
        a.copy(learning_rate=0.7, seed=9, num_base_learners=30))
    assert sweep_unsupported_reason(a) is None
    assert "checkpoint" in sweep_unsupported_reason(a.copy(checkpoint_dir="ck"))
    assert "megabatch" in sweep_unsupported_reason(st.DecisionTreeRegressor())
    assert "sampling" in sweep_unsupported_reason(a.copy(sampling="goss"))
    assert "sampling" in sweep_unsupported_reason(a.copy(sampling="mvs"))
    assert "linear" in sweep_unsupported_reason(a.copy(leaf_model="linear"))
    with pytest.raises(ValueError, match="sweep"):
        fit_sweep([a.copy(checkpoint_dir="ck")], X, y, device="cpu")
    assert fit_sweep([], X, y, device="cpu") == []


@pytest.mark.parametrize("estimator", ["sampled", "tree"])
def test_megabatch_on_raises_and_auto_falls_back(estimator):
    """Under 'auto' an unsupported grid lands byte for byte on the
    sequential loop's answer; under 'on' it raises."""
    X, y, _ = _data()
    if estimator == "sampled":
        est = st.GBMRegressor(num_base_learners=2, sampling="goss",
                              base_learner=_tree("scatter"))
        grid = st.ParamGridBuilder().add_grid("learning_rate", [0.1, 0.3]).build()
        match = "sampling"
    else:
        est = st.DecisionTreeRegressor(hist="scatter")
        grid = st.ParamGridBuilder().add_grid("max_depth", [2, 3]).build()
        match = "megabatch"
    kw = dict(estimator=est, estimator_param_maps=grid,
              evaluator=st.RegressionEvaluator(metric="rmse"), seed=0)
    with pytest.raises(ValueError, match=match):
        st.TrainValidationSplit(megabatch="on", **kw).fit(X, y, device="cpu")
    seq = st.TrainValidationSplit(megabatch="off", **kw).fit(X, y, device="cpu")
    auto = st.TrainValidationSplit(megabatch="auto", **kw).fit(X, y, device="cpu")
    assert seq.validation_metrics == auto.validation_metrics
    assert seq.best_index == auto.best_index


def test_megabatch_requires_share_binning():
    X, y, _ = _data()
    kw = dict(estimator=st.GBMRegressor(num_base_learners=2, base_learner=_tree("scatter")),
              estimator_param_maps=st.ParamGridBuilder().add_grid(
                  "learning_rate", [0.1, 0.3]).build(),
              evaluator=st.RegressionEvaluator(metric="rmse"), num_folds=2, seed=0)
    with pytest.raises(ValueError, match="share_binning"):
        st.CrossValidator(megabatch="on", share_binning=False, **kw).fit(X, y, device="cpu")
    seq = st.CrossValidator(megabatch="off", share_binning=False, **kw).fit(X, y, device="cpu")
    auto = st.CrossValidator(megabatch="auto", share_binning=False, **kw).fit(
        X, y, device="cpu")
    assert seq.avg_metrics == auto.avg_metrics


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_cv_megabatch_matches_sequential_and_structural_grids_split(task):
    X, y, yc = _data(n=150)
    if task == "regression":
        est, target = st.GBMRegressor(num_base_learners=3), y
        evaluator = st.RegressionEvaluator(metric="rmse")
    else:
        est, target = st.GBMClassifier(num_base_learners=2), yc
        evaluator = st.MulticlassClassificationEvaluator(metric="logLoss")
    grid = [{"learning_rate": 0.1, "base_learner": _tree("fused", 2)},
            {"learning_rate": 0.3, "base_learner": _tree("fused", 2)},
            {"learning_rate": 0.1, "base_learner": _tree("fused", 3)}]
    kw = dict(estimator=est, estimator_param_maps=grid, evaluator=evaluator,
              num_folds=2, seed=1)
    seq = st.CrossValidator(megabatch="off", **kw).fit(X, target, device="cpu")
    mb = st.CrossValidator(megabatch="on", **kw).fit(X, target, device="cpu")
    assert seq.avg_metrics == mb.avg_metrics
    assert seq.best_index == mb.best_index


@pytest.mark.parametrize("n,d,K,C,B,nodes,bits", [
    (15000, 16, 26, 2, 64, 1, 8), (15000, 16, 26, 2, 64, 16, 8),
    (15000, 16, 26, 2, 64, 16, 32), (8192, 12, 1, 2, 64, 8, 8),
    (700, 6, 3, 2, 16, 4, 4),
])
@pytest.mark.parametrize("lanes", [2, 12])
def test_lane_plans_keep_the_lane_summation_order(n, d, K, C, B, nodes, bits, lanes):
    """The wide launch keeps the K-member launch's row chunking (which
    alone fixes a cell's sum order) and grows its grid by the lanes; the
    leaf pass runs the K-member plan itself."""
    wide = hk.lane_level_plan(n, d, lanes * K, C, B, nodes, bits, lanes)
    lane = hk.level_plan(n, d, K, C, B, nodes, bits)
    alone = hk.level_plan(n, d, lanes * K, C, B, nodes, bits)
    assert (wide.cs, wide.rows_per_chunk) == (lane.cs, lane.rows_per_chunk)
    assert wide.grid == alone.grid // alone.cs * lane.cs
    assert (wide.g, wide.nf, wide.np, wide.smem) == (alone.g, alone.nf, alone.np, alone.smem)
    W = -(-d // (32 // bits)) if bits < 32 else d
    assert hk.lane_leaf_plan(n, lanes * K, C, 2 * nodes, nodes, W, lanes) == hk.leaf_plan(
        n, K, C, 2 * nodes, nodes, W)
    with pytest.raises(ValueError, match="lanes"):
        hk.lane_level_plan(n, d, lanes * K + 1, C, B, nodes, bits, lanes)


def test_wide_plain_launches_equal_each_lane_alone():
    """On the CPU the wrappers take their plain versions: the M = S * K
    histogram and leaf sums, lane by lane, equal the K-member calls."""
    rng = np.random.RandomState(0)
    n, d, K, S, B = 300, 6, 3, 4, 16
    ids = torch.as_tensor(rng.randint(0, B, (n, d)).astype(np.int32))
    packed = st.ops.binning.pack_bins(ids, B, 4).packed
    node = torch.as_tensor(rng.randint(0, 4, (n, S * K)).astype(np.int32))
    vals = torch.as_tensor(rng.randn(n, S * K, 2).astype(np.float32))
    H = hk.hist_level_packed(packed, node, vals, n_nodes=4, max_bins=B, bits=4,
                             num_features=d, lanes=S)
    L = hk.leaf_sums(node, vals, n_nodes=4, lanes=S)
    for s in range(S):
        cols = slice(s * K, (s + 1) * K)
        Hs = hk.hist_level_packed(packed, node[:, cols].contiguous(),
                                  vals[:, cols].contiguous(), n_nodes=4, max_bins=B,
                                  bits=4, num_features=d)
        assert torch.equal(H[cols], Hs)
        assert torch.equal(L[cols], hk.leaf_sums(node[:, cols].contiguous(),
                                                 vals[:, cols].contiguous(), n_nodes=4))


def test_newton_lanes_equal_one_lane_searches():
    """Every lane of a batched projected Newton search returns what its
    own one-lane search returns, bit for bit, whatever the other lanes do
    (one converges at once, one backtracks, one hits the bound)."""
    rng = np.random.RandomState(0)
    k = 4
    problems = []
    for s in range(5):
        A = rng.randn(k, k).astype(np.float32)
        A = torch.as_tensor(A @ A.T + (0.1 + s) * np.eye(k, dtype=np.float32))
        c = torch.as_tensor(rng.randn(k).astype(np.float32) * (3 if s == 2 else 1))

        def f(x, A=A, c=c):
            return 0.5 * x @ A @ x - c @ x + 0.1 * torch.sum(x ** 4)

        def gh(x, A=A, c=c):
            return A @ x - c + 0.4 * x ** 3, A + torch.diag(1.2 * x ** 2)

        problems.append((f, gh))
    x0 = torch.as_tensor(rng.rand(5, k).astype(np.float32))
    both = projected_newton_box_lanes([p[0] for p in problems], x0, max_iter=25,
                                      tol=1e-6, grad_hess=[p[1] for p in problems])
    for s, (f, gh) in enumerate(problems):
        one = projected_newton_box_lanes([f], x0[s:s + 1], max_iter=25, tol=1e-6,
                                         grad_hess=[gh])
        assert torch.equal(both[s], one[0])
    A = torch.as_tensor(rng.randn(6, k, k).astype(np.float32))
    A = A @ A.transpose(1, 2) + torch.eye(k)
    b = torch.as_tensor(rng.randn(6, k).astype(np.float32))
    out = chol_solve_psd_lanes(A, b)
    perm = torch.as_tensor(rng.permutation(6))
    assert torch.equal(chol_solve_psd_lanes(A[perm], b[perm]), out[perm])
