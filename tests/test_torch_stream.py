"""PyTorch port parity: the stream tier (``hist="stream"``,
``spark_ensemble_tpu_torch/ops/tree.py::_fit_forest_streamed`` vs the JAX
package's ``ops/tree.py::_fit_forest_streamed``).

The chunk is forced small on both sides so that every fit runs several
chunks and a ragged last one: the port's ``_STREAM_CHUNK_ROWS`` is
monkeypatched, and the JAX package's is pinned by
``autotune.resolve.override(stream_chunk_rows=N)`` (its jit caches are
cleared first: the chunk size is baked into a traced program).

- Split tables are array-equal and leaf values within 1e-6, at "highest",
  "high" (tie-free dyadic fixture: every f32 sum is exact in any order)
  and "default" (a bf16-exact fixture: JAX on the CPU ignores Precision,
  the port rounds the statistics to bf16, which is the identity there).
- ``return_leaf`` node ids are equal.
- The stream tier equals the port's matmul tier at "highest" (dyadic
  fixture: the same histograms summed in chunk order) and at "high"
  (bf16-exact fixture, where the matmul tier's subtraction is exact).
- ``hist="auto"`` takes the stream tier past ``_MATMUL_HIST_MAX_CELLS``
  (monkeypatched small), at "pallas" too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.autotune.resolve import override
from spark_ensemble_tpu.ops import tree as jt
from spark_ensemble_tpu.ops.binning import bin_features, compute_bins
from spark_ensemble_tpu_torch.ops import tree as tt

SPLITS = ("split_feature", "split_bin", "split_threshold")
CHUNK = 64


@pytest.fixture
def small_chunk(monkeypatch):
    """Chunks of CHUNK rows on both sides."""
    monkeypatch.setattr(tt, "_STREAM_CHUNK_ROWS", CHUNK)
    jax.clear_caches()
    with override(stream_chunk_rows=CHUNK):
        yield
    jax.clear_caches()


def _binned(X, B):
    bins = compute_bins(jnp.asarray(X), B)
    return np.array(bin_features(jnp.asarray(X), bins)), np.array(bins.thresholds)


def _dyadic(seed, n, d, M, k, B):
    rng = np.random.RandomState(seed)
    Xb, thr = _binned(rng.randn(n, d).astype(np.float32), B)
    Y = (rng.randint(-16, 17, size=(n, M, k)) / 8.0).astype(np.float32)
    w = (rng.randint(0, 3, size=(n, M)) / 2.0).astype(np.float32)
    return Xb, thr, Y, w


def _bf16_exact(seed, n, d, M, B):
    """Integer targets in mirrored pairs with paired weights in {1, 2}:
    the weighted mean is exactly 0 and every statistic a small integer."""
    rng = np.random.RandomState(seed)
    Xb, thr = _binned(rng.randn(n, d).astype(np.float32), B)
    h = n // 2
    v = rng.randint(-3, 4, size=(h, M, 1)).astype(np.float32)
    wv = rng.randint(1, 3, size=(h, M)).astype(np.float32)
    perm = rng.permutation(n)
    return Xb, thr, np.concatenate([v, -v])[perm], np.concatenate([wv, wv])[perm]


def _fit_both(Xb, Y, w, thr, mask=None, **kw):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    j = jt.fit_forest(jnp.asarray(Xb), jnp.asarray(Y), jnp.asarray(w),
                      jnp.asarray(thr), jm, return_leaf=True, **kw)
    t = tt.fit_forest(torch.as_tensor(Xb), torch.as_tensor(Y), torch.as_tensor(w),
                      torch.as_tensor(thr), tm, return_leaf=True, **kw)
    return j, t


def _assert_same(j, t, leaf_atol=1e-6):
    (jtree, jnode), (ttree, tnode) = j, t
    for f in SPLITS:
        np.testing.assert_array_equal(getattr(ttree, f).numpy(),
                                      np.asarray(getattr(jtree, f)), err_msg=f)
    np.testing.assert_allclose(ttree.leaf_value.numpy(), np.asarray(jtree.leaf_value),
                               rtol=0, atol=leaf_atol)
    np.testing.assert_allclose(ttree.split_gain.numpy(), np.asarray(jtree.split_gain),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))


@pytest.mark.parametrize(
    "n,M,k,B,depth",
    [(300, 3, 1, 16, 3), (257, 2, 3, 16, 2), (300, 1, 2, 260, 3), (200, 4, 1, 64, 1)],
)
@pytest.mark.parametrize("hp", ["highest", "high", "pallas"])
def test_stream_forest_matches_the_reference(small_chunk, n, M, k, B, depth, hp):
    """Dyadic fixture: the chunked histograms are exact, so the split
    tables, node ids and leaf values equal the JAX stream tier's ('pallas'
    takes the stream tier at 'high' on both sides).  B=260 keeps the bins
    in int32 (uint8 holds at most 256 ids)."""
    Xb, thr, Y, w = _dyadic(n + B, n, 5, M, k, B)
    mask = np.random.RandomState(n).rand(M, 5) < 0.7
    mask[:, 0] = True
    j, t = _fit_both(Xb, Y, w, thr, mask, max_depth=depth, max_bins=B,
                     hist="stream", hist_precision=hp)
    _assert_same(j, t)


@pytest.mark.parametrize("M,depth", [(1, 3), (3, 2)])
def test_stream_default_precision_on_bf16_exact_statistics(small_chunk, M, depth):
    Xb, thr, Y, w = _bf16_exact(9 + M, 300, 4, M, 16)
    j, t = _fit_both(Xb, Y, w, thr, max_depth=depth, max_bins=16,
                     hist="stream", hist_precision="default")
    _assert_same(j, t)


@pytest.mark.parametrize("hp", ["highest", "high"])
def test_stream_equals_the_ports_matmul_tier(small_chunk, hp):
    """The stream tier computes the matmul tier's histograms chunk by
    chunk; at 'highest' their tables are equal on the dyadic fixture.  At
    'high' the matmul tier subtracts histograms and the stream tier does
    not, so it is held on the bf16-exact fixture, where subtraction is
    exact and the derived children's floors (1e-6 of the parent's weight)
    stay below every integer weight.  At 'default' those floors are 1e-2
    of the parent's weight and reject children the stream tier's direct
    1e-12 floors accept, in both packages: the tiers differ by design."""
    if hp == "highest":
        Xb, thr, Y, w = _dyadic(21, 300, 5, 3, 2, 16)
    else:
        Xb, thr, Y, w = _bf16_exact(22, 300, 5, 3, 16)
    args = (torch.as_tensor(Xb), torch.as_tensor(Y), torch.as_tensor(w),
            torch.as_tensor(thr))
    kw = dict(max_depth=3, max_bins=16, hist_precision=hp, return_leaf=True)
    s_tree, s_node = tt.fit_forest(*args, hist="stream", **kw)
    m_tree, m_node = tt.fit_forest(*args, hist="matmul", **kw)
    for f in SPLITS:
        np.testing.assert_array_equal(getattr(s_tree, f).numpy(),
                                      getattr(m_tree, f).numpy(), err_msg=f)
    np.testing.assert_allclose(s_tree.leaf_value.numpy(), m_tree.leaf_value.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(s_node.numpy(), m_node.numpy())


def test_stream_single_tree_is_the_forests_m1_case(small_chunk):
    """fit_tree on the stream tier (the JAX package routes it through its
    forest path) against the JAX package's, on the dyadic fixture."""
    Xb, thr, Y, w = _dyadic(31, 300, 5, 1, 2, 16)
    kw = dict(max_depth=3, max_bins=16, hist="stream", return_leaf=True)
    jtree, jnode = jt.fit_tree(jnp.asarray(Xb), jnp.asarray(Y[:, 0]),
                               jnp.asarray(w[:, 0]), jnp.asarray(thr), **kw)
    ttree, tnode = tt.fit_tree(torch.as_tensor(Xb), torch.as_tensor(Y[:, 0]),
                               torch.as_tensor(w[:, 0]), torch.as_tensor(thr), **kw)
    for f in SPLITS:
        np.testing.assert_array_equal(getattr(ttree, f).numpy(),
                                      np.asarray(getattr(jtree, f)), err_msg=f)
    np.testing.assert_allclose(ttree.leaf_value.numpy(), np.asarray(jtree.leaf_value),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode))


@pytest.mark.parametrize(
    "hist,hp,device,want",
    [("auto", "highest", "cuda", "stream"), ("auto", "high", "cuda", "stream"),
     ("auto", "pallas", "cpu", "stream"), ("auto", "pallas", "cuda", "stream"),
     ("auto", "highest", "cpu", "scatter")],
)
def test_auto_takes_stream_past_the_cell_budget(monkeypatch, hist, hp, device, want):
    """Past the matmul tier's one-hot budget (n * d * B cells, here
    monkeypatched to 1000) hist='auto' resolves to 'stream' on CUDA, and
    at 'pallas' on any device (the stream tier wins over the kernel, as in
    the JAX package's fit_forest); on the CPU 'auto' stays 'scatter'.
    Resolution reads only the device's type, so no card is needed."""
    monkeypatch.setattr(tt, "_MATMUL_HIST_MAX_CELLS", 1000)
    assert tt.resolve_forest_tier(hist, hp, device, 100, 5, 16) == want
    assert tt.resolve_forest_tier(hist, hp, device, 10, 5, 16) == (
        "scatter" if want == "scatter" else
        "pallas" if hp == "pallas" else "matmul")


def test_pallas_past_the_budget_launches_no_kernel(monkeypatch):
    """At hist_precision='pallas' an 'auto' forest past the budget runs
    the stream tier: the pallas kernel's wrapper is never called, and the
    result equals an explicit stream fit at 'high'."""
    from spark_ensemble_tpu_torch.ops import hist_kernels as hk

    monkeypatch.setattr(tt, "_MATMUL_HIST_MAX_CELLS", 1000)
    monkeypatch.setattr(tt, "_STREAM_CHUNK_ROWS", CHUNK)
    hk.reset_launch_counts()

    def no_kernel(*a, **k):
        raise AssertionError("the pallas kernel ran past the cell budget")

    monkeypatch.setattr(tt, "hist_level_pallas", no_kernel)
    Xb, thr, Y, w = _dyadic(41, 300, 5, 2, 1, 16)
    args = (torch.as_tensor(Xb), torch.as_tensor(Y), torch.as_tensor(w),
            torch.as_tensor(thr))
    a = tt.fit_forest(*args, max_depth=3, max_bins=16, hist="auto",
                      hist_precision="pallas")
    b = tt.fit_forest(*args, max_depth=3, max_bins=16, hist="stream",
                      hist_precision="high")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert sum(hk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("estimator", ["classifier", "regressor"])
def test_gbm_on_the_stream_tier_matches_the_reference(small_chunk, estimator):
    """A 3-round GBM over DecisionTreeRegressor(hist='stream'): the JAX
    package's pin tolerance (probabilities within 1e-3; predictions within
    1e-3 of the label scale)."""
    rng = np.random.RandomState(5)
    X = rng.randn(300, 6).astype(np.float32)

    def base(pkg):
        return pkg.DecisionTreeRegressor(hist="stream", max_depth=3, max_bins=16)

    if estimator == "classifier":
        y = np.argmax(X @ rng.randn(3, 6).astype(np.float32).T, axis=1).astype(np.float32)
        kw = dict(num_base_learners=3, learning_rate=0.3, updates="newton")
        jm = se.GBMClassifier(base_learner=base(se), **kw).fit(X, y)
        tm = st.GBMClassifier(base_learner=base(st), **kw).fit(X, y, device="cpu")
        np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                                   np.asarray(jm.predict_proba(X)), atol=1e-3)
    else:
        y = (2.0 * X[:, 0] + np.sin(3.0 * X[:, 1])).astype(np.float32)
        kw = dict(num_base_learners=3, learning_rate=0.5)
        jm = se.GBMRegressor(base_learner=base(se), **kw).fit(X, y)
        tm = st.GBMRegressor(base_learner=base(st), **kw).fit(X, y, device="cpu")
        np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                                   atol=1e-3 * np.abs(y).max())
