"""The port's meshes (``parallel/mesh.py``) and multi-process entry point
(``parallel/multihost.py``) against the JAX package's.

Four gloo ranks on the CPU build every mesh of the suite; each rank's block
of rows must be the indices that the JAX package's ``NamedSharding`` puts
on device ``r`` of the same-shaped mesh (``P("data")``, or ``P(("dcn_data",
"data"))`` on the hybrid mesh), with the same zero padding.  Shapes, sizes
and errors follow the JAX constructors; the padding helpers agree on the
same numpy input; and a single process sees the degenerate topology."""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_mesh_worker as mw
from spark_ensemble_tpu.parallel import mesh as jm
from spark_ensemble_tpu_torch.parallel import mesh as pm, multihost

N = 701


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    try:
        mw.free_port()
    except OSError as e:  # the sandbox forbids loopback sockets
        pytest.skip(f"no loopback sockets: {e}")
    mw.spawn("mesh", str(out), timeout=300)
    return [dict(np.load(os.path.join(out, f"mesh_r{r}.npz"))) for r in range(mw.W)]


def _jax(name):
    devs = jax.devices()[:4]
    return {
        "dm4": lambda: jm.create_mesh({"data": 4, "member": 1}, devices=devs),
        "dm42": lambda: jm.create_mesh({"data": 2, "member": 2}, devices=devs),
        "hyb": lambda: jm.hybrid_data_member_mesh(dcn_data=2, member=2, devices=devs),
        "m4": lambda: jm.create_mesh({"data": 1, "member": 4}, devices=devs),
        "d4": lambda: jm.create_mesh({"data": 4}, devices=devs),
    }[name]()


MESHES = ["dm4", "dm42", "hyb", "m4", "d4"]


@pytest.mark.parametrize("name", MESHES)
def test_shape_and_sizes_match_the_jax_mesh(runs, name):
    m = _jax(name)
    np.testing.assert_array_equal(runs[0][f"{name}_shape"], list(m.shape.values()))
    np.testing.assert_array_equal(runs[0][f"{name}_sizes"], jm.mesh_sizes(m))


@pytest.mark.parametrize("name", MESHES)
def test_each_rank_holds_the_rows_jax_places_on_its_device(runs, name):
    m = _jax(name)
    X = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    data, _ = jm.mesh_sizes(m)
    Xp, _ = jm.pad_to_multiple(X, data)
    arr = jax.device_put(np.asarray(Xp), NamedSharding(m, P(jm.mesh_row_spec(m), None)))
    by_dev = {s.device.id: s.index[0] for s in arr.addressable_shards}
    for r in range(mw.W):
        rows = by_dev[jax.devices()[r].id]
        n_pad, lo, hi = runs[r][f"{name}_block"]
        start, stop, _ = rows.indices(Xp.shape[0])
        assert (lo, hi, n_pad) == (start, stop, Xp.shape[0])
        np.testing.assert_array_equal(runs[r][f"{name}_rows"], np.asarray(Xp)[rows])


@pytest.mark.parametrize("name", ["dm4", "dm42", "hyb", "m4"])
def test_reduction_axes_group_the_right_ranks(runs, name):
    m = _jax(name)
    grid = np.arange(mw.W).reshape(tuple(m.shape.values()))
    for r in range(mw.W):
        coord = np.unravel_index(r, grid.shape)
        member = grid[coord[:-1]]  # same row coords, every member
        rows = grid[..., coord[-1]].reshape(-1)  # same member coord
        np.testing.assert_array_equal(runs[r][f"{name}_member_ranks"], member)
        np.testing.assert_array_equal(runs[r][f"{name}_row_ranks"], rows)


def test_sizes_that_do_not_multiply_to_the_world_raise(runs):
    errs = list(runs[0]["errors"])
    assert "must divide device count" in errs[0]
    assert "needs 3 devices, have 4" in errs[1]
    assert "must divide 4 devices" in errs[2]


def test_topology_of_four_local_ranks(runs):
    for r in range(mw.W):
        assert int(runs[r]["process_count"]) == mw.W
        assert int(runs[r]["process_index"]) == r
        assert int(runs[r]["slice_count"]) == 1


@pytest.mark.parametrize("n,multiple", [(700, 8), (701, 4), (8, 8), (1, 3)])
def test_pad_to_multiple_and_pad_rows_match_jax(n, multiple):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    jp, jn = jm.pad_to_multiple(x, multiple)
    tp, tn = pm.pad_to_multiple(torch.from_numpy(x), multiple)
    assert jn == tn == n
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np_pad, _ = pm.pad_to_multiple(x, multiple)
    np.testing.assert_array_equal(np.asarray(jp), np_pad)
    n_pad = n + (-n) % multiple
    np.testing.assert_array_equal(np.asarray(jm.pad_rows(x, n_pad)),
                                  pm.pad_rows(torch.from_numpy(x), n_pad).numpy())


def test_pad_ctx_rows_pads_only_the_row_indexed_leaves():
    """A tree ctx: the bins pad with zero rows (bin 0, weight 0 downstream),
    the thresholds stay whole, as the JAX package's ``pad_ctx_rows`` with
    the tree's ``ctx_specs``."""
    import spark_ensemble_tpu as se
    import spark_ensemble_tpu_torch as st

    X = np.random.RandomState(0).randn(13, 3).astype(np.float32)
    tb, jb = st.DecisionTreeRegressor(max_bins=8), se.DecisionTreeRegressor(max_bins=8)
    tctx, jctx = tb.make_fit_ctx(torch.from_numpy(X)), jb.make_fit_ctx(X)
    padded = pm.pad_ctx_rows(tctx, tb, 16)
    want = jm.pad_ctx_rows(jctx, jb.ctx_specs(jctx, "data"), 16)
    np.testing.assert_array_equal(padded["Xb"].numpy(), np.asarray(want["Xb"]))
    np.testing.assert_array_equal(padded["thresholds"].numpy(),
                                  np.asarray(want["thresholds"]))


def test_multihost_single_process_contract():
    """The JAX package's single-process contract
    (``tests/test_parallel.py::test_multihost_single_process_contract``):
    the degenerate topology, and partial explicit arguments rejected
    before any rendezvous."""
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.local_device_count() >= 1
    assert multihost.slice_count() == 1
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(coordinator_address="h:1234")
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(num_processes=2, process_id=0)


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize"):
        pm.data_member_mesh(1, device="cpu")


def test_parallel_names_reach_the_top_level():
    import spark_ensemble_tpu as se
    import spark_ensemble_tpu_torch as st

    for name in ("create_mesh", "data_member_mesh", "hybrid_data_member_mesh",
                 "multihost", "slice_count"):
        assert hasattr(st.parallel, name) and hasattr(se.parallel, name)
    assert st.slice_count is st.parallel.slice_count
