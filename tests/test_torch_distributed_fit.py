"""The port's mesh fits against the JAX package's (``fit(X, y, mesh=...)``).

One module-scoped spawn runs every case of ``_torch_mesh_worker.FIT_CASES``
on 4 gloo ranks on the CPU (``data_member_mesh(4)``, ``(4, member=2)``,
the hybrid ``(dcn_data=2, data=1, member=2)``, ``(data=1, member=4)`` and
a data-only ``(data=4)``); the JAX package fits the same case here on a
mesh of the same shape over 4 of conftest's 8 virtual CPU devices.  The
tolerances are ``tests/test_distributed_fit.py``'s (pointwise where it is
pointwise, metric parity where it is), each stated below.  Every rank's
fitted params must be bit-identical (their sha256 digests) and every
rank's predictions equal.
"""

import os

import jax
import numpy as np
import pytest

import _torch_mesh_worker as mw
import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.parallel import mesh as jmesh


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_fit")
    try:
        mw.free_port()
    except OSError as e:  # the sandbox forbids loopback sockets
        pytest.skip(f"no loopback sockets: {e}")
    mw.spawn("fit", str(out), timeout=900)

    def load(case, rank=0):
        return dict(np.load(os.path.join(out, f"{case}_r{rank}.npz")))

    return load


_JAX_MESHES = {}


def _jax_mesh(name):
    if name not in _JAX_MESHES:
        devs = jax.devices()[:4]
        _JAX_MESHES[name] = {
            "dm4": lambda: jmesh.create_mesh({"data": 4, "member": 1}, devices=devs),
            "dm42": lambda: jmesh.create_mesh({"data": 2, "member": 2}, devices=devs),
            "hyb": lambda: jmesh.hybrid_data_member_mesh(dcn_data=2, member=2, devices=devs),
            "m4": lambda: jmesh.create_mesh({"data": 1, "member": 4}, devices=devs),
            "d4": lambda: jmesh.create_mesh({"data": 4}, devices=devs),
        }[name]()
    return _JAX_MESHES[name]


def _jax_fit(case):
    family, params, base, mesh_name, data, _ = mw.FIT_CASES[case]
    X, y = mw.DATA[data]()
    est = mw.build(se, family, params, base)
    return est.fit(X, y, mesh=_jax_mesh(mesh_name), **mw.fit_kwargs(case, len(y))), X, y


def _rmse(pred, y):
    return float(np.sqrt(np.mean((np.asarray(pred) - y) ** 2)))


def _close_rmse(port, jax_model, X, y, rel):
    r_p, r_j = _rmse(port["predict"], y), _rmse(jax_model.predict(X), y)
    assert abs(r_p - r_j) < rel * max(r_p, r_j) + 1e-6, (r_p, r_j)


def _agree(port, jax_model, X, y, agree, acc):
    pp, pj = port["predict"], np.asarray(jax_model.predict(X))
    assert np.mean(pp == pj) > agree, np.mean(pp == pj)
    a_p, a_j = float(np.mean(pp == y)), float(np.mean(pj == y))
    assert abs(a_p - a_j) < acc, (a_p, a_j)


@pytest.mark.parametrize("case", sorted(mw.FIT_CASES))
def test_every_rank_returns_the_same_model(port_runs, case):
    digests = port_runs(case)["digests"]
    assert len(digests) == mw.W and len(set(digests)) == 1
    ref = port_runs(case, 0)
    for r in range(1, mw.W):
        other = port_runs(case, r)
        assert str(other["digests"][r]) == str(ref["digests"][0])
        np.testing.assert_array_equal(other["predict"], ref["predict"])


def test_gbm_regressor_pointwise_single_round(port_runs):
    # one round: rtol/atol 1e-3, the JAX package's single-round bar
    model, X, y = _jax_fit("gbm_reg_single_round")
    np.testing.assert_allclose(port_runs("gbm_reg_single_round")["predict"],
                               np.asarray(model.predict(X)), rtol=1e-3, atol=1e-3)


def test_gbm_regressor_metric_parity(port_runs):
    # RMSE within 4% (split flips compound over 5 rounds at lr 0.5)
    model, X, y = _jax_fit("gbm_reg_metric")
    _close_rmse(port_runs("gbm_reg_metric"), model, X, y, 0.04)


def test_gbm_regressor_huber(port_runs):
    # huber's delta is the sharded quantile each round; RMSE within 3%
    model, X, y = _jax_fit("gbm_reg_huber")
    _close_rmse(port_runs("gbm_reg_huber"), model, X, y, 0.03)


def test_gbm_regressor_dyadic_round_equals_unsharded(port_runs):
    """Dyadic targets: every sum is exact in any order, so the 4-rank first
    round is bit-identical to the unsharded port fit (and allclose 1e-5 to
    the JAX package's mesh fit)."""
    family, params, base, _, data, _ = mw.FIT_CASES["gbm_reg_dyadic_round"]
    X, y = mw.DATA[data]()
    single = mw.build(st, family, params, base).fit(X, y, device="cpu")
    np.testing.assert_array_equal(port_runs("gbm_reg_dyadic_round")["predict"],
                                  single.predict(X).numpy())
    model, _, _ = _jax_fit("gbm_reg_dyadic_round")
    np.testing.assert_allclose(port_runs("gbm_reg_dyadic_round")["predict"],
                               np.asarray(model.predict(X)), rtol=1e-5, atol=1e-5)


def test_gbm_regressor_validation_early_stop(port_runs):
    # kept rounds within 1, RMSE within 5% (the JAX package's bars)
    model, X, y = _jax_fit("gbm_reg_val_early_stop")
    port = port_runs("gbm_reg_val_early_stop")
    assert abs(int(port["num_members"]) - model.num_members) <= 1
    _close_rmse(port, model, X, y, 0.05)


def test_gbm_classifier_pointwise_single_round(port_runs):
    # (data 2, member 2), depth-2 trees, one round: raw scores within 5e-3
    model, X, y = _jax_fit("gbm_cls_single_round")
    np.testing.assert_allclose(port_runs("gbm_cls_single_round")["predict_raw"],
                               np.asarray(model.predict_raw(X)), rtol=5e-3, atol=5e-3)


def test_gbm_classifier_metric_parity(port_runs):
    # agreement > 0.97 and accuracy within 0.02
    model, X, y = _jax_fit("gbm_cls_metric")
    _agree(port_runs("gbm_cls_metric"), model, X, y, 0.97, 0.02)


def test_gbm_classifier_validation_early_stop(port_runs):
    # kept rounds within 1
    model, X, y = _jax_fit("gbm_cls_val_early_stop")
    assert abs(int(port_runs("gbm_cls_val_early_stop")["num_members"])
               - model.num_members) <= 1


def test_gbm_classifier_validation_chunked_invariance(port_runs):
    """The chunk size does not change a mesh fit with validation: the same
    reductions in the same order, only the commits differ (bit for bit;
    the JAX package's bar is 1e-5)."""
    a, b = port_runs("gbm_cls_val_chunk1"), port_runs("gbm_cls_val_chunk3")
    assert int(a["num_members"]) == int(b["num_members"])
    np.testing.assert_array_equal(a["predict_raw"], b["predict_raw"])


def test_gbm_classifier_indivisible_class_dim(port_runs):
    # 5 class dims on a 4-wide member axis: blocks of 2 with 3 phantoms;
    # agreement > 0.95, accuracy within 0.03
    model, X, y = _jax_fit("gbm_cls_indivisible")
    port = port_runs("gbm_cls_indivisible")
    assert port["predict_raw"].shape == (len(y), 5)
    _agree(port, model, X, y, 0.95, 0.03)


def test_gbm_classifier_hybrid_mesh(port_runs):
    # ("dcn_data", "data", "member") = (2, 1, 2); agreement > 0.97, acc 0.02
    model, X, y = _jax_fit("gbm_cls_hybrid")
    _agree(port_runs("gbm_cls_hybrid"), model, X, y, 0.97, 0.02)


def test_gbm_classifier_scan_chunk_invariance(port_runs):
    # chunk 1 and 3 on the same mesh: bit for bit (JAX's bar: 1e-5)
    a, b = port_runs("gbm_cls_chunk1"), port_runs("gbm_cls_chunk3")
    np.testing.assert_array_equal(a["predict_raw"], b["predict_raw"])
    model, X, y = _jax_fit("gbm_cls_chunk3")
    _agree(b, model, X, y, 0.97, 0.02)


def test_bagging_regressor_parity(port_runs):
    # rows 2-way and members 2-way: RMSE within 2%, > 98% of rows within 1e-3
    model, X, y = _jax_fit("bagging_reg")
    port = port_runs("bagging_reg")
    _close_rmse(port, model, X, y, 0.02)
    close = np.isclose(port["predict"], np.asarray(model.predict(X)), rtol=1e-3, atol=1e-3)
    assert np.mean(close) > 0.98, np.mean(close)
    assert int(port["num_members"]) == 10


def test_bagging_mesh_shards_rows_and_members(port_runs):
    """The (data x member) placement on (data 2, member 2), as the JAX
    package's ``_shard_rows_and_members`` places it: each rank holds half
    the rows of the bins, labels and bag weights, whole thresholds, and
    half of the 10 members (their masks and keys, member-block order)."""
    X, y = mw.reg_data()
    n_half = (len(y) + (-len(y)) % 2) // 2
    keys = [port_runs("placement", r)["keys"] for r in range(mw.W)]
    for r in range(mw.W):
        p = port_runs("placement", r)
        assert tuple(p["xb"]) == (n_half, X.shape[1])
        assert tuple(p["thresholds"]) == (X.shape[1], 63)
        assert tuple(p["y"]) == (n_half,)
        assert tuple(p["fit_w"]) == (5, n_half)
        assert tuple(p["masks"]) == (5, X.shape[1])
    # ranks (data d, member m) = 2d + m: member block m on both data ranks
    np.testing.assert_array_equal(keys[0], keys[2])
    np.testing.assert_array_equal(keys[1], keys[3])
    assert not np.array_equal(keys[0], keys[1])


def test_bagging_classifier_parity(port_runs):
    # 9 members on 4 row ranks, soft votes: agreement > 0.97, acc 0.02
    model, X, y = _jax_fit("bagging_cls")
    _agree(port_runs("bagging_cls"), model, X, y, 0.97, 0.02)


def test_bagging_data_only_mesh(port_runs):
    # a mesh with only a "data" axis: RMSE within 2%
    model, X, y = _jax_fit("bagging_data_only")
    _close_rmse(port_runs("bagging_data_only"), model, X, y, 0.02)


def test_boosting_regressor_pointwise_single_round(port_runs):
    # padding rows masked out of maxError; rtol/atol 1e-3
    model, X, y = _jax_fit("boosting_reg_single_round")
    port = port_runs("boosting_reg_single_round")
    assert int(port["num_members"]) == model.num_members == 1
    np.testing.assert_allclose(port["predict"], np.asarray(model.predict(X)),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("loss", ["linear", "squared"])
def test_boosting_regressor_metric_parity(port_runs, loss):
    # the stopping replay fires at the same round; RMSE within 3%
    model, X, y = _jax_fit(f"boosting_reg_{loss}")
    port = port_runs(f"boosting_reg_{loss}")
    assert int(port["num_members"]) == model.num_members
    _close_rmse(port, model, X, y, 0.03)


def test_boosting_regressor_abort_index(port_runs):
    # Drucker's est_err >= 0.5 abort fires mid-run, at the JAX package's round
    model, X, y = _jax_fit("boosting_reg_abort")
    assert 0 < model.num_members < 10
    assert int(port_runs("boosting_reg_abort")["num_members"]) == model.num_members


def test_boosting_classifier_discrete(port_runs):
    # SAMME: same member count, agreement > 0.85, accuracy within 0.03
    model, X, y = _jax_fit("boosting_cls_discrete")
    port = port_runs("boosting_cls_discrete")
    assert int(port["num_members"]) == model.num_members
    _agree(port, model, X, y, 0.85, 0.03)


def test_boosting_classifier_real(port_runs):
    # SAMME.R: same member count, agreement > 0.75, accuracy within 0.03
    model, X, y = _jax_fit("boosting_cls_real")
    port = port_runs("boosting_cls_real")
    assert int(port["num_members"]) == model.num_members
    _agree(port, model, X, y, 0.75, 0.03)


def test_boosting_scan_chunk_invariance(port_runs):
    # chunk 1 and 3 on the same mesh: bit for bit (JAX's bar: 1e-5)
    a, b = port_runs("boosting_chunk1"), port_runs("boosting_chunk3")
    assert int(a["num_members"]) == int(b["num_members"])
    np.testing.assert_array_equal(a["predict"], b["predict"])


def test_dummy_median_is_the_exact_median(port_runs):
    # the sharded quantile walk lands on the JAX package's exact value
    model, X, y = _jax_fit("dummy_median")
    np.testing.assert_array_equal(port_runs("dummy_median")["predict"],
                                  np.asarray(model.predict(X)))


@pytest.mark.parametrize("case,atol", [
    ("linear_regression", 1e-4),  # reduced normal equations: f32 noise
    ("logistic_regression", 2e-3),  # flat optimum (ROADMAP queue 3)
    ("naive_bayes", 1e-4),  # reduced class moments
    ("mlp_classifier", 1e-4),  # 50 Adam steps on reduced gradients
    ("mlp_regressor", 1e-4),
])
def test_linear_learners_standalone_mesh_fit(port_runs, case, atol):
    model, X, y = _jax_fit(case)
    port = port_runs(case)
    if "predict_proba" in port:
        np.testing.assert_allclose(port["predict_proba"],
                                   np.asarray(model.predict_proba(X)), atol=atol)
    else:
        np.testing.assert_allclose(port["predict"], np.asarray(model.predict(X)),
                                   rtol=atol, atol=atol)


def test_gbm_over_linear_leaves(port_runs):
    # the leaf ridge solves reduce their normal equations; RMSE within 2%
    model, X, y = _jax_fit("gbm_linear_tree")
    _close_rmse(port_runs("gbm_linear_tree"), model, X, y, 0.02)


def test_unported_mesh_options_raise_on_every_rank(port_runs):
    """Gradient row sampling under a mesh raises the JAX package's error
    word for word, and a checkpoint_dir that every rank shares raises (each
    rank writes its own checkpoint), on every rank alike (no rank is left
    waiting in a collective)."""
    for r in range(mw.W):
        errs = port_runs("raises", r)
        assert str(errs["sampling"]).startswith(
            "sampling != 'none' is single-device only for now")
        assert "each rank writes its own directory" in str(errs["checkpoint"])


def _tree_arrays(members):
    return {f: np.asarray(getattr(members, f)) for f in st.ops.tree.Tree._fields}


@pytest.mark.parametrize("case", ["gbm_reg_single_round", "gbm_cls_single_round"])
def test_jax_mesh_fitted_model_carries_across(port_runs, case):
    """A model the JAX package fitted under a mesh (``data_member_mesh(4)``
    shape for the regressor, (2, 2) for the classifier) converts through
    ``convert.py`` unchanged: it predicts as the JAX model does (1e-5) and
    as the port's own mesh fit of the same case (the single-round bars)."""
    model, X, y = _jax_fit(case)
    arrays = dict(_tree_arrays(model.params["members"]),
                  weights=np.asarray(model.params["weights"]))
    if case.startswith("gbm_reg"):
        arrays["init"] = np.asarray(model.params["init"]["value"])
        tm = st.gbm_regressor_from_arrays(model.get_params(), arrays,
                                          num_features=X.shape[1], device="cpu")
        got, want, key, tol = tm.predict(X), model.predict(X), "predict", 1e-3
    else:
        arrays["init_raw"] = np.asarray(model.params["init_raw"])
        tm = st.gbm_classifier_from_arrays(model.get_params(), arrays,
                                           num_features=X.shape[1],
                                           num_classes=model.num_classes, device="cpu")
        got, want, key, tol = tm.predict_raw(X), model.predict_raw(X), "predict_raw", 5e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), port_runs(case)[key], rtol=tol, atol=tol)
