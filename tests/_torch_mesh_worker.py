"""One rank of the port's mesh fits on the CPU, for the tests.

Run as ``python _torch_mesh_worker.py <rank> <world> <port> <out_dir>
<suite>``: the rank joins a gloo process group on ``127.0.0.1:<port>``,
builds the suite's meshes and runs its cases, writing each case's arrays
to ``<out_dir>/<case>_r<rank>.npz`` and ``WORKER_OK`` to stdout at the
end.  It imports only the port (and numpy), never jax or the JAX package.
The tests import the data and the cases from here, so both packages see
the same inputs.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys
import time

import numpy as np

W = 4  # ranks of every suite


def reg_data(n=700, d=9, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] * 2.0 + np.sin(X[:, 1] * 3.0) + 0.05 * rng.randn(n)).astype(np.float32)
    return X, y


def cls_data(n=700, d=8, k=4, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    centers = rng.randn(k, d).astype(np.float32)
    y = np.argmax(X @ centers.T + 0.3 * rng.randn(n, k), axis=1).astype(np.float32)
    return X, y


def abort_data():
    """Drucker's abort fixture: outliers soak up the boosting weight until
    est_err crosses 0.5 mid-run."""
    rng = np.random.RandomState(2)
    n = 640
    X = rng.randn(n, 4).astype(np.float32)
    y = (2.0 * X[:, 0] + 0.1 * rng.randn(n)).astype(np.float32)
    y = np.where(rng.rand(n) < 0.05, y + 50.0, y).astype(np.float32)
    return X, y


def dyadic_reg_data(n=512, d=6, seed=0):
    """Targets k/64 and unit weights: every f32 sum of them (and of the
    residuals from their mean) is exact in any order, so a mesh fit's first
    round equals the unsharded one at a fixed step (the line search's sums
    of products with leaf values are not dyadic)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (rng.randint(-256, 256, n) / 64.0).astype(np.float32)
    return X, y


DATA = {
    "reg": reg_data,
    "reg900": lambda: reg_data(n=900),
    "cls": cls_data,
    "cls900": lambda: cls_data(n=900),
    "cls5": lambda: cls_data(k=5),
    "abort": abort_data,
    "dyadic": dyadic_reg_data,
}

_VI900 = ("vi", 700)

#: case -> (family, params, base (name, params) or None, mesh, data, fit kwargs)
FIT_CASES = {
    "gbm_reg_single_round": (
        "GBMRegressor", dict(num_base_learners=1, loss="squared", updates="newton",
                             optimized_weights=True, subsample_ratio=0.8,
                             replacement=False, seed=7),
        None, "dm4", "reg", {}),
    "gbm_reg_metric": (
        "GBMRegressor", dict(num_base_learners=5, loss="squared", updates="newton",
                             learning_rate=0.5, subsample_ratio=0.8,
                             replacement=False, seed=7),
        None, "dm4", "reg", {}),
    "gbm_reg_huber": (
        "GBMRegressor", dict(num_base_learners=3, loss="huber", alpha=0.9, seed=1),
        None, "dm4", "reg", {}),
    "gbm_reg_dyadic_round": (
        "GBMRegressor", dict(num_base_learners=1, loss="squared",
                             optimized_weights=False, seed=0),
        ("DecisionTreeRegressor", dict(max_depth=3)), "dm4", "dyadic", {}),
    "gbm_reg_val_early_stop": (
        "GBMRegressor", dict(num_base_learners=8, loss="huber", alpha=0.9,
                             num_rounds=2, seed=2),
        None, "dm4", "reg900", {"validation": 700}),
    "gbm_cls_single_round": (
        "GBMClassifier", dict(num_base_learners=1, loss="logloss", updates="newton",
                              learning_rate=0.5, seed=5),
        ("DecisionTreeRegressor", dict(max_depth=2)), "dm42", "cls", {}),
    "gbm_cls_metric": (
        "GBMClassifier", dict(num_base_learners=4, loss="logloss", updates="newton",
                              learning_rate=0.5, seed=5),
        None, "dm42", "cls", {}),
    "gbm_cls_val_early_stop": (
        "GBMClassifier", dict(num_base_learners=8, loss="logloss", num_rounds=2, seed=2),
        None, "dm4", "cls900", {"validation": 700}),
    "gbm_cls_val_chunk1": (
        "GBMClassifier", dict(num_base_learners=8, loss="logloss", num_rounds=2, seed=2,
                              scan_chunk=1),
        None, "dm4", "cls900", {"validation": 700}),
    "gbm_cls_val_chunk3": (
        "GBMClassifier", dict(num_base_learners=8, loss="logloss", num_rounds=2, seed=2,
                              scan_chunk=3),
        None, "dm4", "cls900", {"validation": 700}),
    "gbm_cls_indivisible": (
        "GBMClassifier", dict(num_base_learners=3, loss="logloss", updates="newton",
                              learning_rate=0.5, seed=5),
        None, "m4", "cls5", {}),
    "gbm_cls_hybrid": (
        "GBMClassifier", dict(num_base_learners=3, loss="logloss", updates="newton",
                              learning_rate=0.5, seed=5),
        None, "hyb", "cls", {}),
    "gbm_cls_chunk1": (
        "GBMClassifier", dict(num_base_learners=4, loss="logloss", updates="newton",
                              learning_rate=0.5, seed=6, scan_chunk=1),
        None, "dm42", "cls", {}),
    "gbm_cls_chunk3": (
        "GBMClassifier", dict(num_base_learners=4, loss="logloss", updates="newton",
                              learning_rate=0.5, seed=6, scan_chunk=3),
        None, "dm42", "cls", {}),
    "bagging_reg": (
        "BaggingRegressor", dict(num_base_learners=10, subsample_ratio=0.9, seed=11),
        None, "dm42", "reg", {}),
    "bagging_cls": (
        "BaggingClassifier", dict(num_base_learners=9, voting_strategy="soft",
                                  subspace_ratio=0.8, seed=12),
        None, "dm4", "cls", {}),
    "bagging_data_only": (
        "BaggingRegressor", dict(num_base_learners=5, subsample_ratio=0.9, seed=11),
        None, "d4", "reg", {}),
    "boosting_reg_single_round": (
        "BoostingRegressor", dict(num_base_learners=1, loss="exponential", seed=7),
        None, "dm4", "reg", {}),
    "boosting_reg_linear": (
        "BoostingRegressor", dict(num_base_learners=6, loss="linear", seed=3),
        None, "dm4", "reg", {}),
    "boosting_reg_squared": (
        "BoostingRegressor", dict(num_base_learners=6, loss="squared", seed=3),
        None, "dm4", "reg", {}),
    "boosting_reg_abort": (
        "BoostingRegressor", dict(num_base_learners=10, loss="squared", seed=1),
        ("DecisionTreeRegressor", dict(max_depth=3)), "dm4", "abort", {}),
    "boosting_cls_discrete": (
        "BoostingClassifier", dict(num_base_learners=6, algorithm="discrete", seed=9),
        None, "dm4", "cls", {}),
    "boosting_cls_real": (
        "BoostingClassifier", dict(num_base_learners=5, algorithm="real", seed=9),
        None, "dm4", "cls", {}),
    "boosting_chunk1": (
        "BoostingRegressor", dict(num_base_learners=5, loss="exponential", seed=4,
                                  scan_chunk=1),
        None, "dm4", "reg", {}),
    "boosting_chunk3": (
        "BoostingRegressor", dict(num_base_learners=5, loss="exponential", seed=4,
                                  scan_chunk=3),
        None, "dm4", "reg", {}),
    "dummy_median": (
        "DummyRegressor", dict(strategy="median"), None, "dm42", "reg", {}),
    "linear_regression": (
        "LinearRegression", dict(), None, "dm4", "reg", {}),
    "logistic_regression": (
        "LogisticRegression", dict(), None, "dm4", "cls", {}),
    "naive_bayes": (
        "GaussianNaiveBayes", dict(), None, "dm4", "cls", {}),
    "mlp_classifier": (
        "MLPClassifier", dict(hidden_layer_sizes=(16,), max_iter=50, seed=3),
        None, "dm4", "cls", {}),
    "mlp_regressor": (
        "MLPRegressor", dict(hidden_layer_sizes=(8,), max_iter=50), None, "dm4", "reg", {}),
    "gbm_linear_tree": (
        "GBMRegressor", dict(num_base_learners=2, learning_rate=0.5, seed=1),
        ("LinearTreeRegressor", dict(max_depth=2)), "dm4", "reg", {}),
}


def build(pkg, family, params, base):
    """The case's estimator from ``pkg`` (the port or the JAX package)."""
    kw = dict(params)
    if base is not None:
        kw["base_learner"] = getattr(pkg, base[0])(**base[1])
    return getattr(pkg, family)(**kw)


def fit_kwargs(case, n):
    extra = FIT_CASES[case][5]
    if "validation" in extra:
        vi = np.zeros(n, bool)
        vi[extra["validation"]:] = True
        return {"validation_indicator": vi}
    return {}


def _meshes(pmesh):
    return {
        "dm4": lambda: pmesh.data_member_mesh(W, device="cpu"),
        "dm42": lambda: pmesh.data_member_mesh(W, member=2, device="cpu"),
        "hyb": lambda: pmesh.hybrid_data_member_mesh(dcn_data=2, member=2, device="cpu"),
        "m4": lambda: pmesh.create_mesh({"data": 1, "member": 4}, device="cpu"),
        "d4": lambda: pmesh.create_mesh({"data": 4}, device="cpu"),
    }


def _arrays(tree, prefix, out):
    from spark_ensemble_tpu_torch.models.base import tree_leaves

    for i, t in enumerate(tree_leaves(tree)):
        if t is not None:
            out[f"{prefix}{i}"] = np.asarray(t.cpu().numpy() if hasattr(t, "cpu") else t)


def run_fit(rank, out_dir, cases):
    import torch

    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.parallel import mesh as pmesh

    makers = _meshes(pmesh)
    meshes = {}
    for case in cases:
        family, params, base, mesh_name, data, _ = FIT_CASES[case]
        if mesh_name not in meshes:
            meshes[mesh_name] = makers[mesh_name]()
        mesh = meshes[mesh_name]
        X, y = DATA[data]()
        est = build(st, family, params, base)
        model = est.fit(X, y, mesh=mesh, device="cpu", **fit_kwargs(case, len(y)))
        digests = pmesh.replica_digests(model)
        out = {"digests": np.array(digests), "predict": model.predict(X).numpy(),
               "num_members": np.array(getattr(model, "num_members", -1))}
        if hasattr(model, "predict_raw"):
            out["predict_raw"] = model.predict_raw(X).numpy()
        if hasattr(model, "predict_proba"):
            out["predict_proba"] = model.predict_proba(X).numpy()
        _arrays(model.params, "param_", out)
        np.savez(os.path.join(out_dir, f"{case}_r{rank}.npz"), **out)
    # the (data x member) placement of Bagging, structurally: this rank's
    # rows and member block (the JAX test reads its shard shapes)
    X, y = reg_data()
    est = st.BaggingRegressor(num_base_learners=10)
    base = est._base()
    ctx = base.make_fit_ctx(torch.from_numpy(X))
    yt = torch.from_numpy(y)
    fit_w, masks, keys = est._member_plan(len(y), X.shape[1], torch.ones_like(yt))
    s_ctx, s_y, s_fw, s_masks, s_keys = est._shard_rows_and_members(
        meshes["dm42"], base, ctx, yt, fit_w, masks, keys)
    np.savez(os.path.join(out_dir, f"placement_r{rank}.npz"),
             xb=np.array(s_ctx["Xb"].shape), thresholds=np.array(s_ctx["thresholds"].shape),
             y=np.array(s_y.shape), fit_w=np.array(s_fw.shape),
             masks=np.array(s_masks.shape), keys=s_keys.numpy())
    errors = {}
    for name, est in (("sampling", st.GBMRegressor(num_base_learners=2, sampling="goss")),
                      ("checkpoint", st.GBMClassifier(checkpoint_dir=out_dir))):
        try:
            est.fit(X, (y > 0).astype(np.float32), mesh=meshes["dm4"], device="cpu")
            errors[name] = ""
        except (ValueError, NotImplementedError) as e:
            errors[name] = str(e)
    np.savez(os.path.join(out_dir, f"raises_r{rank}.npz"), **errors)


def mixed_values(rng, n):
    """Values across binades (1e-6..1e6), negatives and heavy repeats."""
    v = np.concatenate([
        rng.randn(n // 4) * 1e-6,
        rng.randn(n // 4) * 1e6,
        rng.randn(n // 4),
        np.repeat(rng.randn(16), (n // 4) // 16),
    ]).astype(np.float32)
    rng.shuffle(v)
    return v


def quantile_cases():
    """name -> (values, weights, q): the eight cases of the JAX package's
    mesh-quantile tests, on dyadic weights (every partial sum exact)."""
    out = {}
    rng = np.random.RandomState(3)
    for trial in range(2):
        v = mixed_values(rng, 4096)
        w = (rng.randint(0, 8, size=v.shape[0]) / 4.0).astype(np.float32)
        out[f"exact_{trial}"] = (v, w, np.array([0.0, 0.1, 0.5, 0.9, 1.0], np.float32))
    rng = np.random.RandomState(4)
    v = mixed_values(rng, 2048)
    out["median"] = (v, (rng.randint(0, 5, size=v.shape[0]) / 2.0).astype(np.float32), None)
    rng = np.random.RandomState(5)
    out["vector_q"] = (rng.randn(1024).astype(np.float32), np.ones(1024, np.float32),
                       np.array([0.25, 0.5, 0.75], np.float32))
    out["column"] = (np.arange(4096, dtype=np.float32), np.ones(4096, np.float32),
                     np.array(0.9, np.float32))
    rng = np.random.RandomState(6)
    v = mixed_values(rng, 2048)
    out["one_rank"] = (v, (rng.randint(0, 8, size=v.shape[0]) / 4.0).astype(np.float32),
                       np.array([0.1, 0.5, 0.9], np.float32))
    rng = np.random.RandomState(7)
    v = rng.randn(512).astype(np.float32)
    w = np.ones(512, np.float32)
    v[17], w[17] = np.nan, 0.0
    out["nan"] = (v, w, np.array(0.5, np.float32))
    w = np.ones(64, np.float32)
    w[0] = 0.0
    out["zero_weight_min"] = (np.arange(64, dtype=np.float32), w, np.array(0.001, np.float32))
    return out


def run_quantile(rank, out_dir):
    import torch
    import torch.distributed as dist

    from spark_ensemble_tpu_torch.ops import collective as coll
    from spark_ensemble_tpu_torch.parallel import mesh as pmesh
    from spark_ensemble_tpu_torch.utils import quantile as qmod

    mesh = pmesh.data_member_mesh(W, device="cpu")
    # a one-rank axis per rank (every rank creates every group)
    singles = [dist.new_group([r]) for r in range(W)]
    one = coll.Axis(singles[rank], [rank], ("data",), {"data": 0})
    out = {}
    for name, (v, w, q) in quantile_cases().items():
        vt, wt = torch.from_numpy(v), torch.from_numpy(w)
        n = v.shape[0]
        vl, wl = pmesh.shard_rows(mesh, vt, n), pmesh.shard_rows(mesh, wt, n)
        coll.reset_collective_stats()
        if q is None:
            got = qmod.weighted_median(vl, wl, axis_name=mesh.row_axis)
        elif name == "one_rank":
            got = qmod.weighted_quantile(vt, torch.from_numpy(q), wt, axis_name=one)
        else:
            got = qmod.weighted_quantile(vl, torch.from_numpy(q), wl, axis_name=mesh.row_axis)
        out[name] = got.numpy()
        out[name + "_bytes"] = np.array(coll.collective_stats()["bytes"])
    # the crossing walk with a target one ulp above the total converges
    # on the data max
    v = torch.arange(1.0, 65.0)
    vl = pmesh.shard_rows(mesh, v, 64)
    wl = torch.ones_like(vl)
    lo = qmod._f32_keys(coll.pmin_reduce(torch.min(vl), mesh.row_axis))
    hi = qmod._f32_keys(coll.pmax_reduce(torch.max(vl), mesh.row_axis))
    target = torch.tensor(np.nextafter(np.float32(64.0), np.float32(np.inf)))
    key = qmod._sharded_crossing_key(qmod._f32_keys(vl), wl, lo, hi, target,
                                     mesh.row_axis)
    out["above_total"] = qmod._key_to_f32(key).numpy()
    np.savez(os.path.join(out_dir, f"quantile_r{rank}.npz"), **out)


def run_collective(rank, out_dir):
    import torch
    import torch.distributed as dist

    from spark_ensemble_tpu_torch.ops import collective as coll
    from spark_ensemble_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.data_member_mesh(W, device="cpu")
    singles = [dist.new_group([r]) for r in range(W)]
    one = coll.Axis(singles[rank], [rank], ("data",), {"data": 0})
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((3, 5, 7), generator=g)
    ints = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * rank
    coll.reset_collective_stats()
    out = {
        "x": x.numpy(),
        "sum": coll.preduce(x, mesh.row_axis).numpy(),
        "sum_pair": np.concatenate([t.reshape(-1).numpy() for t in coll.preduce(
            [x, 2 * x[0]], mesh.row_axis)]),
        "max": coll.pmax_reduce(x, mesh.row_axis).numpy(),
        "min": coll.pmin_reduce(x, mesh.row_axis).numpy(),
        "gather": coll.pgather(ints, mesh.row_axis, dim=1).numpy(),
        "one_sum": coll.preduce(x, one).numpy(),
        "one_max": coll.pmax_reduce(x, one).numpy(),
        "one_min": coll.pmin_reduce(x, one).numpy(),
    }
    stats = coll.collective_stats()
    out["gathers"] = np.array(stats["gathers"])
    out["bytes"] = np.array(stats["bytes"])
    np.savez(os.path.join(out_dir, f"collective_r{rank}.npz"), **out)


def run_mesh(rank, out_dir):
    import torch

    from spark_ensemble_tpu_torch.parallel import mesh as pmesh, multihost

    out = {"process_count": np.array(multihost.process_count()),
           "process_index": np.array(multihost.process_index()),
           "slice_count": np.array(multihost.slice_count())}
    n = 701
    X = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    for name, make in _meshes(pmesh).items():
        m = make()
        n_pad, lo, hi = pmesh.row_block(m, n)
        out[f"{name}_block"] = np.array([n_pad, lo, hi])
        out[f"{name}_rows"] = pmesh.shard_rows(m, X, n).numpy()
        out[f"{name}_shape"] = np.array(list(m.shape.values()))
        out[f"{name}_sizes"] = np.array(pmesh.mesh_sizes(m))
        out[f"{name}_row_ranks"] = np.array(m.row_axis.ranks)
        out[f"{name}_member_ranks"] = np.array(
            m.member_axis.ranks if m.member_axis is not None else [rank])
    errors = []
    for bad in (lambda: pmesh.data_member_mesh(W, member=3, device="cpu"),
                lambda: pmesh.create_mesh({"data": 3}, device="cpu"),
                lambda: pmesh.hybrid_data_member_mesh(dcn_data=3, device="cpu")):
        try:
            bad()
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)
    np.savez(os.path.join(out_dir, f"mesh_r{rank}.npz"), **out)


# -- the elastic shard sweep (tests/test_torch_elastic.py) -------------------


def elastic_data(n=300, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def elastic_cls_labels(X):
    return ((X[:, 0] + X[:, 1] > 0).astype(np.int32)
            + (X[:, 2] > 0.5).astype(np.int32)).astype(np.float32)


def mirrored_data(n=158, d=5, seed=11):
    """Dyadic labels in mirrored pairs (mean exactly 0): round 0's sums are
    exact in any order, so round 0's splits match the JAX package's."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    h = rng.randint(-16, 17, size=n // 2).astype(np.float32) / 8.0
    y = np.concatenate([h, -h])[rng.permutation(n)]
    return X, y


#: the reference fit of the cross-package check: (rounds, GBMRegressor kw)
XPKG_KW = dict(learning_rate=0.5, seed=0)
#: the preemption of the elastic cases
PREEMPT_SITE = "GBMRegressor:stream_round:2:level:1:dist_step:1"


def stream_base(pkg, **kw):
    kw.setdefault("max_depth", 3)
    kw.setdefault("max_bins", 16)
    kw.setdefault("hist", "stream")
    return pkg.DecisionTreeRegressor(**kw)


def _host_preempt_at(chaos, site, victim):
    class HostPreemptAt(chaos.ChaosController):
        """Fires ``host_preempt`` at one site only, with a pinned victim
        (every other fault never fires)."""

        def __init__(self):
            super().__init__(seed=0, rate=0.0)
            self.fired = []

        def host_preempt(self, s):
            if s == site and not self.fired:
                self.fired.append(s)
                return True
            return False

        def pick(self, fault, s, n):
            return victim % n

    return HostPreemptAt()


def _save(out_dir, name, rank, **arrays):
    np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"), **arrays)


def run_elastic(rank, out_dir):
    import json

    import torch
    import torch.distributed as dist

    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.autotune.resolve import override
    from spark_ensemble_tpu_torch.data import ShardStore, write_shards
    from spark_ensemble_tpu_torch.parallel import elastic, mesh as pmesh
    from spark_ensemble_tpu_torch.robustness import chaos
    from spark_ensemble_tpu_torch.robustness.chaos import ChaosHostPreemption
    from spark_ensemble_tpu_torch.telemetry import global_metrics, record_fits

    digest = pmesh.params_digest
    X, y = elastic_data()
    Xm, ym = mirrored_data()
    X157, y157 = elastic_data(n=157, d=5)
    Xc = elastic_data(n=256, d=5, seed=3)[0]
    yc = elastic_cls_labels(Xc)
    stores = {"s32": (X, 32), "s16": (X[:160], 16), "m64": (Xm, 64),
              "c32": (Xc, 32)}
    if rank == 0:
        for name, (Xs, sr) in stores.items():
            write_shards(Xs, os.path.join(out_dir, name), max_bins=16, shard_rows=sr,
                         device="cpu")
        with override(stream_chunk_rows=64, shard_rows=64):
            write_shards(X157, os.path.join(out_dir, "r64"), max_bins=16, shard_rows=64,
                         device="cpu")
    dist.barrier()
    store = {name: ShardStore.open(os.path.join(out_dir, name))
             for name in list(stores) + ["r64"]}
    reg = lambda **kw: st.GBMRegressor(**{"base_learner": stream_base(st),
                                          "num_base_learners": 4, "seed": 0, **kw})
    single = reg().fit_streaming(store["s32"], y, device="cpu")
    m4 = pmesh.data_member_mesh(4, device="cpu")

    # 1. ordered bit-identity: W=4, the 2x2 hybrid mesh, W=2 (each half of
    # the ranks), resident stream fits at matched chunk rows, a classifier,
    # psum, the refusals, the events and the collectives
    out = {"single": digest(single.params)}
    out["w4"] = digest(reg().fit_streaming(store["s32"], y, mesh=m4, device="cpu").params)
    plain = elastic.last_fit_stats()
    # the measure mode fences every reduce and keeps the bits; a
    # manifest-only handle (shards=[]) has each rank verify its own shards
    os.environ[elastic._MEASURE_ENV] = "1"
    try:
        lean = ShardStore.open(os.path.join(out_dir, "s32"), shards=[])
        out["measured"] = digest(reg().fit_streaming(lean, y, mesh=m4, device="cpu").params)
        measured = elastic.last_fit_stats()
    finally:
        del os.environ[elastic._MEASURE_ENV]
    out["stats"] = np.array([measured["reduce_s"], measured["sweep_s"], measured["steps"],
                             plain["reduce_s"], plain["steps"]])
    hyb = pmesh.hybrid_data_member_mesh(dcn_data=2, device="cpu")
    out["hybrid"] = digest(reg().fit_streaming(store["s32"], y, mesh=hyb,
                                               device="cpu").params)
    with override(stream_chunk_rows=64, shard_rows=64):
        out["resident64"] = digest(reg().fit(X157, y157, device="cpu").params)
        out["dist64"] = digest(reg().fit_streaming(store["r64"], y157, mesh=m4,
                                                   device="cpu").params)
    cls = lambda: st.GBMClassifier(base_learner=stream_base(st), num_base_learners=3, seed=3)
    out["cls_single"] = digest(cls().fit_streaming(store["c32"], yc, device="cpu").params)
    psum = reg().fit_streaming(store["s32"], y, mesh=m4, reduce="psum", device="cpu")
    out["psum_pred"] = psum.predict(X).numpy()
    out["single_pred"] = single.predict(X).numpy()
    errors = []
    for bad in (lambda: reg().fit_streaming(store["s32"], y, mesh=m4, reduce="mean",
                                            device="cpu"),
                lambda: reg().fit_streaming(
                    store["s32"], y, device="cpu",
                    mesh=pmesh.data_member_mesh(4, member=2, device="cpu"))):
        try:
            bad()
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)
    # the port's 4-rank fit of the cross-package check (one and three rounds)
    for r in (1, 3):
        xm = st.GBMRegressor(base_learner=stream_base(st), num_base_learners=r,
                             **XPKG_KW).fit_streaming(store["m64"], ym, mesh=m4,
                                                      device="cpu")
        members = xm.params["members"]
        for f in members._fields:
            out[f"xpkg{r}_{f}"] = getattr(members, f).numpy()
        out[f"xpkg{r}_predict"] = xm.predict(Xm).numpy()
    half = [0, 1] if rank < 2 else [2, 3]
    m2 = pmesh.create_mesh({"data": 2, "member": 1}, device="cpu", ranks=half)
    out["w2"] = digest(reg().fit_streaming(store["s32"], y, mesh=m2, device="cpu").params)
    out["cls_w2"] = digest(cls().fit_streaming(store["c32"], yc, mesh=m2,
                                               device="cpu").params)
    with record_fits() as rec:
        reg(num_base_learners=2).fit_streaming(store["s32"], y, mesh=m2, device="cpu")
    out["events"] = np.array([e["event"] for e in rec.events])
    cfg = next(e for e in rec.events if e["event"] == "dist_config")
    out["config"] = np.array([cfg["positions"], cfg["shards"], cfg["steps"]])
    # the collectives of a fit: one gather a sweep step whatever the shard
    # count and width, one node-id gather a tree, one digest agreement
    calls = []
    real = elastic._all_gather

    def counted(x, axis):
        calls.append(f"{x.dtype}:{x.dim()}")
        return real(x, axis)

    elastic._all_gather = counted
    try:
        for W, mesh in ((2, m2), (4, m4)):
            for name in ("s32", "s16"):
                calls.clear()
                reg(base_learner=stream_base(st, max_depth=2), num_base_learners=3).fit_streaming(
                    store[name], y[:store[name].n], mesh=mesh, device="cpu")
                K = -(-store[name].num_shards // W)
                out[f"calls_{W}_{name}"] = np.array([len(calls), 1 + 3 * (3 * K + 1)])
                out[f"kinds_{W}_{name}"] = np.array(sorted(set(calls)))
    finally:
        elastic._all_gather = real
    # 2. preempt -> repartition -> rewind -> resume.  Every rank has built
    # the same groups so far, as the survivors' groups need (see Mesh)
    tel = os.path.join(out_dir, f"tel_r{rank}")
    os.makedirs(tel, exist_ok=True)
    seen = {}

    ctl = _host_preempt_at(chaos, PREEMPT_SITE, victim=1)
    real_hook = ctl.host_preempt

    def snooping(s):
        if s == PREEMPT_SITE and not ctl.fired:
            seen.update(global_metrics().snapshot())
        return real_hook(s)

    ctl.host_preempt = snooping
    chaos.install(ctl)
    coord = elastic.ElasticCoordinator(m4)
    assert coord.statusz()["attempts"] == 0
    res = {"victim": False}
    try:
        model = coord.fit_streaming(
            reg(checkpoint_dir=os.path.join(out_dir, f"ck_r{rank}"), checkpoint_interval=1,
                telemetry_path=os.path.join(tel, "t.jsonl")),
            ShardStore.open(os.path.join(out_dir, "s32"), shards=[]), y, device="cpu")
        sz = coord.statusz()
        res.update(
            digest=digest(model.params), losses=json.dumps(coord.losses),
            width=pmesh.mesh_sizes(coord.mesh)[0], mesh_ranks=np.array(coord.mesh.ranks),
            statusz=json.dumps({k: sz[k] for k in ("attempts", "width", "losses",
                                                    "process_count", "ranks")}),
            last_fit_steps=sz["last_fit"]["steps"],
            mid_attempts=seen[coord._source_name]["value"]["attempts"],
            unregistered=coord._source_name not in global_metrics().snapshot(),
        )
    except ChaosHostPreemption:
        res["victim"] = True
    finally:
        chaos.install(None)
    res["fired"] = ctl.fired
    res["flight"] = os.path.exists(os.path.join(tel, f"flight_p{os.getpid()}.json"))
    res["fid"] = elastic.preempt_flow_id(1, PREEMPT_SITE)
    _save(out_dir, "elastic_resume", rank, single=digest(single.params), **res)

    # 3. max_losses: a loss past it re-raises on the survivors (the victim,
    # rank 1 again, leaves as before)
    class Always(type(ctl)):
        def host_preempt(self, s):
            return s.endswith("level:0:dist_step:0")

    res = {}
    chaos.install(Always())
    coord = elastic.ElasticCoordinator(m4, max_losses=0)
    try:
        coord.fit_streaming(reg(), store["s16"], y[:160], device="cpu")
        res["raised"] = ""
    except (elastic.HostLostError, ChaosHostPreemption) as e:
        res["raised"] = type(e).__name__
    finally:
        chaos.install(None)
    res["losses"] = len(coord.losses)
    res["attempts"] = coord.attempts
    _save(out_dir, "max_losses", rank, **res)

    # 4. losing the rank that hosts the store: the survivors raise at once
    chaos.install(_host_preempt_at(chaos, "GBMRegressor:stream_round:0:level:0:dist_step:0",
                                   victim=0))
    t0 = time.perf_counter()
    try:
        elastic.ElasticCoordinator(m4).fit_streaming(reg(), store["s16"], y[:160],
                                                     device="cpu")
        res = {"raised": ""}
    except RuntimeError as e:
        res = {"raised": str(e)}
    except ChaosHostPreemption:
        res = {"raised": "victim"}
    finally:
        chaos.install(None)
    _save(out_dir, "store_host", rank, seconds=time.perf_counter() - t0, **res)

    # 5. W=3 over the survivors of case 2 (their group histories match;
    # rank 1, the victim there, sits out)
    if rank != 1:
        m3 = pmesh.create_mesh({"data": 3, "member": 1}, device="cpu", ranks=[0, 2, 3])
        out["w3"] = digest(reg().fit_streaming(store["s32"], y, mesh=m3, device="cpu").params)
    _save(out_dir, "ordered", rank, **out)


# -- per-rank telemetry streams of an elastic rewind (tests/test_torch_podview.py)

#: ranks of the podview suite: a 3-wide mesh that loses rank 1
PODVIEW_W = 3


def run_podview(rank, out_dir):
    """A 3-rank ``ElasticCoordinator`` fit that loses rank 1 at
    ``PREEMPT_SITE``, each rank streaming its telemetry to
    ``tel_r{rank}/t.jsonl`` (the survivors: the first attempt's spans, the
    rewind, the resumed fit's; the victim: its spans up to the
    ``host_preempt``), and each survivor's params digest."""
    import torch.distributed as dist

    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.data import ShardStore, write_shards
    from spark_ensemble_tpu_torch.parallel import elastic, mesh as pmesh
    from spark_ensemble_tpu_torch.robustness import chaos
    from spark_ensemble_tpu_torch.robustness.chaos import ChaosHostPreemption

    X, y = elastic_data()
    if rank == 0:
        write_shards(X, os.path.join(out_dir, "s32"), max_bins=16, shard_rows=32,
                     device="cpu")
    dist.barrier()
    m3 = pmesh.data_member_mesh(PODVIEW_W, device="cpu")
    tel = os.path.join(out_dir, f"tel_r{rank}")
    os.makedirs(tel, exist_ok=True)
    est = st.GBMRegressor(base_learner=stream_base(st), num_base_learners=4, seed=0,
                          checkpoint_dir=os.path.join(out_dir, f"ck_r{rank}"),
                          checkpoint_interval=1,
                          telemetry_path=os.path.join(tel, "t.jsonl"))
    chaos.install(_host_preempt_at(chaos, PREEMPT_SITE, victim=1))
    res = {"victim": False, "fid": elastic.preempt_flow_id(1, PREEMPT_SITE)}
    try:
        model = elastic.ElasticCoordinator(m3).fit_streaming(
            est, ShardStore.open(os.path.join(out_dir, "s32"), shards=[]), y, device="cpu")
        res["digest"] = pmesh.params_digest(model.params)
    except ChaosHostPreemption:
        res["victim"] = True
    finally:
        chaos.install(None)
    _save(out_dir, "podview", rank, **res)


# -- checkpoints, Stacking, tuning, Pipeline and the sweep over a mesh ------
# (tests/test_torch_mesh_planes.py)


def stacking_data(n=500, d=6, k=3, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X[:, :3] @ rng.randn(3, k) + 0.5 * rng.randn(n, k), axis=1)
    return X, y.astype(np.float32)


def stacking_bases(pkg):
    """bench.py's Stacking config: DT + LR + GaussianNB."""
    return [pkg.DecisionTreeClassifier(max_depth=3, max_bins=16, hist="scatter"),
            pkg.LogisticRegression(reg_param=1e-2), pkg.GaussianNaiveBayes()]


def tuning_data(seed=6, n=640, d=6, k=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    centers = rng.randn(k, d).astype(np.float32)
    y = np.argmax(X @ centers.T + 0.5 * rng.randn(n, k), axis=1).astype(np.float32)
    return X, y


def _preempted(chaos, fit, site):
    """Run ``fit`` under a chaos preemption at ``site`` -> whether it fired."""
    ctl = chaos.ChaosController(seed=0, rate=1.0, faults=("preempt",))
    ctl._draw = lambda fault, s: 0.0 if s == site else 1.0
    chaos.install(ctl)
    try:
        fit()
    except chaos.ChaosPreemption:
        return True
    finally:
        chaos.install(None)
    return False


def run_planes(rank, out_dir):
    import torch

    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.models.gbm_sweep import fit_sweep
    from spark_ensemble_tpu_torch.parallel import mesh as pmesh
    from spark_ensemble_tpu_torch.robustness import chaos
    from spark_ensemble_tpu_torch.telemetry import record_fits
    from spark_ensemble_tpu_torch.utils.checkpoint import TrainingCheckpointer

    digest = pmesh.params_digest
    m4 = pmesh.data_member_mesh(W, device="cpu")
    m42 = pmesh.data_member_mesh(W, member=2, device="cpu")
    tree = lambda: st.DecisionTreeRegressor(max_depth=3, max_bins=16)
    ck = lambda name: os.path.join(out_dir, f"{name}_r{rank}")
    out = {}

    # checkpoints under a mesh: preempted after a save, then resumed, equal
    # to the uninterrupted mesh fit (the class dims over member=2 too)
    X, y = cls_data()
    Xr, yr = reg_data(n=900)
    vi = np.zeros(900, bool)
    vi[700:] = True
    cases = {
        "gbm_cls": (lambda **kw: st.GBMClassifier(
            num_base_learners=6, learning_rate=0.5, seed=5, base_learner=tree(), **kw),
            m42, X, y, {}, "GBMClassifier:after_round:4"),
        "gbm_reg_val": (lambda **kw: st.GBMRegressor(
            num_base_learners=6, loss="huber", alpha=0.9, seed=1, base_learner=tree(),
            num_rounds=10, **kw), m4, Xr, yr, {"validation_indicator": vi},
            "GBMRegressor:after_round:4"),
        "samme": (lambda **kw: st.BoostingClassifier(
            num_base_learners=6, algorithm="discrete", seed=3,
            base_learner=st.DecisionTreeClassifier(max_depth=3, max_bins=16), **kw),
            m4, X, y, {}, "BoostingClassifier:after_round:4"),
    }
    for name, (make, mesh, Xc, yc, kw, site) in cases.items():
        ref = make().fit(Xc, yc, mesh=mesh, device="cpu", **kw)
        est = make(checkpoint_dir=ck(name), checkpoint_interval=2)
        fired = _preempted(chaos, lambda: est.fit(Xc, yc, mesh=mesh, device="cpu", **kw),
                           site)
        with record_fits() as rec:
            resumed = est.fit(Xc, yc, mesh=mesh, device="cpu", **kw)
        out[f"{name}_fired"] = fired
        out[f"{name}_equal"] = digest(resumed.params) == digest(ref.params)
        out[f"{name}_digests"] = np.array(pmesh.replica_digests(resumed))
        out[f"{name}_resumed_at"] = np.array(
            [e["round"] for e in rec.events if e["event"] == "resume_from_checkpoint"])

    # a single-device checkpoint whose validation padding differs (nv=101,
    # nv_pad=104 on 4 ranks) starts the mesh fit fresh
    Xv, yv = cls_data(n=901)
    vi = np.zeros(901, bool)
    vi[800:] = True
    cfg = dict(num_base_learners=6, loss="logloss", num_rounds=3, seed=2,
               base_learner=tree(), checkpoint_interval=2, scan_chunk=2)
    keep = TrainingCheckpointer.delete
    TrainingCheckpointer.delete = lambda self: None
    try:
        st.GBMClassifier(**dict(cfg, num_base_learners=4, checkpoint_dir=ck("stale"))).fit(
            Xv, yv, validation_indicator=vi, device="cpu")
    finally:
        TrainingCheckpointer.delete = keep
    with record_fits() as rec:
        stale = st.GBMClassifier(**dict(cfg, checkpoint_dir=ck("stale"))).fit(
            Xv, yv, validation_indicator=vi, mesh=m4, device="cpu")
    fresh = st.GBMClassifier(**cfg).fit(Xv, yv, validation_indicator=vi, mesh=m4,
                                        device="cpu")
    out["stale_equal"] = digest(stale.params) == digest(fresh.params)
    out["stale_resumed"] = sum(e["event"] == "resume_from_checkpoint" for e in rec.events)
    out["stale_members"] = np.array([stale.num_members, fresh.num_members])

    # one directory for every rank, or a directory on some ranks only
    errors = []
    for dirs in ([os.path.join(out_dir, "shared")] * W,
                 [ck("some")] + [None] * (W - 1)):
        try:
            st.GBMRegressor(num_base_learners=2, checkpoint_dir=dirs[rank]).fit(
                Xr, yr, mesh=m4, device="cpu")
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    out["dir_errors"] = np.array(errors)

    # Stacking: member i on the rank at mesh position i mod W only
    fits = []

    def counting(base):
        real = base.fit

        def fit(*a, **k):
            fits.append(type(base).__name__)
            return real(*a, **k)

        object.__setattr__(base, "fit", fit)
        return base

    Xs, ys = stacking_data()
    stack = st.StackingClassifier(base_learners=[counting(b) for b in stacking_bases(st)],
                                  stacker=st.LogisticRegression(reg_param=1e-2),
                                  stack_method="proba").fit(Xs, ys, mesh=m4, device="cpu")
    out["stack_fits"] = np.array(fits)
    out["stack_digest"] = digest([m.params for m in stack.base_models]
                                 + [stack.stack_model.params])
    out["stack_proba"] = stack.predict_proba(Xs).numpy()

    # the megabatch sweep: lanes over member=2 (6 lanes, 3 a rank), each
    # equal to its lane of the unsharded sweep; member=1 runs it whole
    Xt, yt = tuning_data()
    lanes = [st.GBMClassifier(num_base_learners=3, learning_rate=lr, seed=s,
                              base_learner=tree())
             for lr in (0.3, 1.0) for s in (0, 1, 2)]
    whole = fit_sweep(lanes, Xt, yt, device="cpu")
    for name, mesh in (("m42", m42), ("m4", m4)):
        got = fit_sweep(lanes, Xt, yt, mesh=mesh, device="cpu")
        out[f"sweep_{name}_equal"] = np.array(
            [digest(a.params) == digest(b.params) for a, b in zip(got, whole)])

    # the tuners and Pipeline pass the mesh into every candidate fit
    grid = st.ParamGridBuilder().add_grid("learning_rate", [0.3, 1.0]).build()
    gbm = lambda: st.GBMClassifier(num_base_learners=2, loss="logloss")
    ev = st.MulticlassClassificationEvaluator(metric="accuracy")
    cv = st.CrossValidator(estimator=gbm(), evaluator=ev, estimator_param_maps=grid,
                           num_folds=2, seed=0).fit(Xt, yt, mesh=m4, device="cpu")
    out["cv_avg"] = np.array(cv.avg_metrics)
    out["cv_digest"] = digest(cv.best_model.params)
    cv_on = st.CrossValidator(estimator=gbm(), evaluator=ev, estimator_param_maps=grid,
                              num_folds=2, seed=0, megabatch="on").fit(
        Xt, yt, mesh=m42, device="cpu")
    cv_off = st.CrossValidator(estimator=gbm(), evaluator=ev, estimator_param_maps=grid,
                               num_folds=2, seed=0, megabatch="off").fit(Xt, yt, device="cpu")
    out["cv_on_off"] = np.array([cv_on.avg_metrics, cv_off.avg_metrics])
    tvs = st.TrainValidationSplit(estimator=gbm(), evaluator=ev,
                                  estimator_param_maps=grid, seed=0).fit(
        Xt, yt, mesh=m4, device="cpu")
    out["tvs_metrics"] = np.array(tvs.validation_metrics)
    pipe = st.Pipeline(stages=[st.StandardScaler(), gbm()]).fit(Xt, yt, mesh=m4,
                                                                device="cpu")
    out["pipe_accuracy"] = float(np.mean(pipe.predict(Xt).numpy() == yt))
    out["pipe_digest"] = digest(pipe.stage_models[-1].params)
    _save(out_dir, "planes", rank, **out)


SUITES = {
    "fit": lambda rank, out_dir: run_fit(rank, out_dir, list(FIT_CASES)),
    "quantile": run_quantile,
    "collective": run_collective,
    "podview": run_podview,
    "mesh": run_mesh,
    "elastic": run_elastic,
    "planes": run_planes,
}


@contextlib.contextmanager
def one_rank_mesh(member=1):
    """A one-rank gloo group in this process and its ``data_member_mesh``
    (the mesh planes' single-process tests); the group is torn down on
    exit."""
    import torch.distributed as dist

    from spark_ensemble_tpu_torch.parallel import mesh as pmesh, multihost

    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu",
                         timeout=datetime.timedelta(seconds=60))
    try:
        yield pmesh.data_member_mesh(1, member=member, device="cpu")
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(suite, out_dir, timeout=600, world=W):
    """Run ``suite`` on ``world`` rank processes -> each rank's output.  A
    rank that fails or outlives ``timeout`` fails the run: the survivors
    are killed and ``RuntimeError`` carries every rank's output tail."""
    import subprocess
    import time

    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, os.path.dirname(os.path.abspath(__file__)), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port),
             str(out_dir), suite],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    deadline = time.time() + timeout
    outs = [None] * world
    failed = False
    while any(o is None for o in outs):
        for r, p in enumerate(procs):
            if outs[r] is None and p.poll() is not None:
                outs[r] = p.stdout.read()
                failed = failed or p.returncode != 0
        if failed or time.time() > deadline:
            break
        time.sleep(0.2)
    for r, p in enumerate(procs):
        if outs[r] is None:
            p.kill()
            outs[r] = (p.communicate()[0] or "") + "\n[killed]"
            failed = True
    if failed:
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n{o[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"mesh ranks failed ({suite}):\n{tails}")
    return outs


def main(argv):
    rank, world, port, out_dir, suite = (int(argv[1]), int(argv[2]), int(argv[3]),
                                         argv[4], argv[5])
    import torch

    torch.set_num_threads(1)
    from spark_ensemble_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=120))
    SUITES[suite](rank, out_dir)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main(sys.argv)
