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

import datetime
import os
import sys

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


SUITES = {
    "fit": lambda rank, out_dir: run_fit(rank, out_dir, list(FIT_CASES)),
    "quantile": run_quantile,
    "collective": run_collective,
    "mesh": run_mesh,
}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(suite, out_dir, timeout=600):
    """Run ``suite`` on W rank processes -> each rank's output.  A rank that
    fails or outlives ``timeout`` fails the run: the survivors are killed
    and ``RuntimeError`` carries every rank's output tail."""
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
            [sys.executable, os.path.abspath(__file__), str(r), str(W), str(port),
             str(out_dir), suite],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(W)
    ]
    deadline = time.time() + timeout
    outs = [None] * W
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
