"""PyTorch port parity: the GBM main path end to end
(``spark_ensemble_tpu_torch`` on ``device="cpu"`` vs ``spark_ensemble_tpu``).

The same numpy data go through both packages at a tiny size (n <= 700,
depth 3, d <= 8).  Tolerances are the JAX package's own pin for its kernel
tiers (tests/test_pallas_hist.py::test_fused_gbm_letter_leg_parity):
probabilities within 1e-3, train accuracy within 0.02.  The JAX side runs
its Pallas tiers in interpret mode, so every hist tier is set explicitly on
both sides (on the CPU 'auto' means scatter)."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st

TIERS = [("scatter", "highest"), ("matmul", "highest"), ("matmul", "pallas"),
         ("fused", "highest")]
CLS = dict(num_base_learners=3, learning_rate=0.3, updates="newton",
           optimized_weights=True)


def _cls_data(n=600, d=8, k=4, seed=15):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T, axis=1)
    return X, y.astype(np.float32)


def _reg_data(n=500, d=6, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = 2.0 * X[:, 0] + np.sin(3.0 * X[:, 1]) + 0.1 * rng.randn(n)
    return X, y.astype(np.float32)


def _tree(pkg, hist, hp="highest"):
    return pkg.DecisionTreeRegressor(hist=hist, hist_precision=hp,
                                     max_depth=3, max_bins=16)


@pytest.mark.parametrize("hist,hp", TIERS)
def test_classifier_matches_per_tier(hist, hp):
    X, y = _cls_data()
    jm = se.GBMClassifier(base_learner=_tree(se, hist, hp), **CLS).fit(X, y)
    tm = st.GBMClassifier(base_learner=_tree(st, hist, hp), **CLS).fit(
        X, y, device="cpu"
    )
    assert tm.params["members"].split_feature.shape == (3, 4, 7)
    p_j, p_t = np.asarray(jm.predict_proba(X)), tm.predict_proba(X).numpy()
    np.testing.assert_allclose(p_t, p_j, atol=1e-3)
    acc_j = np.mean(np.asarray(jm.predict(X)) == y)
    acc_t = np.mean(tm.predict(X).numpy() == y)
    assert abs(acc_j - acc_t) < 0.02
    np.testing.assert_allclose(
        tm.params["weights"].numpy(), np.asarray(jm.params["weights"]),
        rtol=1e-3, atol=1e-4,
    )


@pytest.mark.parametrize(
    "hist,init",
    [("scatter", "constant"), ("matmul", "constant"), ("fused", "constant"),
     ("scatter", "zero"), ("scatter", "base")],
)
def test_regressor_matches_per_tier(hist, init):
    X, y = _reg_data()
    kw = dict(num_base_learners=3, learning_rate=0.5, init_strategy=init)
    jm = se.GBMRegressor(base_learner=_tree(se, hist), **kw).fit(X, y)
    tm = st.GBMRegressor(base_learner=_tree(st, hist), **kw).fit(
        X, y, device="cpu"
    )
    np.testing.assert_allclose(
        tm.predict(X).numpy(), np.asarray(jm.predict(X)),
        atol=1e-3 * np.abs(y).max(),
    )


def test_validation_early_stop_matches():
    """Patience bookkeeping (`_patience_step`): same validation history,
    same number of kept rounds."""
    X, y = _reg_data(n=700, seed=5)
    kw = dict(num_base_learners=8, learning_rate=0.5, num_rounds=1,
              validation_tol=0.1)
    vi = np.zeros(len(y), bool)
    vi[::4] = True
    jm = se.GBMRegressor(base_learner=_tree(se, "matmul"), **kw).fit(
        X, y, validation_indicator=vi)
    tm = st.GBMRegressor(base_learner=_tree(st, "matmul"), **kw).fit(
        X, y, validation_indicator=vi, device="cpu")
    np.testing.assert_allclose(
        tm.validation_history_, jm.validation_history_, rtol=1e-4
    )
    assert tm.num_members == jm.num_members < 8
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-4)


def test_classifier_validation_history_matches():
    X, y = _cls_data(n=700, seed=7)
    vi = np.zeros(len(y), bool)
    vi[::4] = True
    kw = dict(CLS, num_base_learners=2)
    jm = se.GBMClassifier(base_learner=_tree(se, "matmul"), **kw).fit(
        X, y, validation_indicator=vi)
    tm = st.GBMClassifier(base_learner=_tree(st, "matmul"), **kw).fit(
        X, y, validation_indicator=vi, device="cpu")
    np.testing.assert_allclose(
        tm.validation_history_, jm.validation_history_, rtol=1e-4
    )


def _tree_arrays(members):
    return {f: np.asarray(getattr(members, f)) for f in st.ops.tree.Tree._fields}


def test_carried_classifier_params_predict_the_same():
    """A JAX-fitted model's arrays carried into the port predict the same
    raw scores (predict parity apart from fit parity)."""
    X, y = _cls_data(n=500, seed=11)
    jm = se.GBMClassifier(base_learner=_tree(se, "matmul"), **CLS).fit(X, y)
    arrays = dict(_tree_arrays(jm.params["members"]),
                  weights=np.asarray(jm.params["weights"]),
                  init_raw=np.asarray(jm.params["init_raw"]))
    tm = st.gbm_classifier_from_arrays(
        jm.get_params(), arrays, num_features=X.shape[1],
        num_classes=jm.num_classes, device="cpu",
    )
    assert isinstance(tm.base_learner, st.DecisionTreeRegressor)
    Xq = np.random.RandomState(12).randn(300, X.shape[1]).astype(np.float32)
    np.testing.assert_allclose(
        tm.predict_raw(Xq).numpy(), np.asarray(jm.predict_raw(Xq)),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_array_equal(tm.predict(Xq).numpy(),
                                  np.asarray(jm.predict(Xq)))


def test_carried_regressor_params_predict_the_same():
    X, y = _reg_data(seed=13)
    jm = se.GBMRegressor(base_learner=_tree(se, "scatter"),
                         num_base_learners=4).fit(X, y)
    arrays = dict(_tree_arrays(jm.params["members"]),
                  weights=np.asarray(jm.params["weights"]),
                  init=np.asarray(jm.params["init"]["value"]))
    tm = st.gbm_regressor_from_arrays(jm.get_params(), arrays,
                                      num_features=X.shape[1], device="cpu")
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "jcls,tcls",
    [(se.GBMClassifier, st.GBMClassifier), (se.GBMRegressor, st.GBMRegressor),
     (se.DecisionTreeRegressor, st.DecisionTreeRegressor),
     (se.DummyClassifier, st.DummyClassifier),
     (se.DummyRegressor, st.DummyRegressor)],
)
def test_params_have_the_reference_names_and_defaults(jcls, tcls):
    jdefs, tdefs = jcls._param_defs(), tcls._param_defs()
    assert sorted(jdefs) == sorted(tdefs)
    for name, p in jdefs.items():
        assert tdefs[name].default == p.default, name


@pytest.mark.parametrize(
    "params",
    [dict(on_nonfinite="halve_step"),
     dict(profile_dir="prof"),
     dict(checkpoint_dir="ckpt"), dict(telemetry_path="t.jsonl"),
     dict(on_nonfinite="skip_round"), dict(on_nonfinite="stop_early")],
)
def test_unsupported_params_raise(params, tmp_path):
    """Params that raised before their plane was ported now fit: the
    recovery policies and checkpoints (the round runtime), and telemetry
    and profiling, which stream the fit's events and capture a trace."""
    X, y = _cls_data(n=64)
    for key in ("checkpoint_dir", "profile_dir", "telemetry_path"):
        if key in params:
            params = {key: str(tmp_path / params[key])}
    model = st.GBMClassifier(num_base_learners=1, **params).fit(X, y, device="cpu")
    assert model.num_members == 1
    assert torch.isfinite(model.predict_proba(X)).all()
    if "telemetry_path" in params:
        with open(params["telemetry_path"]) as f:
            events = [json.loads(line) for line in f]
        assert [e["event"] for e in events if e["event"] != "span"] == [
            "fit_start", "round_start", "round_end", "fit_end"]
        assert list(model.fit_history_["round"]) == [0]
    if "profile_dir" in params:
        from spark_ensemble_tpu_torch.utils.profiling import summarize_trace

        rows, total = summarize_trace(params["profile_dir"], device_only=False)
        assert rows and total > 0


@pytest.mark.parametrize(
    "params",
    [dict(sampling="goss"), dict(sample_method="goss"), dict(sampling="mvs"),
     dict(leaf_model="linear"), dict(hist="stream")],
)
def test_formerly_unported_params_fit_as_the_reference(params):
    """Gradient row sampling, linear leaves and the stream tier raised
    before they were ported; each now fits as the JAX package does: a
    2-round regressor within 1e-4 of the label scale of the JAX package's
    predictions.  Continuous targets and 180 sampled rows of 600 keep the
    split gains tie-free (a few dozen weighted rows in a depth-3 tree tie
    two features' partitions exactly, and each package then breaks the
    tie by its own rounding)."""
    X, y = _reg_data(n=600)
    hist = params.pop("hist", "scatter")
    kw = dict(num_base_learners=2, learning_rate=0.5, **params)
    jm = se.GBMRegressor(base_learner=_tree(se, hist), **kw).fit(X, y)
    tm = st.GBMRegressor(base_learner=_tree(st, hist), **kw).fit(
        X, y, device="cpu"
    )
    np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                               atol=1e-4 * np.abs(y).max())


def test_mesh_and_regressor_losses_raise():
    """Checkpoints under a mesh raise (queue 1, item 29); every regression
    loss of the JAX package is ported, and an unknown one is refused."""
    X, y = _reg_data(n=64)
    with pytest.raises(ValueError):
        st.GBMRegressor(loss="nope")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 29"):
        st.GBMRegressor(checkpoint_dir="unused").fit(X, y, mesh=object(), device="cpu")


def test_cuda_is_the_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _cls_data(n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.GBMClassifier(num_base_learners=1).fit(X, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.GBMRegressor(num_base_learners=1).fit(X, y, device="cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, checked by its import statements: the
    top-level module name must differ from 'jax', 'jaxlib' and
    'spark_ensemble_tpu' exactly (the port's own name starts with the
    latter)."""
    root = Path(st.__file__).parent
    banned = {"jax", "jaxlib", "spark_ensemble_tpu"}
    seen = 0
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                seen += 1
                assert name.split(".")[0] not in banned, (path, name)
    assert seen > 20
    smoke = Path(st.__file__).parents[1] / "chip_smoke.py"
    for node in ast.walk(ast.parse(smoke.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module])
            assert not any(n.split(".")[0] in banned for n in names)
