"""PyTorch port parity: AdaBoost (``spark_ensemble_tpu_torch/models/
boosting.py`` vs ``models/boosting.py``): SAMME, SAMME.R and Drucker R2,
4 rounds, on the scatter and fused tiers, plus the abort-and-drop rules.

n = 512 makes the first round's normalized weights dyadic, so round 0 is
exact.  Later rounds reweight rows by non-dyadic factors, and the two
packages sum them in different orders; the pins are:
- kept rounds equal; estimator weights within rtol 1e-5;
- predictions equal on at least 98% of rows (regression: within 1e-5 of
  the target scale);
- probabilities within 1e-4.
The classification fixture has label noise, so no leaf is pure: a pure
leaf puts log(EPS) into SAMME.R's weights, which then span ~1e23, and the
JAX package's own probabilities move by more than 1e-4 there when only
its rows are permuted (another summation order)."""

import numpy as np
import pytest

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st


def _cls_data(seed=31, n=512, d=6, k=4, noise=1.0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T
                  + noise * rng.randn(n, k), axis=1).astype(np.float32)
    return X, y


def _reg_data(seed=32, n=512, d=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (2.0 * X[:, 0] + np.sin(3.0 * X[:, 1]) + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y


def _tree(pkg, cls, hist, **kw):
    return getattr(pkg, cls)(hist=hist, max_depth=kw.pop("max_depth", 3),
                             max_bins=16, **kw)


def _fit_cls(hist, X, y, **kw):
    kw.setdefault("num_base_learners", 4)
    tree_kw = kw.pop("tree", {})
    jm = se.BoostingClassifier(
        base_learner=_tree(se, "DecisionTreeClassifier", hist, **dict(tree_kw)), **kw
    ).fit(X, y)
    tm = st.BoostingClassifier(
        base_learner=_tree(st, "DecisionTreeClassifier", hist, **dict(tree_kw)), **kw
    ).fit(X, y, device="cpu")
    return jm, tm


def _share_equal(a, b):
    return float(np.mean(a == b))


@pytest.mark.parametrize("hist", ["scatter", "fused"])
@pytest.mark.parametrize("algorithm", ["discrete", "real"])
def test_boosting_classifier_matches(algorithm, hist):
    X, y = _cls_data()
    jm, tm = _fit_cls(hist, X, y, algorithm=algorithm)
    assert tm.num_members == jm.num_members == 4
    np.testing.assert_allclose(tm.params["weights"].numpy(),
                               np.asarray(jm.params["weights"]), rtol=1e-5)
    np.testing.assert_array_equal(tm.params["members"].split_feature.numpy()[0],
                                  np.asarray(jm.params["members"].split_feature)[0])
    assert _share_equal(tm.predict(X).numpy(), np.asarray(jm.predict(X))) >= 0.98
    np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                               np.asarray(jm.predict_proba(X)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.take(1).predict_proba(X).numpy(),
                               np.asarray(jm.take(1).predict_proba(X)), rtol=0, atol=1e-4)


@pytest.mark.parametrize("hist", ["scatter", "fused"])
@pytest.mark.parametrize("voting", ["median", "mean"])
@pytest.mark.parametrize("loss", ["exponential", "linear", "squared"])
def test_boosting_regressor_matches(loss, voting, hist):
    X, y = _reg_data()
    kw = dict(num_base_learners=4, loss=loss, voting_strategy=voting)
    jm = se.BoostingRegressor(base_learner=_tree(se, "DecisionTreeRegressor", hist),
                              **kw).fit(X, y)
    tm = st.BoostingRegressor(base_learner=_tree(st, "DecisionTreeRegressor", hist),
                              **kw).fit(X, y, device="cpu")
    assert tm.num_members == jm.num_members
    np.testing.assert_allclose(tm.params["weights"].numpy(),
                               np.asarray(jm.params["weights"]), rtol=1e-5)
    close = np.abs(tm.predict(X).numpy() - np.asarray(jm.predict(X))) <= 1e-5 * np.abs(y).max()
    assert close.mean() >= 0.98
    assert tm.score(X, y) == pytest.approx(jm.score(X, y), abs=1e-4)


def test_samme_aborts_and_drops_round_zero():
    """Two balanced classes and a tree that cannot split: the root leaf
    ties, err = 0.5 >= 1 - 1/K, so round 0 is dropped and the model has no
    members (zero raw scores, uniform probabilities)."""
    rng = np.random.RandomState(33)
    X = rng.randn(256, 4).astype(np.float32)
    y = np.repeat([0.0, 1.0], 128).astype(np.float32)
    jm, tm = _fit_cls("scatter", X, y, algorithm="discrete",
                      tree={"min_info_gain": 1e9})
    assert tm.num_members == jm.num_members == 0
    assert tm.params["members"] is None
    np.testing.assert_array_equal(tm.predict_raw(X).numpy(), np.asarray(jm.predict_raw(X)))
    np.testing.assert_array_equal(tm.predict_proba(X).numpy(), np.full((256, 2), 0.5, np.float32))


@pytest.mark.parametrize("algorithm", ["discrete", "real"])
def test_perfect_classifier_round_is_kept_and_stops(algorithm):
    rng = np.random.RandomState(34)
    X = rng.randn(256, 4).astype(np.float32)
    X[:, 0] = rng.randint(0, 4, 256)
    y = X[:, 0].copy()
    jm, tm = _fit_cls("scatter", X, y, algorithm=algorithm)
    assert tm.num_members == jm.num_members == 1
    np.testing.assert_array_equal(tm.params["weights"].numpy(), np.asarray(jm.params["weights"]))
    np.testing.assert_array_equal(tm.predict(X).numpy(), y)


@pytest.mark.parametrize("hist", ["scatter", "fused"])
def test_drucker_stops_at_zero_max_error(hist):
    """A target the first tree fits exactly: maxError == 0 keeps that round
    with weight 1.0 and stops."""
    rng = np.random.RandomState(35)
    X = rng.randn(256, 4).astype(np.float32)
    X[:, 0] = rng.randint(0, 4, 256)
    y = (0.5 * X[:, 0]).astype(np.float32)
    kw = dict(num_base_learners=4)
    jm = se.BoostingRegressor(base_learner=_tree(se, "DecisionTreeRegressor", hist),
                              **kw).fit(X, y)
    tm = st.BoostingRegressor(base_learner=_tree(st, "DecisionTreeRegressor", hist),
                              **kw).fit(X, y, device="cpu")
    assert tm.num_members == jm.num_members == 1
    np.testing.assert_array_equal(tm.params["weights"].numpy(), [1.0])
    np.testing.assert_array_equal(tm.predict(X).numpy(), np.asarray(jm.predict(X)))


def test_take_is_the_shorter_fit():
    X, y = _cls_data(seed=36, n=256)
    full = st.BoostingClassifier(
        base_learner=_tree(st, "DecisionTreeClassifier", "scatter"), num_base_learners=4
    ).fit(X, y, device="cpu")
    short = st.BoostingClassifier(
        base_learner=_tree(st, "DecisionTreeClassifier", "scatter"), num_base_learners=2
    ).fit(X, y, device="cpu")
    np.testing.assert_array_equal(full.take(2).predict_raw(X).numpy(),
                                  short.predict_raw(X).numpy())
    Xr, yr = _reg_data(seed=37, n=256)
    reg = st.BoostingRegressor(
        base_learner=_tree(st, "DecisionTreeRegressor", "scatter"), num_base_learners=3
    ).fit(Xr, yr, device="cpu")
    assert reg.take(10).num_members == reg.num_members
    assert reg.take(1).predict(Xr).shape == (256,)


def test_carried_boosting_models_predict_the_same():
    X, y = _cls_data(seed=38, n=400)
    for algorithm in ("discrete", "real"):
        jm = se.BoostingClassifier(
            base_learner=_tree(se, "DecisionTreeClassifier", "scatter"),
            num_base_learners=3, algorithm=algorithm,
        ).fit(X, y)
        arrays = {f: np.asarray(getattr(jm.params["members"], f))
                  for f in st.ops.tree.Tree._fields}
        arrays["weights"] = np.asarray(jm.params["weights"])
        tm = st.boosting_classifier_from_arrays(
            jm.get_params(), arrays, num_features=6, num_classes=jm.num_classes,
            device="cpu",
        )
        np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                                   np.asarray(jm.predict_proba(X)), rtol=1e-5, atol=1e-6)
    Xr, yr = _reg_data(seed=39, n=300)
    jr = se.BoostingRegressor(base_learner=_tree(se, "DecisionTreeRegressor", "scatter"),
                              num_base_learners=3).fit(Xr, yr)
    arrays = {f: np.asarray(getattr(jr.params["members"], f))
              for f in st.ops.tree.Tree._fields}
    arrays["weights"] = np.asarray(jr.params["weights"])
    tr = st.boosting_regressor_from_arrays(jr.get_params(), arrays, num_features=6,
                                           device="cpu")
    np.testing.assert_array_equal(tr.predict(Xr).numpy(), np.asarray(jr.predict(Xr)))


@pytest.mark.parametrize(
    "jcls,tcls",
    [(se.BoostingClassifier, st.BoostingClassifier),
     (se.BoostingRegressor, st.BoostingRegressor)],
)
def test_boosting_params_have_the_reference_names_and_defaults(jcls, tcls):
    jdefs, tdefs = jcls._param_defs(), tcls._param_defs()
    assert sorted(jdefs) == sorted(tdefs)
    for name, p in jdefs.items():
        assert tdefs[name].default == p.default, name


def test_unported_boosting_planes_raise(tmp_path):
    """Checkpoints under a mesh still raise (queue 1, item 29); checkpoints
    and fit_resume, which raised before persistence was ported, run."""
    X, y = _cls_data(n=64)
    ck = st.BoostingClassifier(num_base_learners=2, checkpoint_dir=str(tmp_path / "ckpt"))
    assert ck.fit(X, y, device="cpu").num_members >= 1
    with pytest.raises(NotImplementedError, match="queue 1, item 29"):
        st.BoostingRegressor(checkpoint_dir=str(tmp_path / "m")).fit(
            X, y, mesh=object(), device="cpu")
    model = st.BoostingClassifier(num_base_learners=1).fit(X, y, device="cpu")
    resumed = model.fit_resume(X, y, 2)
    assert resumed.num_members >= model.num_members
