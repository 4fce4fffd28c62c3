"""Warm-start resume of the PyTorch port (``fit_resume``), case for case
with tests/test_fit_resume.py where the case exists in the port (the
serving-side ``PackedModel`` cases wait for the serving slice).  The pin
is bit identity (``torch.equal`` on every params tensor): a model of k
rounds resumed for n more equals one fit of k + n rounds, because the
carry replays from the stored members in the fit's own f32 order and
round keys derive from absolute round indices."""

import numpy as np
import pytest
import torch

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.models.base import tree_leaves

K = 3       # committed rounds in the short fit
N_NEW = 3   # rounds added by the resume
N = K + N_NEW


def _reg_data(n=96, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _cls_data(n=96, d=5, seed=0, noisy=True):
    """3-class labels; ``noisy`` flips every 7th label so no tiny tree is
    perfect (SAMME's ``err <= 0`` stop is a separate test)."""
    X, y = _reg_data(n, d, seed)
    yc = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.float32)
    if noisy:
        yc[::7] = (yc[::7] + 1) % 3
    return X, yc


def _wide_cls_data(n=600, d=5, k=26, seed=0):
    """Letter's 26 classes at a test's size."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    centers = rng.randn(k, d).astype(np.float32)
    y = np.argmax(X @ centers.T + 0.5 * rng.randn(n, k), axis=1)
    return X, y.astype(np.float32)


def _tree(cls="DecisionTreeRegressor"):
    return getattr(st, cls)(max_depth=3)


FAMILIES = {
    "gbm_reg": (
        lambda n, **kw: st.GBMRegressor(num_base_learners=n, seed=0,
                                        base_learner=_tree(), **kw),
        _reg_data,
    ),
    "gbm_huber": (
        lambda n, **kw: st.GBMRegressor(num_base_learners=n, seed=0, loss="huber",
                                        base_learner=_tree(), **kw),
        _reg_data,
    ),
    "gbm_cls": (
        lambda n, **kw: st.GBMClassifier(
            num_base_learners=n, seed=0, learning_rate=0.5,
            optimized_weights=True, base_learner=_tree(), **kw),
        _cls_data,
    ),
    # a learning rate that is not a power of two: the step search's warm
    # start is not weights[-1] / learning_rate (on this 26-class fixture
    # that 1-ulp start moves the next rounds' steps), so the resume replays
    # the committed rounds' step searches
    "gbm_cls_lr03": (
        lambda n, **kw: st.GBMClassifier(
            num_base_learners=n, seed=0, learning_rate=0.3, updates="newton",
            base_learner=_tree(), **kw),
        _wide_cls_data,
    ),
    "samme_discrete": (
        lambda n, **kw: st.BoostingClassifier(
            num_base_learners=n, seed=0, algorithm="discrete",
            base_learner=_tree("DecisionTreeClassifier"), **kw),
        _cls_data,
    ),
    "samme_real": (
        lambda n, **kw: st.BoostingClassifier(
            num_base_learners=n, seed=0, algorithm="real",
            base_learner=_tree("DecisionTreeClassifier"), **kw),
        _cls_data,
    ),
    "drucker": (
        lambda n, **kw: st.BoostingRegressor(num_base_learners=n, seed=0,
                                             base_learner=_tree(), **kw),
        _reg_data,
    ),
}


def _assert_bit_identical(resumed, full, X):
    assert resumed.num_members == full.num_members
    a, b = tree_leaves(resumed.params), tree_leaves(full.params)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(resumed.predict(X), full.predict(X))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fit_resume_bit_identical_to_longer_fit(family):
    make, data = FAMILIES[family]
    X, y = data()
    full = make(N).fit(X, y, device="cpu")
    short = make(K).fit(X, y, device="cpu")
    resumed = short.fit_resume(X, y, N_NEW)
    _assert_bit_identical(resumed, full, X)
    # the source model was never mutated: a second resume reproduces it
    assert short.num_members == K
    _assert_bit_identical(short.fit_resume(X, y, N_NEW), full, X)


@pytest.mark.parametrize("family", ["gbm_reg", "samme_real"])
def test_fit_resume_pipelined_bit_identical(monkeypatch, family):
    """Resuming under ``SE_TPU_PIPELINE=1`` with two-round chunks (so the
    pipeline overlaps) still lands on the straight fit, bit for bit."""
    monkeypatch.setenv("SE_TPU_PIPELINE", "1")
    make, data = FAMILIES[family]
    X, y = data()
    full = make(N, scan_chunk=2).fit(X, y, device="cpu")
    short = make(K, scan_chunk=2).fit(X, y, device="cpu")
    _assert_bit_identical(short.fit_resume(X, y, N_NEW), full, X)


def test_fit_resume_of_a_taken_prefix():
    """``take(k)`` then ``fit_resume`` is the longer fit again."""
    make, data = FAMILIES["gbm_cls"]
    X, y = data()
    full = make(N).fit(X, y, device="cpu")
    _assert_bit_identical(full.take(K).fit_resume(X, y, N_NEW), full, X)


def test_fit_resume_samme_converged_is_noop():
    """SAMME keeps a perfect member and stops; ``fit_resume`` replays the
    final round's error and returns the model unchanged, which is what the
    longer fit produces."""
    X, _ = _reg_data()
    yc = (X[:, 0] > 0).astype(np.float32)  # one tree fits this perfectly
    make = FAMILIES["samme_discrete"][0]
    short = make(K).fit(X, yc, device="cpu")
    full = make(N).fit(X, yc, device="cpu")
    assert full.num_members == short.num_members
    resumed = short.fit_resume(X, yc, N_NEW)
    assert resumed is short
    _assert_bit_identical(resumed, full, X)


def test_fit_resume_validates_args():
    X, y = _reg_data()
    model = st.GBMRegressor(num_base_learners=2, seed=0).fit(X, y, device="cpu")
    with pytest.raises(ValueError, match="n_new_rounds"):
        model.fit_resume(X, y, 0)
    with pytest.raises(ValueError, match="original training matrix"):
        model.fit_resume(X[:, :3], y, 2)


def test_fit_resume_runs_where_the_model_lives(monkeypatch):
    """``fit_resume`` takes the model's device by default; asking for the
    card without one raises instead of falling back."""
    X, y = _reg_data()
    model = st.GBMRegressor(num_base_learners=2, seed=0).fit(X, y, device="cpu")
    assert model.fit_resume(X, y, 1).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.fit_resume(X, y, 1, device="cuda")


def test_fit_resume_of_a_loaded_model(tmp_path):
    """A saved and loaded model resumes like the one that was saved."""
    make, data = FAMILIES["drucker"]
    X, y = data()
    full = make(N).fit(X, y, device="cpu")
    make(K).fit(X, y, device="cpu").save(str(tmp_path / "m"))
    loaded = st.load(str(tmp_path / "m"), device="cpu")
    _assert_bit_identical(loaded.fit_resume(X, y, N_NEW), full, X)
