"""Training-state checkpoints of the PyTorch port (``utils/checkpoint.py``),
case for case with tests/test_checkpoint.py where the case exists in the
port.  The JAX package holds a resumed fit to 1e-4; the port holds it to
bit identity (``torch.equal``): every round's keys derive from its
absolute index, and on the CPU every reduction repeats bit for bit from a
restored carry."""

import logging
import os

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.utils.checkpoint import (
    TrainingCheckpointer as JaxCheckpointer,
)
from spark_ensemble_tpu_torch.utils.checkpoint import (
    TrainingCheckpointer,
    run_fingerprint,
)


def _data(n=400, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _tree(pkg=st, cls="DecisionTreeRegressor"):
    return getattr(pkg, cls)(max_depth=3, max_bins=16)


def test_checkpointer_roundtrip(tmp_path):
    ck = TrainingCheckpointer(str(tmp_path / "ck"), interval=2)
    state = {"v": 1, "best": 2.5, "pred": torch.arange(4.0), "weights": [1.0, 2.0]}
    ck.maybe_save(0, state)  # round 0: (0+1) % 2 != 0 -> skipped
    assert ck.load_latest() is None
    ck.maybe_save(1, state)
    rnd, got = ck.load_latest()
    assert rnd == 1
    assert got["v"] == 1 and got["weights"] == [1.0, 2.0]
    assert torch.equal(got["pred"], torch.arange(4.0))
    ck.delete()
    assert ck.load_latest() is None
    assert not os.path.exists(str(tmp_path / "ck"))


def test_save_copies_the_carry(tmp_path):
    """A save holds the state as it was: a later in-place update of the
    carry cannot reach the pending write."""
    ck = TrainingCheckpointer(str(tmp_path / "ck"), interval=1)
    pred = torch.zeros(8)
    ck.save(0, {"pred": pred})
    pred += 1.0
    _, got = ck.load_latest()
    assert torch.equal(got["pred"], torch.zeros(8))


def _no_delete(monkeypatch):
    monkeypatch.setattr(TrainingCheckpointer, "delete", lambda self: None)


def _resume_vs_full(tmp_path, monkeypatch, make_est, X, y, n_full=6, n_part=4):
    """Fit ``n_full`` rounds straight vs ``n_part`` rounds whose checkpoint
    survives, then resumed to ``n_full``: bit-identical models."""
    ckdir = str(tmp_path / "ck")
    full = make_est(num_base_learners=n_full).fit(X, y, device="cpu")
    with monkeypatch.context() as m:
        _no_delete(m)
        make_est(num_base_learners=n_part, checkpoint_dir=ckdir,
                 checkpoint_interval=n_part).fit(X, y, device="cpu")
    assert os.path.exists(os.path.join(ckdir, "latest", "state.json"))
    resumed = make_est(num_base_learners=n_full, checkpoint_dir=ckdir,
                       checkpoint_interval=100).fit(X, y, device="cpu")
    assert resumed.num_members == full.num_members
    assert torch.equal(full.predict(X), resumed.predict(X))
    return full, resumed


def test_boosting_regressor_resume_matches_uninterrupted(tmp_path, monkeypatch):
    X, y = _data()
    _resume_vs_full(tmp_path, monkeypatch, lambda **kw: st.BoostingRegressor(
        seed=3, loss="linear", base_learner=_tree(), **kw), X, y)


def test_boosting_classifier_resume_matches_uninterrupted(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    X = rng.randn(600, 5).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(600) > 0).astype(np.float32)
    full, resumed = _resume_vs_full(
        tmp_path, monkeypatch, lambda **kw: st.BoostingClassifier(
            seed=3, base_learner=_tree(st, "DecisionTreeClassifier"), **kw), X, y)
    assert torch.equal(full.params["weights"], resumed.params["weights"])


@pytest.mark.parametrize("family", ["regressor", "classifier"])
def test_gbm_resume_matches_uninterrupted(tmp_path, monkeypatch, family):
    """Fit 6 rounds straight vs 4 rounds whose checkpoint survives, then
    resumed with the full budget: the same members, bit for bit."""
    X, y = _data()
    if family == "classifier":
        y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.float32)
        cls = st.GBMClassifier
    else:
        cls = st.GBMRegressor
    full, resumed = _resume_vs_full(
        tmp_path, monkeypatch,
        lambda **kw: cls(seed=3, base_learner=_tree(), **kw), X, y)
    for a, b in zip(full.params["members"], resumed.params["members"]):
        assert torch.equal(a, b)
    assert torch.equal(full.params["weights"], resumed.params["weights"])


def test_gbm_resume_with_changed_interval_keeps_saving(tmp_path, monkeypatch):
    """A resume may start at a round misaligned with a changed
    checkpoint_interval; chunks clamp to the new save boundaries, so the
    periodic saves keep firing."""
    X, y = _data()
    ckdir = str(tmp_path / "gbm_ck2")
    kw = dict(seed=3, scan_chunk=4, base_learner=_tree())
    with monkeypatch.context() as m:
        _no_delete(m)
        st.GBMRegressor(num_base_learners=4, checkpoint_dir=ckdir,
                        checkpoint_interval=4, **kw).fit(X, y, device="cpu")
    saved = []
    orig_save = TrainingCheckpointer.save
    monkeypatch.setattr(TrainingCheckpointer, "save", lambda self, r, s: (
        saved.append(r), orig_save(self, r, s))[1])
    full = st.GBMRegressor(num_base_learners=12, **kw).fit(X, y, device="cpu")
    resumed = st.GBMRegressor(num_base_learners=12, checkpoint_dir=ckdir,
                              checkpoint_interval=5, **kw).fit(X, y, device="cpu")
    assert 4 in saved and 9 in saved, saved
    assert resumed.num_members == full.num_members == 12
    assert torch.equal(full.predict(X), resumed.predict(X))


def test_async_save_roundtrip_and_failure_propagation(tmp_path):
    """Async saves land with the contents of sync saves; overlapping saves
    keep their order; a failed background write re-raises at the next
    checkpointer call."""
    sync = TrainingCheckpointer(str(tmp_path / "sync"), interval=1, async_save=False)
    asy = TrainingCheckpointer(str(tmp_path / "async"), interval=1)
    state = {"v": 3, "pred": torch.arange(16.0), "members": {"leaf": torch.ones((4, 2))}}
    sync.save(0, state)
    asy.save(0, state)
    asy.wait()
    rs, ss = sync.load_latest()[1], asy.load_latest()[1]
    assert torch.equal(ss["pred"], rs["pred"])
    assert torch.equal(ss["members"]["leaf"], rs["members"]["leaf"])
    for i in range(5):
        asy.save(i, {"v": i, "pred": torch.full((8,), float(i))})
    rnd, got = asy.load_latest()
    assert rnd == 4 and float(got["pred"][0]) == 4.0

    class Weird:
        pass

    asy.save(5, {"bad": Weird()})
    with pytest.raises(Exception):
        asy.wait()
    asy.delete()


def test_gbm_fit_with_async_checkpointing_matches(tmp_path):
    """Saves are side effects: a checkpointed fit equals a plain one."""
    X, y = _data(600)
    kw = dict(num_base_learners=6, seed=3, base_learner=_tree())
    plain = st.GBMRegressor(**kw).fit(X, y, device="cpu")
    ck = st.GBMRegressor(checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=2,
                         scan_chunk=2, **kw).fit(X, y, device="cpu")
    assert torch.equal(plain.predict(X), ck.predict(X))
    assert not os.path.exists(str(tmp_path / "ck"))  # deleted at fit end


def test_fingerprint_separates_configs_and_packages():
    """Budget, cadence and policy params keep a checkpoint resumable; a
    config or shape change does not."""
    a = st.GBMRegressor(num_base_learners=5, checkpoint_interval=2)
    b = st.GBMRegressor(num_base_learners=9, checkpoint_interval=3,
                        on_nonfinite="skip_round", max_retries=0)
    c = st.GBMRegressor(learning_rate=0.5)
    fp = lambda est, *parts: est._checkpointer(torch.device("cpu"), *parts).fingerprint
    assert fp(a, 10, 3, 0) == fp(b, 10, 3, 0)
    assert fp(a, 10, 3, 0) != fp(c, 10, 3, 0)
    assert fp(a, 10, 3, 0) != fp(a, 11, 3, 0)
    assert fp(a, 10, 3, 0) != run_fingerprint("GBMRegressor", a._resume_identity(), 10, 3, 0)


def test_jax_checkpoint_starts_a_fresh_port_fit(tmp_path, monkeypatch, caplog):
    """A checkpoint the JAX package wrote is never resumed half-way by the
    port: its fingerprint differs, the fit logs it and starts fresh, and
    lands on the port's own uninterrupted model."""
    X, y = _data(200)
    ckdir = str(tmp_path / "ck")
    monkeypatch.setattr(JaxCheckpointer, "delete", lambda self: None)
    se.GBMRegressor(num_base_learners=2, checkpoint_dir=ckdir, checkpoint_interval=1,
                    base_learner=_tree(se)).fit(X, y)
    assert os.path.exists(os.path.join(ckdir, "latest", "state.json"))
    kw = dict(num_base_learners=3, base_learner=_tree())
    with caplog.at_level(logging.WARNING, logger="spark_ensemble_tpu_torch"):
        resumed = st.GBMRegressor(checkpoint_dir=ckdir, checkpoint_interval=1,
                                  **kw).fit(X, y, device="cpu")
    assert "different run/config" in caplog.text
    plain = st.GBMRegressor(**kw).fit(X, y, device="cpu")
    assert torch.equal(plain.predict(X), resumed.predict(X))
