"""The round executor of the PyTorch port (``execution.py``), case for
case with tests/test_pipeline_exec.py where the case exists in the port.
The contract is bit identity (``torch.equal``): ``SE_TPU_PIPELINE=0``
pins the synchronous path, and every depth yields the same model (same
members, same predictions, same early-stop round), because round keys
derive from absolute round indices and a stop or a guard recovery drops
the chunks in flight."""

import numpy as np
import pytest
import torch

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch import execution


def _reg_data(n=600, d=8, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] + np.sin(2.0 * X[:, 1]) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _clf_data(n=600, d=8, k=4, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    centers = rng.randn(k, d).astype(np.float32)
    y = np.argmax(X @ centers.T, axis=1).astype(np.float32)
    return X, y


def _tree(cls="DecisionTreeRegressor"):
    return getattr(st, cls)(max_depth=3, max_bins=16)


def _val_split(n):
    vi = np.zeros((n,), bool)
    vi[::4] = True
    return vi


def test_depth_resolution_env_wins(monkeypatch):
    monkeypatch.setenv(execution.PIPELINE_ENV, "2")
    assert execution.resolve_pipeline_depth() == 2
    monkeypatch.setenv(execution.PIPELINE_ENV, "0")
    assert execution.resolve_pipeline_depth() == 0
    monkeypatch.setenv(execution.PIPELINE_ENV, "99")
    assert execution.resolve_pipeline_depth() == execution.MAX_PIPELINE_DEPTH
    monkeypatch.setenv(execution.PIPELINE_ENV, "-3")
    assert execution.resolve_pipeline_depth() == 0


def test_depth_resolution_invalid_env_falls_back(monkeypatch):
    monkeypatch.setenv(execution.PIPELINE_ENV, "banana")
    assert execution.resolve_pipeline_depth() == execution.DEFAULT_PIPELINE_DEPTH
    monkeypatch.delenv(execution.PIPELINE_ENV, raising=False)
    assert execution.resolve_pipeline_depth() == execution.DEFAULT_PIPELINE_DEPTH


class _ToyAdapter(execution.RoundAdapter):
    """Counts rounds in chunks of 2 and invalidates the tail once at
    round 4, like a mid-chunk validation stop that rewinds the frontier."""

    def __init__(self, depth):
        self.depth = depth
        self.i = self.i_disp = 0
        self.launched, self.committed = [], []
        self.rewound = False

    def should_continue(self):
        return self.i < 8

    def can_launch(self):
        return self.i_disp < 8

    def launch(self):
        self.launched.append(self.i_disp)
        self.i_disp += 2
        return self.i_disp - 2

    def commit(self, entry, speculated):
        self.committed.append((entry, speculated))
        self.i = entry + 2
        if self.i == 4 and not self.rewound:
            self.rewound = True
            self.i = 3  # the stop kept 3 rounds; the frontier rewinds
            return True
        return False

    def reset_frontier(self):
        self.i_disp = self.i


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_executor_window_and_invalidation(depth):
    """The window holds depth + 1 chunks; commits run in launch order; an
    invalidation drops the tail unread and relaunches from the rewound
    frontier."""
    a = execution.RoundExecutor(_ToyAdapter(depth)).run()
    assert [e for e, _ in a.committed] == [0, 2, 3, 5, 7]
    assert all(s == (depth > 0) for e, s in a.committed[:1])
    # the dropped chunks were launched but never committed
    assert len(a.launched) - len(a.committed) == min(depth, 2)


@pytest.mark.parametrize("depth", [1, 2])
def test_gbm_regressor_bit_identical_across_depths(monkeypatch, depth):
    X, y = _reg_data()
    vi = _val_split(X.shape[0])

    def run(d):
        monkeypatch.setenv(execution.PIPELINE_ENV, str(d))
        return st.GBMRegressor(num_base_learners=10, scan_chunk=3, num_rounds=4,
                               base_learner=_tree()).fit(
            X, y, validation_indicator=vi, device="cpu")

    sync, piped = run(0), run(depth)
    assert sync.num_members == piped.num_members
    assert torch.equal(sync.predict(X), piped.predict(X))
    np.testing.assert_array_equal(sync.validation_history_, piped.validation_history_)


@pytest.mark.parametrize("depth", [1, 2])
def test_gbm_classifier_bit_identical_and_midchunk_stop(monkeypatch, depth):
    """Tight patience and two-round chunks: the validation stop lands while
    speculative chunks are in flight, and they are dropped."""
    X, y = _clf_data()
    vi = _val_split(X.shape[0])

    def run(d):
        monkeypatch.setenv(execution.PIPELINE_ENV, str(d))
        return st.GBMClassifier(num_base_learners=14, scan_chunk=2, num_rounds=2,
                                learning_rate=1.0, base_learner=_tree()).fit(
            X, y, validation_indicator=vi, device="cpu")

    sync, piped = run(0), run(depth)
    assert sync.num_members == piped.num_members
    assert sync.num_members < 14  # the stop fired
    assert torch.equal(sync.predict_proba(X), piped.predict_proba(X))


def test_gbm_no_validation_bit_identical(monkeypatch):
    X, y = _reg_data()

    def run(d):
        monkeypatch.setenv(execution.PIPELINE_ENV, str(d))
        return st.GBMRegressor(num_base_learners=6, scan_chunk=2,
                               base_learner=_tree()).fit(X, y, device="cpu")

    sync, piped = run(0), run(2)
    assert torch.equal(sync.predict(X), piped.predict(X))


@pytest.mark.parametrize("algorithm", ["discrete", "real"])
def test_boosting_classifier_bit_identical(monkeypatch, algorithm):
    X, y = _clf_data()

    def run(d):
        monkeypatch.setenv(execution.PIPELINE_ENV, str(d))
        return st.BoostingClassifier(
            num_base_learners=6, scan_chunk=2, algorithm=algorithm,
            base_learner=_tree("DecisionTreeClassifier")).fit(X, y, device="cpu")

    sync, piped = run(0), run(1)
    assert sync.num_members == piped.num_members
    assert torch.equal(sync.predict_raw(X), piped.predict_raw(X))


def test_boosting_abort_path_bit_identical(monkeypatch):
    """Pure-noise labels make SAMME abort (err >= 1 - 1/K) while the
    lookahead chunks are in flight; they are dropped, not appended."""
    rng = np.random.RandomState(7)
    X = rng.randn(600, 6).astype(np.float32)
    y = rng.randint(0, 5, size=600).astype(np.float32)

    def run(d):
        monkeypatch.setenv(execution.PIPELINE_ENV, str(d))
        return st.BoostingClassifier(
            num_base_learners=8, scan_chunk=4, algorithm="discrete",
            base_learner=_tree("DecisionTreeClassifier")).fit(X, y, device="cpu")

    sync, piped = run(0), run(1)
    assert sync.num_members == piped.num_members
    assert torch.equal(sync.predict_raw(X), piped.predict_raw(X))


def test_boosting_regressor_bit_identical(monkeypatch):
    X, y = _reg_data()

    def run(d):
        monkeypatch.setenv(execution.PIPELINE_ENV, str(d))
        return st.BoostingRegressor(num_base_learners=5, scan_chunk=2,
                                    base_learner=_tree()).fit(X, y, device="cpu")

    sync, piped = run(0), run(2)
    assert sync.num_members == piped.num_members
    assert torch.equal(sync.predict(X), piped.predict(X))


def test_device_patience_matches_host(monkeypatch):
    X, y = _clf_data()
    vi = _val_split(X.shape[0])

    def run(dp):
        monkeypatch.setenv(execution.PIPELINE_ENV, "1")
        monkeypatch.setenv(execution.DEVICE_PATIENCE_ENV, dp)
        return st.GBMClassifier(num_base_learners=12, scan_chunk=3, num_rounds=3,
                                base_learner=_tree()).fit(
            X, y, validation_indicator=vi, device="cpu")

    host, device = run("0"), run("1")
    assert host.num_members == device.num_members
    assert torch.equal(host.predict_proba(X), device.predict_proba(X))
    assert float((device.predict(X).numpy() == y).mean()) > 0.5


def test_device_patience_step_matches_the_host_recurrence():
    """The f32 recurrence stops where the host's does on a clean series."""
    errs = torch.tensor([1.0, 0.9, 0.899, 0.898, 0.5], dtype=torch.float32)
    best, v, stopped, kept = execution.device_patience_step(errs, 2.0, 0, 0.01, 2)
    assert (stopped, kept, v) == (True, 4, 2)
    assert best == pytest.approx(0.9)
