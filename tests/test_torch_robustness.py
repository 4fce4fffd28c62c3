"""The fault-tolerant training runtime of the PyTorch port
(``robustness/``), case for case with tests/test_robustness.py where the
case exists in the port: input validation, the numeric-guard policies on
all four families, retry with backoff, crash-consistent checkpoint
fallback, kill-and-resume (bit-identical, ``torch.equal``), the chaos
harness's determinism, and recovery under the pipeline.  The last cases
hold the port to the JAX package: the same chaos seed and fault give the
same guard record (round index and action) and the same fit within the
stated tolerance."""

import json
import os

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.robustness import chaos as jchaos
from spark_ensemble_tpu.telemetry import record_fits
from spark_ensemble_tpu_torch.robustness import chaos, retry
from spark_ensemble_tpu_torch.robustness.chaos import (
    ChaosController,
    ChaosPreemption,
    ChaosTransientError,
)
from spark_ensemble_tpu_torch.robustness.guards import (
    NONFINITE_POLICIES,
    NonFiniteError,
    NumericGuard,
)
from spark_ensemble_tpu_torch.robustness.retry import RetryPolicy, retry_call
from spark_ensemble_tpu_torch.robustness.validate import validate_fit_inputs
from spark_ensemble_tpu_torch.utils.checkpoint import TrainingCheckpointer


def _data(n=120, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _cls_data(n=120, d=5, seed=0):
    X, y = _data(n, d, seed)
    return X, (y > np.median(y)).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_leaked_chaos():
    yield
    chaos.install(None)
    jchaos.install(None)


def _chaos(**kw):
    kw.setdefault("rate", 1.0)
    ctl = ChaosController(seed=kw.pop("seed", 11), **kw)
    chaos.install(ctl)
    return ctl


# ---------------------------------------------------------------------------
# input validation
# ---------------------------------------------------------------------------


def test_validate_raises_on_nan_features():
    X, y = _data()
    X[3, 1] = np.nan
    with pytest.raises(ValueError, match="X contains NaN or Inf"):
        st.GBMRegressor(num_base_learners=2).fit(X, y, device="cpu")


def test_validate_raises_on_inf_labels():
    X, y = _data()
    y[7] = np.inf
    with pytest.raises(ValueError, match="y contains NaN or Inf"):
        st.BaggingRegressor(num_base_learners=2).fit(X, y, device="cpu")


def test_validate_allow_nan_escape_hatch():
    X, y = _data()
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    validate_fit_inputs(Xt, yt)
    Xt[0, 0] = float("nan")
    with pytest.raises(ValueError):
        validate_fit_inputs(Xt, yt)
    validate_fit_inputs(Xt, yt, allow_nan=True)


@pytest.mark.parametrize(
    "est_cls", [st.BoostingClassifier, st.BaggingClassifier, st.StackingClassifier])
def test_validate_wired_into_classifier_fits(est_cls):
    X, y = _cls_data()
    X[1, 1] = np.inf
    with pytest.raises(ValueError, match="contains NaN or Inf"):
        est_cls().fit(X, y, device="cpu")


# ---------------------------------------------------------------------------
# guard primitives
# ---------------------------------------------------------------------------


def test_guard_rejects_unknown_policy():
    with pytest.raises(ValueError, match="on_nonfinite"):
        NumericGuard("explode")
    for p in NONFINITE_POLICIES:
        NumericGuard(p)


def test_guard_params_are_nan_only_arrays_are_strict():
    g = NumericGuard("raise")
    inf = float("inf")
    params = {"thr": torch.tensor([[inf, 1.0], [2.0, -inf]])}
    weights = torch.tensor([0.5, 0.25])
    assert g.first_nonfinite(params, weights) is None
    params_bad = {"thr": torch.tensor([[1.0, 2.0], [float("nan"), 3.0]])}
    assert g.first_nonfinite(params_bad, weights) == 1
    assert g.first_nonfinite(params, torch.tensor([0.5, inf])) == 1
    assert g.first_nonfinite(params, torch.tensor([float("nan"), 1.0])) == 0


def test_estimator_rejects_bad_policy_param():
    with pytest.raises(ValueError):
        st.GBMRegressor(on_nonfinite="explode")


# ---------------------------------------------------------------------------
# retry/backoff
# ---------------------------------------------------------------------------


def test_retry_transient_then_success_and_delays():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    policy = RetryPolicy(max_retries=3, base_delay=0.05, jitter=0.0)
    assert retry_call(flaky, policy=policy, op="t", sleep=slept.append) == "ok"
    assert len(calls) == 3
    assert slept == pytest.approx([0.05, 0.10])


def test_retry_exhaustion_reraises():
    def always():
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):
        retry_call(always, policy=RetryPolicy(max_retries=2, base_delay=0.0),
                   op="t", sleep=lambda s: None)


def test_retry_zero_retries_and_non_retryable():
    def boom():
        raise RuntimeError("x")

    with pytest.raises(RuntimeError):
        retry_call(boom, policy=RetryPolicy(max_retries=0), op="t")

    def preempted():
        raise ChaosPreemption("gone")

    with pytest.raises(ChaosPreemption):
        retry_call(preempted, policy=RetryPolicy(max_retries=5), op="t",
                   sleep=lambda s: None)
    assert not issubclass(ChaosPreemption, RuntimeError)
    assert issubclass(ChaosTransientError, RuntimeError)


def test_retry_is_counted_with_its_error_text():
    """A chaos transient in a fit is retried and counted, with the error
    text in the record (the port's stand-in for the telemetry event)."""
    X, y = _data()
    retry.reset_retry_log()
    _chaos(seed=7, faults=("transient",))
    st.GBMRegressor(num_base_learners=2, scan_chunk=2).fit(X, y, device="cpu")
    log = retry.retry_log()
    assert retry.retry_count() == len(log) >= 1
    op, kind, text = log[0]
    assert op == "GBMRegressor.round_chunk"
    assert kind == "ChaosTransientError" and "chaos: transient" in text


# ---------------------------------------------------------------------------
# chaos harness
# ---------------------------------------------------------------------------


def test_chaos_is_deterministic_and_at_most_once_per_site():
    a = ChaosController(seed=5, rate=0.5, faults=("transient",))
    b = ChaosController(seed=5, rate=0.5, faults=("transient",))
    sites = [f"site:{i}" for i in range(40)]
    for ctl in (a, b):
        for s in sites:
            try:
                ctl.transient(s)
            except ChaosTransientError:
                pass
            ctl.transient(s)  # a second visit never fires
    assert a.fired == b.fired
    assert 0 < len(a.fired) < len(sites)
    # the same draws as the JAX package's controller
    j = jchaos.ChaosController(seed=5, rate=0.5, faults=("transient",))
    for s in sites:
        try:
            j.transient(s)
        except jchaos.ChaosTransientError:
            pass
    assert j.fired == a.fired


def test_chaos_env_parsing(monkeypatch):
    monkeypatch.setenv("SE_TPU_CHAOS", "42")
    monkeypatch.setenv("SE_TPU_CHAOS_FAULTS", "transient,ckpt_corrupt")
    monkeypatch.setenv("SE_TPU_CHAOS_RATE", "0.25")
    chaos._env_cache = None
    try:
        ctl = chaos.controller()
        assert ctl.enabled
        assert ctl.seed == 42 and ctl.rate == 0.25
        assert ctl.faults == {"transient", "ckpt_corrupt"}
    finally:
        chaos._env_cache = None


def test_chaos_disabled_by_default(monkeypatch):
    monkeypatch.delenv("SE_TPU_CHAOS", raising=False)
    chaos._env_cache = None
    assert not chaos.controller().enabled


def test_chaos_log_jsonl(tmp_path):
    log = tmp_path / "faults.jsonl"
    ctl = ChaosController(seed=1, rate=1.0, faults=("transient",), log_path=str(log))
    with pytest.raises(ChaosTransientError):
        ctl.transient("s1")
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert recs and recs[0]["fault"] == "transient" and recs[0]["site"] == "s1"


def test_chaos_poisons_the_leaf_the_jax_package_poisons():
    """``poison_member_stack`` picks the first floating leaf in
    ``jax.tree_util`` order (dict keys sorted) and the same member."""
    ctl = ChaosController(seed=3, rate=1.0, faults=("nan_grad",))
    tree = {"b": torch.zeros(4, 2), "a": torch.zeros(4, 3), "i": torch.zeros(4, dtype=torch.int32)}
    out = ctl.poison_member_stack("s", tree)
    j = jchaos.ChaosController(seed=3, rate=1.0, faults=("nan_grad",)).pick("nan_grad", "s", 4)
    assert torch.isnan(out["a"][j]).all() and not torch.isnan(out["b"]).any()
    assert int(torch.isnan(out["a"]).any(dim=1).sum()) == 1


# ---------------------------------------------------------------------------
# checkpoint crash consistency
# ---------------------------------------------------------------------------


def _two_saves(tmp_path):
    ck = TrainingCheckpointer(str(tmp_path / "ck"), interval=1, async_save=False)
    ck.save(0, {"round_tag": 0, "v": [1.0, 2.0]})
    ck.save(1, {"round_tag": 1, "v": [3.0, 4.0]})
    return ck


def test_truncated_state_json_falls_back_to_old(tmp_path):
    ck = _two_saves(tmp_path)
    latest = os.path.join(ck.directory, "latest", "state.json")
    with open(latest, "r+b") as f:
        f.truncate(os.path.getsize(latest) // 2)
    rnd, got = ck.load_latest()
    assert rnd == 0 and got["round_tag"] == 0
    assert ck.last_load_detail == {"round": 0, "source": ".ckpt-old", "fallback": True}


def test_manifest_tamper_falls_back(tmp_path):
    ck = _two_saves(tmp_path)
    latest = os.path.join(ck.directory, "latest", "state.json")
    data = bytearray(open(latest, "rb").read())
    data[-2] ^= 0xFF
    with open(latest, "wb") as f:
        f.write(data)
    rnd, _ = ck.load_latest()
    assert rnd == 0 and ck.last_load_detail["fallback"] is True


def test_both_copies_corrupt_means_fresh_start(tmp_path):
    ck = _two_saves(tmp_path)
    for src in ("latest", ".ckpt-old"):
        with open(os.path.join(ck.directory, src, "state.json"), "w") as f:
            f.write("{not json")
    assert ck.load_latest() is None


def test_clean_load_reports_latest(tmp_path):
    ck = _two_saves(tmp_path)
    rnd, got = ck.load_latest()
    assert rnd == 1 and got["round_tag"] == 1
    assert ck.last_load_detail == {"round": 1, "source": "latest", "fallback": False}


def test_chaos_ckpt_corrupt_self_heals(tmp_path):
    """A chaos-torn 'latest' costs one interval, not the run."""
    ck = TrainingCheckpointer(str(tmp_path / "ck"), interval=1, async_save=False)
    ck.save(0, {"r": 0})
    ctl = _chaos(seed=5, faults=("ckpt_corrupt",))
    ck.save(1, {"r": 1})
    chaos.install(None)
    assert ctl.fired
    rnd, got = ck.load_latest()
    assert rnd == 0 and got["r"] == 0
    assert ck.last_load_detail["fallback"] is True


# ---------------------------------------------------------------------------
# guard policies end to end (chaos nan_grad on every family)
# ---------------------------------------------------------------------------


def test_gbm_clean_fit_identical_with_guard_on_and_off():
    X, y = _data()
    on = st.GBMRegressor(num_base_learners=4, scan_chunk=2).fit(X, y, device="cpu")
    off = st.GBMRegressor(num_base_learners=4, scan_chunk=2,
                          on_nonfinite="off").fit(X, y, device="cpu")
    assert torch.equal(on.predict(X), off.predict(X))


@pytest.mark.parametrize("policy", ["skip_round", "halve_step", "stop_early"])
def test_gbm_recovers_from_nan_round(policy):
    X, y = _data()
    ctl = _chaos(faults=("nan_grad",), budgets={"nan_grad": 1})
    m = st.GBMRegressor(num_base_learners=5, scan_chunk=2,
                        on_nonfinite=policy).fit(X, y, device="cpu")
    assert ctl.fired
    assert torch.isfinite(m.predict(X)).all()
    assert [e["action"] for e in m.guard_events_] == [policy]
    if policy == "stop_early":
        assert m.num_members < 5


def test_gbm_default_policy_raises_with_round_attribution():
    X, y = _data()
    _chaos(faults=("nan_grad",), budgets={"nan_grad": 1})
    with pytest.raises(NonFiniteError) as ei:
        st.GBMClassifier(num_base_learners=4, scan_chunk=2).fit(
            X, (y > 0).astype(np.float32), device="cpu")
    assert ei.value.round_index is not None
    assert ei.value.family == "GBMClassifier"


def test_boosting_true_drops_poisoned_member():
    X, y = _cls_data()
    ctl = _chaos(faults=("nan_grad",), budgets={"nan_grad": 1})
    m = st.BoostingClassifier(num_base_learners=4, scan_chunk=2, algorithm="real",
                              on_nonfinite="skip_round").fit(X, y, device="cpu")
    assert ctl.fired
    assert torch.isfinite(m.predict_proba(X)).all()
    assert m.guard_events_[0]["member_dropped"] is True


def test_bagging_drops_bad_members_and_scales_probabilities():
    X, y = _cls_data()
    _chaos(seed=21, faults=("nan_grad",), budgets={"nan_grad": 1})
    m = st.BaggingClassifier(num_base_learners=5, voting_strategy="soft",
                             on_nonfinite="skip_round").fit(X, y, device="cpu")
    assert m.num_members == 4
    proba = m.predict_proba(X)
    assert torch.isfinite(proba).all()
    # probabilities divide by the fitted member count, not the param
    np.testing.assert_allclose(proba.sum(dim=-1).numpy(), 1.0, atol=1e-5)


def test_stacking_drops_bad_member_keeps_consistent_layout():
    X, y = _data()
    _chaos(seed=31, faults=("nan_grad",), budgets={"nan_grad": 1})
    m = st.StackingRegressor(on_nonfinite="skip_round").fit(X, y, device="cpu")
    assert len(m.base_models) == 1
    assert m.stack_model.num_features == 1
    assert torch.isfinite(m.predict(X)).all()


def test_stacking_raise_is_default():
    X, y = _data()
    _chaos(seed=31, faults=("nan_grad",), budgets={"nan_grad": 1})
    with pytest.raises(NonFiniteError):
        st.StackingRegressor().fit(X, y, device="cpu")


# ---------------------------------------------------------------------------
# kill-and-resume equivalence
# ---------------------------------------------------------------------------


KILLABLE = {
    "gbm": lambda ckdir: st.GBMRegressor(
        num_base_learners=6, scan_chunk=2, checkpoint_dir=ckdir, checkpoint_interval=1),
    "gbm_cls": lambda ckdir: st.GBMClassifier(
        num_base_learners=6, scan_chunk=2, checkpoint_dir=ckdir, checkpoint_interval=1),
    "boosting": lambda ckdir: st.BoostingRegressor(
        num_base_learners=6, scan_chunk=2, checkpoint_dir=ckdir, checkpoint_interval=1),
}


def _kill_and_resume(tmp_path, make_est, y):
    X, _ = _data()
    ref = make_est(None).fit(X, y, device="cpu")
    est = make_est(str(tmp_path / "ck"))
    _chaos(seed=3, faults=("preempt",), budgets={"preempt": 1})
    with pytest.raises(ChaosPreemption):
        est.fit(X, y, device="cpu")
    chaos.install(None)
    assert os.path.exists(os.path.join(est.checkpoint_dir, "latest"))
    m = est.fit(X, y, device="cpu")  # resumes from the checkpoint
    assert m.num_members == ref.num_members
    for a, b in zip(st.models.base.tree_leaves(m.params),
                    st.models.base.tree_leaves(ref.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", sorted(KILLABLE))
def test_kill_and_resume_matches_uninterrupted(tmp_path, family):
    X, y = _data()
    if family == "gbm_cls":
        y = (y > np.median(y)).astype(np.float32)
    _kill_and_resume(tmp_path, KILLABLE[family], y)


# ---------------------------------------------------------------------------
# the pipeline under chaos: speculation does not change a recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["skip_round", "halve_step", "stop_early"])
def test_gbm_guard_recovery_identical_across_pipeline(monkeypatch, policy):
    X, y = _data()
    results = {}
    for depth in ("0", "1", "2"):
        monkeypatch.setenv("SE_TPU_PIPELINE", depth)
        ctl = _chaos(faults=("nan_grad",), budgets={"nan_grad": 1})
        m = st.GBMRegressor(num_base_learners=5, scan_chunk=2,
                            on_nonfinite=policy).fit(X, y, device="cpu")
        assert ctl.fired
        chaos.install(None)
        results[depth] = (m.num_members, m.predict(X), m.guard_events_)
    for depth in ("1", "2"):
        assert results[depth][0] == results["0"][0]
        assert torch.equal(results[depth][1], results["0"][1])
        assert results[depth][2] == results["0"][2]


def test_boosting_guard_recovery_identical_across_pipeline(monkeypatch):
    X, y = _cls_data()
    results = {}
    for depth in ("0", "1"):
        monkeypatch.setenv("SE_TPU_PIPELINE", depth)
        ctl = _chaos(faults=("nan_grad",), budgets={"nan_grad": 1})
        m = st.BoostingClassifier(num_base_learners=4, scan_chunk=2, algorithm="real",
                                  on_nonfinite="skip_round").fit(X, y, device="cpu")
        assert ctl.fired
        chaos.install(None)
        results[depth] = (m.num_members, m.predict_proba(X))
    assert results["0"][0] == results["1"][0]
    assert torch.equal(results["0"][1], results["1"][1])


@pytest.mark.parametrize("family", ["gbm", "boosting"])
def test_pipelined_kill_and_resume_matches_sync(tmp_path, monkeypatch, family):
    """The checkpoint written while speculative chunks were in flight holds
    only committed state: the pipelined resume equals the synchronous
    uninterrupted fit."""
    X, y = _data()
    monkeypatch.setenv("SE_TPU_PIPELINE", "0")
    ref = KILLABLE[family](None).fit(X, y, device="cpu")
    monkeypatch.setenv("SE_TPU_PIPELINE", "1")
    est = KILLABLE[family](str(tmp_path / "ck"))
    _chaos(seed=3, faults=("preempt",), budgets={"preempt": 1})
    with pytest.raises(ChaosPreemption):
        est.fit(X, y, device="cpu")
    chaos.install(None)
    assert torch.equal(est.fit(X, y, device="cpu").predict(X), ref.predict(X))


def _fused_gbm(ckdir=None):
    kw = dict(checkpoint_dir=ckdir, checkpoint_interval=1) if ckdir else {}
    return st.GBMRegressor(num_base_learners=6, scan_chunk=2,
                           base_learner=st.DecisionTreeRegressor(hist="fused", max_bins=16),
                           **kw)


def test_fused_gbm_recovers_from_nan_round():
    X, y = _data()
    ctl = _chaos(faults=("nan_grad",), budgets={"nan_grad": 1})
    m = _fused_gbm().copy(on_nonfinite="skip_round").fit(X, y, device="cpu")
    assert ctl.fired
    assert torch.isfinite(m.predict(X)).all()


def test_fused_kill_and_resume_matches_uninterrupted(tmp_path):
    X, y = _data()
    ref = _fused_gbm().fit(X, y, device="cpu")
    est = _fused_gbm(str(tmp_path / "ck"))
    _chaos(seed=3, faults=("preempt",), budgets={"preempt": 1})
    with pytest.raises(ChaosPreemption):
        est.fit(X, y, device="cpu")
    chaos.install(None)
    assert torch.equal(est.fit(X, y, device="cpu").predict(X), ref.predict(X))


# ---------------------------------------------------------------------------
# against the JAX package: same seed and fault, same record, same fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["skip_round", "halve_step", "stop_early"])
@pytest.mark.parametrize("family", ["GBMRegressor", "BoostingClassifier"])
def test_chaos_recovery_matches_the_jax_package(family, policy):
    """The same chaos seed poisons the same round in both packages, the
    guard records the same (round, action), the fits keep the same member
    count, and predictions agree within 1e-5 of the label scale
    (regressor) or 1e-5 (SAMME.R probabilities)."""
    X, y = _data()
    kw = dict(num_base_learners=5, scan_chunk=2, on_nonfinite=policy)
    if family == "BoostingClassifier":
        y, kw["algorithm"] = (y > np.median(y)).astype(np.float32), "real"
    make = dict(seed=11, rate=1.0, faults=("nan_grad",), budgets={"nan_grad": 1})
    jchaos.install(jchaos.ChaosController(**make))
    with record_fits() as rec:
        jm = getattr(se, family)(**kw).fit(X, y)
    jchaos.install(None)
    want = [(e["round"], e["action"]) for e in rec.events
            if e["event"] == "guard_nonfinite"]
    chaos.install(ChaosController(**make))
    tm = getattr(st, family)(**kw).fit(X, y, device="cpu")
    chaos.install(None)
    assert [(e["round"], e["action"]) for e in tm.guard_events_] == want
    assert tm.num_members == jm.num_members
    if family == "GBMRegressor":
        np.testing.assert_allclose(tm.predict(X).numpy(), np.asarray(jm.predict(X)),
                                   atol=1e-5 * np.abs(y).max())
    else:
        np.testing.assert_allclose(tm.predict_proba(X).numpy(),
                                   np.asarray(jm.predict_proba(X)), atol=1e-5)
