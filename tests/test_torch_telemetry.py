"""The port's telemetry core (``spark_ensemble_tpu_torch/telemetry``) against
the JAX package's: metric primitives, the per-fit event stream of every
family, its sinks, ``fit_history_``, and the stream's schema.

The same numpy data go through both packages at a tiny size (n <= 700,
depth <= 3, <= 5 rounds).  Tolerances: the registry's arithmetic is the
same Python on both sides, so histogram quantiles are EQUAL; ``fit_end``'s
phases sum to ``wall_s`` within 1e-9 s by construction (a ``host_other``
remainder); the GBM history's validation losses and step sizes are f32
values each package sums in its own order, held at rtol 1e-5; a fit with
telemetry on must give the model of the fit with it off, bit for bit.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.telemetry import record_fits as jax_record_fits
from spark_ensemble_tpu.telemetry.registry import (
    StreamingHistogram as JaxStreamingHistogram,
)
from spark_ensemble_tpu_torch.telemetry import (
    TELEMETRY_ENV,
    FitTelemetry,
    MetricsRegistry,
    StreamingHistogram,
    record_fits,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(n=200, d=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _cls_data(n=240, d=4, k=3, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T, axis=1)
    return X, y.astype(np.float32)


def _tree(pkg, cls="DecisionTreeRegressor", hist="scatter"):
    return getattr(pkg, cls)(max_depth=3, max_bins=16, hist=hist)


# ---------------------------------------------------------------------------
# registry primitives
# ---------------------------------------------------------------------------


def test_counter_gauge_and_sources():
    reg = MetricsRegistry()
    c = reg.counter("fits")
    c.inc()
    c.inc(4)
    assert c.value == 5 and reg.counter("fits") is c
    g = reg.gauge("bytes")
    assert g.value is None
    g.set(7.0)
    g.set(3.0)
    assert g.value == 3.0
    reg.register_source("live", lambda: {"x": 1})
    reg.register_source("broken", lambda: 1 / 0)
    snap = reg.snapshot()
    assert snap["fits"] == {"type": "counter", "value": 5}
    assert snap["bytes"] == {"type": "gauge", "value": 3.0}
    assert snap["live"] == {"type": "source", "value": {"x": 1}}
    assert snap["broken"]["error"].startswith("ZeroDivisionError")
    reg.unregister_source("live")
    assert "live" not in reg.snapshot()
    assert reg.names() == ["bytes", "fits"]
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("fits")


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 1e6)])
def test_streaming_histogram_quantiles_equal_the_jax_package(seed, scale):
    """The same log2 buckets: every summary field and quantile equal."""
    values = np.random.RandomState(seed).lognormal(size=500) * scale
    values[:3] = (-1.0, 0.0, 2.0 ** 41)  # the clamped edge buckets
    ours, theirs = StreamingHistogram("t"), JaxStreamingHistogram("t")
    for v in values:
        ours.record(v)
        theirs.record(v)
    assert ours.summary() == theirs.summary()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)


def test_round_timer_fences_and_shares_its_histogram():
    reg = MetricsRegistry()
    t = reg.timer("round")
    x = torch.ones((32, 32))
    t.start()
    out = x @ x
    assert t.stop(out) > 0.0
    out2 = t.time(lambda a: a @ a, x)
    assert torch.equal(out, out2) and reg.histogram("round").count == 2
    with pytest.raises(RuntimeError, match="before start"):
        t.stop()
    assert reg.timer("round") is not reg.timer("round")


# ---------------------------------------------------------------------------
# sinks and the JSONL stream
# ---------------------------------------------------------------------------


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_jsonl_round_trip_and_phase_sum(tmp_path):
    path = str(tmp_path / "fit.jsonl")
    X, y = _data()
    model = st.GBMRegressor(num_base_learners=4, base_learner=_tree(st),
                            telemetry_path=path, scan_chunk=2).fit(X, y, device="cpu")
    events = _read(path)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "fit_start" and kinds[-1] == "fit_end"
    fit_end = events[-1]
    assert fit_end["family"] == "GBMRegressor"
    assert abs(sum(fit_end["phases"].values()) - fit_end["wall_s"]) <= 1e-9
    ends = [e for e in events if e["event"] == "round_end"]
    assert [e["round"] for e in ends] == [0, 1, 2, 3] == list(model.fit_history_["round"])
    assert all(e["duration_s"] > 0 for e in ends)
    assert fit_end["compile_count"] == 0 and "memory" not in fit_end  # a CPU fit
    np.testing.assert_array_equal(model.fit_history_["duration_s"],
                                  [e["duration_s"] for e in ends])


def test_env_var_sink(tmp_path, monkeypatch):
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv(TELEMETRY_ENV, path)
    X, y = _data()
    st.BaggingRegressor(num_base_learners=3, base_learner=_tree(st)).fit(X, y, device="cpu")
    events = _read(path)
    assert events[0]["event"] == "fit_start" and events[-1]["event"] == "fit_end"
    assert events[0]["family"] == "BaggingRegressor"


def test_record_fits_groups_nested_fits():
    X, y = _data()
    with record_fits() as rec:
        st.GBMRegressor(num_base_learners=2, base_learner=_tree(st)).fit(X, y, device="cpu")
        st.BoostingRegressor(num_base_learners=2, base_learner=_tree(st)).fit(X, y, device="cpu")
    fits = rec.fits()
    assert sorted(f.split(":")[0] for f in fits) == ["BoostingRegressor", "GBMRegressor"]
    for evs in fits.values():
        assert evs[0]["event"] == "fit_start" and evs[-1]["event"] == "fit_end"


def _families():
    Xr, yr = _data()
    Xc, yc = _cls_data()
    return {
        "gbm_c": (lambda: st.GBMClassifier(num_base_learners=3, base_learner=_tree(st)), Xc, yc),
        "gbm_r": (lambda: st.GBMRegressor(num_base_learners=3, base_learner=_tree(st)), Xr, yr),
        "boost_c": (lambda: st.BoostingClassifier(
            num_base_learners=3, base_learner=_tree(st, "DecisionTreeClassifier"),
            algorithm="real"), Xc, yc),
        "boost_r": (lambda: st.BoostingRegressor(num_base_learners=3,
                                                 base_learner=_tree(st)), Xr, yr),
        "bag_c": (lambda: st.BaggingClassifier(
            num_base_learners=3, base_learner=_tree(st, "DecisionTreeClassifier")), Xc, yc),
        "bag_r": (lambda: st.BaggingRegressor(num_base_learners=3,
                                              base_learner=_tree(st)), Xr, yr),
        "stack_c": (lambda: st.StackingClassifier(
            base_learners=[_tree(st, "DecisionTreeClassifier"), st.GaussianNaiveBayes()]),
            Xc, yc),
        "stack_r": (lambda: st.StackingRegressor(
            base_learners=[_tree(st), st.LinearRegression()]), Xr, yr),
    }


@pytest.mark.parametrize("family", sorted(_families()))
def test_fit_history_present_and_monotone(family):
    make, X, y = _families()[family]
    with record_fits():
        model = make().fit(X, y, device="cpu")
    h = model.fit_history_
    assert sorted(h) == ["duration_s", "learner_index", "loss", "round", "step_size"]
    n = len(h["round"])
    assert n >= 1 and all(len(v) == n for v in h.values())
    assert np.all(np.diff(h["round"]) > 0) and np.all(h["duration_s"] >= 0)
    # without a sink the attribute is there, empty
    quiet = make().fit(X, y, device="cpu").fit_history_
    assert sorted(quiet) == sorted(h) and all(len(v) == 0 for v in quiet.values())


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_gbm_history_matches_the_jax_package(kind):
    """Validation losses (the GBM history's ``loss``) and step sizes of the
    same tie-free fit, within rtol 1e-5."""
    if kind == "regressor":
        X, y = _data(n=512, seed=3)
        y = np.round(y * 16) / 16  # dyadic targets
        kw = dict(num_base_learners=4, learning_rate=0.5, num_rounds=10)
        jcls, tcls = se.GBMRegressor, st.GBMRegressor
    else:
        X, y = _cls_data(n=700, d=8, k=4, seed=7)  # no near-tie split
        kw = dict(num_base_learners=3, learning_rate=0.3, num_rounds=10,
                  updates="newton", optimized_weights=True)
        jcls, tcls = se.GBMClassifier, st.GBMClassifier
    vi = np.zeros(len(y), bool)
    vi[::4] = True
    with jax_record_fits():
        jm = jcls(base_learner=_tree(se), **kw).fit(X, y, validation_indicator=vi)
    with record_fits():
        tm = tcls(base_learner=_tree(st), **kw).fit(X, y, validation_indicator=vi,
                                                     device="cpu")
    jh, th = jm.fit_history_, tm.fit_history_
    np.testing.assert_array_equal(th["round"], jh["round"])
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(th["step_size"], jh["step_size"], rtol=1e-5)


def _key_sets(events):
    """{event type (spans by name): the union of its key sets}."""
    out = {}
    for e in events:
        tag = e["event"] if e["event"] != "span" else f"span:{e['name']}"
        out.setdefault(tag, set()).update(e)
    return out


@pytest.mark.parametrize("kind", ["gbm_c", "bag_r", "boost_c", "stack_r"])
def test_event_key_sets_equal_the_jax_package(kind):
    """For the same fit, each event type carries the JAX package's keys."""
    Xr, yr = _data()
    Xc, yc = _cls_data()

    def make(pkg):
        if kind == "gbm_c":
            return pkg.GBMClassifier(num_base_learners=3, base_learner=_tree(pkg)), Xc, yc
        if kind == "bag_r":
            return pkg.BaggingRegressor(num_base_learners=3, base_learner=_tree(pkg)), Xr, yr
        if kind == "boost_c":
            return pkg.BoostingClassifier(
                num_base_learners=3,
                base_learner=_tree(pkg, "DecisionTreeClassifier")), Xc, yc
        return pkg.StackingRegressor(
            base_learners=[_tree(pkg), pkg.LinearRegression()]), Xr, yr

    est, X, y = make(se)
    with jax_record_fits() as jrec:
        est.fit(X, y)
    est, X, y = make(st)
    with record_fits() as trec:
        est.fit(X, y, device="cpu")
    assert _key_sets(trec.events) == _key_sets(jrec.events)


def test_disabled_fit_emits_nothing_and_telemetry_changes_no_bit(tmp_path):
    X, y = _cls_data()
    est = st.GBMClassifier(num_base_learners=3, base_learner=_tree(st), scan_chunk=2)
    FitTelemetry.start(est)  # no sink: the shared disabled singleton
    assert not FitTelemetry.start(est).enabled
    quiet = est.fit(X, y, device="cpu")
    assert not os.listdir(tmp_path)
    path = str(tmp_path / "t.jsonl")
    loud = est.copy(telemetry_path=path).fit(X, y, device="cpu")
    assert len(_read(path)) > 0
    for a, b in zip(st.models.base.tree_leaves(quiet.params),
                    st.models.base.tree_leaves(loud.params)):
        assert torch.equal(a, b)
    assert torch.equal(quiet.predict_proba(X), loud.predict_proba(X))


def test_telemetry_report_renders_a_port_stream(tmp_path, capsys):
    path = str(tmp_path / "t.jsonl")
    X, y = _cls_data()
    st.GBMClassifier(num_base_learners=3, base_learner=_tree(st, hist="fused"),
                     telemetry_path=path).fit(X, y, device="cpu")
    report = _load_tool("telemetry_report")
    assert report.main([path]) == 0
    out = capsys.readouterr().out
    assert "GBMClassifier" in out and "fused" in out


def test_profile_dir_capture_and_its_summary(tmp_path, capsys):
    """``profile_dir`` writes a torch.profiler Chrome trace that
    ``utils/profiling.py`` summarizes into the JAX package's
    ``{"op", "total_us", "count", "share"}`` records (a CPU capture has no
    device slices: its host rows are read with ``device_only=False``)."""
    import gzip
    import shutil

    from spark_ensemble_tpu_torch.utils import profiling

    prof = str(tmp_path / "prof")
    X, y = _data()
    st.GBMRegressor(num_base_learners=2, base_learner=_tree(st),
                    profile_dir=prof).fit(X, y, device="cpu")
    (trace,) = profiling.find_trace_files(prof)
    assert trace.endswith(".pt.trace.json")
    assert profiling.summarize_trace(prof)[0] == []  # no device slices on the CPU
    rows, total = profiling.summarize_trace(prof, device_only=False)
    assert rows and total > 0 and rows == sorted(rows, key=lambda r: -r[1])
    records = profiling.rows_to_records(rows, total)
    assert sorted(records[0]) == ["count", "op", "share", "total_us"]
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    assert len(profiling.find_trace_files(prof, latest_only=False)) == 2
    assert profiling.load_trace_events(trace + ".gz") == profiling.load_trace_events(trace)
    out = str(tmp_path / "rows.jsonl")
    assert profiling.main([prof, "--all-events", "--jsonl", out]) == 0
    assert "total_ms" in capsys.readouterr().out
    with open(out) as f:
        assert len([json.loads(line) for line in f]) == min(len(rows), 25)
