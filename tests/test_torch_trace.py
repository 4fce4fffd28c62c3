"""The port's causal tracing plane (``spark_ensemble_tpu_torch/telemetry/
trace.py``), case for case with the JAX package's trace tests where the
case exists in the port: span primitives and propagation, the round
executor's chunk fates and invalidation flows, rooted ``round_chunk``
spans of a fit, the ``checkpoint_save`` span on the writer thread, the
shard prefetcher's rebuilt worker spans, and ``tools/trace_viewer.py``'s
checks on a port stream (no orphan spans, no dangling flows), with spans
annotated for ``torch.profiler`` on request.

Everything here is exact: ids, parents, fates and flows are discrete.
"""

import importlib.util
import os
from collections import Counter

import numpy as np
import pytest

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.data import ShardPrefetcher, write_shards
from spark_ensemble_tpu_torch.execution import RoundAdapter, RoundExecutor
from spark_ensemble_tpu_torch.telemetry import (
    NULL_SPAN,
    NULL_TRACER,
    TraceContext,
    Tracer,
    record_fits,
    telemetry_sink_active,
)
from spark_ensemble_tpu_torch.telemetry.events import _DISABLED, FitTelemetry
from spark_ensemble_tpu_torch.telemetry.trace import (
    NULL_CONTEXT,
    new_flow_id,
    new_span_id,
    new_trace_id,
    trace_annotations_enabled,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


viewer = _load_tool("trace_viewer")


def _data(n=96, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _tree():
    return st.DecisionTreeRegressor(max_depth=3, max_bins=16)


def _spans(events, name=None):
    out = [e for e in events if e.get("event") == "span"]
    if name:
        out = [s for s in out if s["name"] == name]
    return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_ids_are_unique_and_pid_scoped():
    traces = {new_trace_id() for _ in range(50)}
    spans = {new_span_id() for _ in range(50)}
    flows = {new_flow_id() for _ in range(50)}
    assert len(traces) == 50 and len(spans) == 50 and len(flows) == 50
    pid = os.getpid()
    assert all(t.startswith(f"t{pid:x}.") for t in traces)
    assert all(s.startswith(f"s{pid:x}.") for s in spans)
    assert all(isinstance(f, int) and (f >> 24) == pid for f in flows)


def test_span_lifecycle_and_idempotent_end():
    sink = []
    tracer = Tracer(sink.append, thread="fit")
    with tracer.begin_span("fit", family="test") as root:
        root.add(rounds=3)
        with tracer.begin_span("round_chunk", parent=root, chunk_seq=0):
            pass
    root.end(ignored=True)
    assert [s["name"] for s in sink] == ["round_chunk", "fit"]
    chunk, fit = sink
    assert fit["trace_id"] == tracer.trace_id and fit["parent_id"] == ""
    assert fit["rounds"] == 3 and "ignored" not in fit
    assert chunk["parent_id"] == fit["span_id"] and chunk["thread"] == "fit"
    with pytest.raises(ValueError):
        with tracer.begin_span("serve"):
            raise ValueError("boom")
    assert sink[-1]["error"] == "ValueError"


def test_context_propagation_across_threads():
    import threading

    sink = []
    tracer = Tracer(sink.append)
    with tracer.begin_span("fit") as root:
        ctx = root.context()
        assert isinstance(ctx, TraceContext) and ctx

        def far_side():
            other = Tracer(sink.append, thread="ckpt-writer")
            with other.begin_span("checkpoint_save", parent=ctx, round=2):
                pass
            other.emit_span("shard_load", 12.0, 0.5, parent=ctx,
                            thread="se-tpu-shard", flow_out=[7], shard=0)

        t = threading.Thread(target=far_side)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    fit = _spans(sink, "fit")[0]
    for child in (_spans(sink, "checkpoint_save")[0], _spans(sink, "shard_load")[0]):
        assert child["trace_id"] == tracer.trace_id
        assert child["parent_id"] == fit["span_id"]
    assert _spans(sink, "shard_load")[0]["flow_out"] == [7]


def test_null_objects_and_the_disabled_path():
    assert not NULL_SPAN and not NULL_TRACER and not NULL_CONTEXT
    assert NULL_TRACER.begin_span("x", attr=1) is NULL_SPAN
    assert NULL_TRACER.emit_span("x", 0.0, 1.0) == ""
    with NULL_SPAN as sp:
        sp.add(a=1)
        assert sp.context() is NULL_CONTEXT
    assert _DISABLED.begin_span("round_chunk", chunk_seq=0) is NULL_SPAN
    assert _DISABLED.emit_span("shard_load", 0.0, 1.0) == ""
    assert _DISABLED.trace_context() is NULL_CONTEXT
    assert Tracer(lambda rec: None).begin_span("y")


def test_telemetry_sink_active(monkeypatch, tmp_path):
    monkeypatch.delenv("SE_TPU_TELEMETRY", raising=False)
    assert not telemetry_sink_active()
    assert telemetry_sink_active(str(tmp_path / "t.jsonl"))
    with record_fits():
        assert telemetry_sink_active()


def test_annotations_land_in_a_torch_profiler_capture(monkeypatch):
    """With ``SE_TPU_TRACE_ANNOTATIONS`` set, a span is a
    ``record_function`` scope, so it names a slice of a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.delenv("SE_TPU_TRACE_ANNOTATIONS", raising=False)
    assert not trace_annotations_enabled()
    monkeypatch.setenv("SE_TPU_TRACE_ANNOTATIONS", "1")
    assert trace_annotations_enabled()
    sink = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with Tracer(sink.append).begin_span("annotated_chunk"):
            pass
    assert len(sink) == 1
    assert "annotated_chunk" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# RoundExecutor chunk fates
# ---------------------------------------------------------------------------


class _ScriptedAdapter(RoundAdapter):
    """``total`` chunks; committing a chunk in ``invalidate_at`` kills the
    tail in flight; ``raise_at`` raises mid-commit."""

    def __init__(self, telem, total=5, depth=2, invalidate_at=(), raise_at=None):
        self.telem = telem
        self.depth = depth
        self.total = total
        self.invalidate_at = set(invalidate_at)
        self.raise_at = raise_at
        self.committed = 0
        self.frontier = 0
        self.finished = False

    def should_continue(self):
        return self.committed < self.total

    def can_launch(self):
        return self.frontier < self.total

    def launch(self):
        entry = self.frontier
        self.frontier += 1
        return entry

    def commit(self, entry, speculated):
        if self.raise_at is not None and entry == self.raise_at:
            raise RuntimeError("chaos mid-commit")
        self.committed = entry + 1
        return entry in self.invalidate_at

    def reset_frontier(self):
        self.frontier = self.committed

    def finish(self):
        self.finished = True


def test_executor_invalidation_fates_and_flow():
    sink = []
    adapter = _ScriptedAdapter(Tracer(sink.append, thread="fit"), total=5,
                               depth=2, invalidate_at=(0,))
    RoundExecutor(adapter).run()
    assert adapter.finished and adapter.committed == 5
    chunks = _spans(sink, "round_chunk")
    assert Counter(s["fate"] for s in chunks) == {"committed": 5, "invalidated": 2}
    killer = [s for s in chunks if s["fate"] == "committed" and s.get("flow_out")]
    assert len(killer) == 1
    (flow,) = killer[0]["flow_out"]
    invalidated = [s for s in chunks if s["fate"] == "invalidated"]
    assert all(s["flow_in"] == flow and s["speculative"] for s in invalidated)
    assert viewer.validate(chunks) == []


def test_executor_abandons_in_flight_spans_on_raise():
    sink = []
    adapter = _ScriptedAdapter(Tracer(sink.append), total=5, depth=2, raise_at=1)
    with pytest.raises(RuntimeError, match="chaos"):
        RoundExecutor(adapter).run()
    assert not adapter.finished
    fates = Counter(s["fate"] for s in _spans(sink, "round_chunk"))
    assert fates["committed"] == 1 and fates["aborted"] == 1
    assert fates["abandoned"] >= 1 and fates.get("invalidated", 0) == 0


def test_executor_without_telem_traces_nothing():
    adapter = _ScriptedAdapter(None, total=3, depth=1)
    RoundExecutor(adapter).run()
    assert adapter.finished and adapter.committed == 3


# ---------------------------------------------------------------------------
# fits: root span, chunk spans, checkpoint writer and prefetch worker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["gbm", "boosting"])
def test_fit_emits_rooted_round_chunk_spans(family):
    X, y = _data()
    est = (st.GBMRegressor(num_base_learners=4, scan_chunk=2, base_learner=_tree())
           if family == "gbm" else
           st.BoostingRegressor(num_base_learners=4, scan_chunk=2, base_learner=_tree()))
    with record_fits() as rec:
        est.fit(X, y, device="cpu")
    spans = _spans(rec.events)
    (root,) = _spans(spans, "fit")
    assert root["parent_id"] == ""
    chunks = _spans(spans, "round_chunk")
    assert len(chunks) >= 2
    for s in chunks:
        assert s["trace_id"] == root["trace_id"]
        assert s["parent_id"] == root["span_id"]
    assert {s["fate"] for s in chunks} <= {"committed", "invalidated"}
    assert viewer.validate(spans) == []


def test_checkpoint_save_span_on_writer_thread(tmp_path):
    X, y = _data()
    with record_fits() as rec:
        st.GBMRegressor(num_base_learners=4, scan_chunk=2, base_learner=_tree(),
                        checkpoint_dir=str(tmp_path / "ckpt"),
                        checkpoint_interval=2).fit(X, y, device="cpu")
    spans = _spans(rec.events)
    saves = _spans(spans, "checkpoint_save")
    assert saves
    root = _spans(spans, "fit")[0]
    for s in saves:
        assert s["trace_id"] == root["trace_id"]
        assert s["parent_id"] == root["span_id"]
        assert s["thread"] == "ckpt-writer" and s["round"] >= 0
    assert viewer.validate(spans) == []


def test_prefetcher_rebuilds_worker_spans_and_mirrors_metrics(tmp_path):
    X, _ = _data(n=157)
    store = write_shards(X, str(tmp_path / "store"), max_bins=16, shard_rows=64,
                         device="cpu")
    g = st.telemetry.global_metrics()
    loads0 = g.counter("data/shard_loads").value
    with record_fits() as rec:
        telem = FitTelemetry.start(family="test", n=store.n)
        with ShardPrefetcher(store, depth=1, telem=telem, to_device=False) as pf:
            for _ in pf.sweep():
                pass
        telem.finish()
    assert g.counter("data/shard_loads").value - loads0 == store.num_shards
    spans = _spans(rec.events)
    loads, waits = _spans(spans, "shard_load"), _spans(spans, "shard_wait")
    assert len(loads) == len(waits) == store.num_shards
    root = _spans(spans, "fit")[0]
    for s in loads:
        assert s["thread"] == "se-tpu-shard" and s["parent_id"] == root["span_id"]
        assert s["bytes"] > 0
    sources = {fid for s in loads for fid in (s.get("flow_out") or [])}
    for s in waits:
        if s["hit"]:
            assert s.get("flow_in") is None
        else:
            assert s["flow_in"] in sources
    assert viewer.validate(spans) == []


def test_trace_viewer_exports_a_port_stream(tmp_path):
    """A streaming fit's whole stream (fit, chunk, shard and checkpoint
    spans) validates and exports as a Perfetto trace."""
    X, y = _data(n=157)
    store = write_shards(X, str(tmp_path / "store"), max_bins=16, shard_rows=64,
                         device="cpu")
    path = str(tmp_path / "t.jsonl")
    st.GBMRegressor(num_base_learners=3, base_learner=_tree(), scan_chunk=2,
                    checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_interval=2,
                    telemetry_path=path).fit_streaming(store, y, device="cpu")
    events = viewer.load_events(path)
    spans = viewer.select_spans(events)
    names = {s["name"] for s in spans}
    assert {"fit", "round_chunk", "shard_load", "shard_wait", "checkpoint_save"} <= names
    assert viewer.validate(spans) == []
    trace = viewer.to_trace_events(spans)
    assert trace
