"""Structured per-fit event stream: round timings, phases, kernel builds,
memory (PyTorch port of ``telemetry/events.py``, with the same events, keys
and JSONL schema).

Every ``fit`` can emit a stream of structured events — ``fit_start``,
``round_start``/``round_end`` pairs (loss, step size, learner index,
duration), an optional ``phase_probe`` (fine-grained per-phase device
costs), and a closing ``fit_end`` (per-phase wall breakdown, compile
count/seconds, device memory stats).  Three sinks, checked in order:

1. ``telemetry_path`` estimator param — JSONL appended at fit end,
2. ``SE_TPU_TELEMETRY`` environment variable — same, path from the env,
3. an active ``record_fits()`` context — events kept in memory.

When none is active the per-fit handle is a shared no-op singleton: no
events are allocated and no fence is taken, so a fit launches exactly the
kernels it launches without telemetry, and its model is bit-identical.

Timing honesty under asynchronous launches: round durations come from
fencing the round chunk's outputs (``block_on_arrays``: one event on each
device's current stream) and dividing the chunk wall time by the rounds
it ran.  A chunk's wall time starts at its launch, or at the previous
chunk's commit when the lookahead launched it earlier: the port launches
a chunk by running its rounds' host loop, so two chunks in flight would
otherwise both count the time between, and the ``rounds`` phase would
outgrow the fit.  The ``fit_end`` phase map always sums to the measured fit wall
time by construction: measured spans plus a ``host_other`` remainder for
un-spanned host work.

Three fields mean something of their own on the card:

- ``compile_count`` / ``compile_s`` (and the ``jit/compile_count``
  counter, ``jit/compile_seconds`` histogram of ``global_metrics()``):
  the port compiles no programs on the fit path.  It counts what it
  builds instead: each ``nvcc`` build of the CUDA kernels
  (``ops/hist_kernels.build_kernels``) and each CUDA-graph capture of the
  serving engine (``serving/engine.py``), through :func:`note_compile`.
  A fit on a process whose kernels are built reports 0.
- ``memory`` (:func:`device_memory_stats`): ``torch.cuda.memory_stats(i)``
  per visible card, keyed ``"gpu:<i>"`` as the JAX package keys a GPU:
  ``bytes_in_use`` is ``allocated_bytes.all.current``,
  ``peak_bytes_in_use`` ``allocated_bytes.all.peak``, ``num_allocs``
  ``allocation.all.allocated`` and ``bytes_limit``
  ``torch.cuda.mem_get_info(i)[1]``.  ``largest_alloc_size`` has no
  torch counterpart and is left out.  A CPU fit reports no ``memory``.
- ``round_cost`` / ``mfu_est`` (``ops/tree.round_cost_est``): the peak
  rate and memory bandwidth are the card's own, and only for a card
  whose figures the port knows; elsewhere ``mfu_est`` and
  ``cost_model_error_pct`` are absent, not guessed.

Compile attribution is process-wide: concurrent fits (stacking
``parallelism>1``) each see the builds of the shared window.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import torch

from spark_ensemble_tpu_torch.telemetry import flight as _flight
from spark_ensemble_tpu_torch.telemetry.registry import MetricsRegistry
from spark_ensemble_tpu_torch.telemetry.trace import (
    NULL_CONTEXT,
    NULL_SPAN,
    Span,
    TraceContext,
    Tracer,
    new_span_id,
    new_trace_id,
)
from spark_ensemble_tpu_torch.utils.instrumentation import block_on_arrays

logger = logging.getLogger("spark_ensemble_tpu_torch")

__all__ = [
    "FitTelemetry",
    "TelemetryRecorder",
    "record_fits",
    "device_memory_stats",
    "global_metrics",
    "emit_event",
    "empty_history",
    "note_compile",
    "serving_stream_id",
]

TELEMETRY_ENV = "SE_TPU_TELEMETRY"
PHASES_ENV = "SE_TPU_TELEMETRY_PHASES"

# ---------------------------------------------------------------------------
# process-global state: metrics registry, compile ledger, recorder slot
# ---------------------------------------------------------------------------

_GLOBAL = MetricsRegistry()


def global_metrics() -> MetricsRegistry:
    """The process-global registry (compile counters live here)."""
    return _GLOBAL


_COMPILE_LOCK = threading.Lock()
_COMPILE_COUNT = 0
_COMPILE_SECS = 0.0


def note_compile(seconds: float) -> None:
    """Record one build of device code: an ``nvcc`` build of the CUDA
    kernels or one CUDA-graph capture of the serving engine (see the
    module docstring)."""
    global _COMPILE_COUNT, _COMPILE_SECS
    with _COMPILE_LOCK:
        _COMPILE_COUNT += 1
        _COMPILE_SECS += float(seconds)
    _GLOBAL.counter("jit/compile_count").inc()
    _GLOBAL.histogram("jit/compile_seconds").record(float(seconds))


def compile_snapshot() -> tuple:
    """(count, seconds) of device-code builds observed so far this
    process."""
    with _COMPILE_LOCK:
        return _COMPILE_COUNT, _COMPILE_SECS


#: ``torch.cuda.memory_stats`` keys behind the JAX package's allocator keys
_MEMORY_KEYS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
    ("num_allocs", "allocation.all.allocated"),
)


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card allocator stats, keyed ``"gpu:<i>"`` (see the module
    docstring for the key map); empty without CUDA, so a CPU fit reports
    no ``memory``."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        keep = {
            key: int(stats[src_key])
            for key, src_key in _MEMORY_KEYS
            if src_key in stats
        }
        keep["bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
        out[f"gpu:{i}"] = keep
    return out


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


class TelemetryRecorder:
    """Thread-safe in-memory event sink (stacking fits members from a
    thread pool, and each member fit emits into the same recorder)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []

    def record(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)

    def extend(self, events: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._events.extend(events)

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def fits(self) -> Dict[str, List[Dict[str, Any]]]:
        """Events grouped by fit id, in emission order."""
        out: Dict[str, List[Dict[str, Any]]] = {}
        for ev in self.events:
            out.setdefault(ev.get("fit_id", "?"), []).append(ev)
        return out


_RECORDER_LOCK = threading.Lock()
_RECORDER: Optional[TelemetryRecorder] = None


@contextlib.contextmanager
def record_fits() -> Iterator[TelemetryRecorder]:
    """Capture every fit's event stream in memory for the duration of the
    context — the programmatic alternative to the JSONL sinks::

        with telemetry.record_fits() as rec:
            model = GBMClassifier(...).fit(X, y)
        rounds = [e for e in rec.events if e["event"] == "round_end"]

    A module-level slot rather than a contextvar on purpose: stacking
    fits members from worker threads, and those threads must see the
    recorder the caller installed."""
    global _RECORDER
    rec = TelemetryRecorder()
    with _RECORDER_LOCK:
        prev, _RECORDER = _RECORDER, rec
    try:
        yield rec
    finally:
        with _RECORDER_LOCK:
            _RECORDER = prev


def _active_recorder() -> Optional[TelemetryRecorder]:
    with _RECORDER_LOCK:
        return _RECORDER


_JSONL_LOCK = threading.Lock()


def _append_jsonl(path: str, events: List[Dict[str, Any]],
                  fsync: bool = False) -> None:
    lines = [json.dumps(ev, sort_keys=True, default=float) for ev in events]
    with _JSONL_LOCK:
        with open(path, "a") as f:
            for line in lines:
                f.write(line + "\n")
            if fsync:
                # crash paths (host_preempt, abort) must not lose the
                # terminal rows to page-cache buffering: the victim is
                # about to re-raise and may be SIGKILLed mid-teardown
                f.flush()
                os.fsync(f.fileno())


# ---------------------------------------------------------------------------
# standalone events (serving subsystem)
# ---------------------------------------------------------------------------

_STREAM_SEQ = itertools.count()


def serving_stream_id(label: str = "serving") -> str:
    """A fresh stream id in the same ``family:pid:seq`` shape as fit ids, so
    ``tools/telemetry_report.py`` groups a serving session's events the way
    it groups a fit's."""
    return f"{label}:{os.getpid()}:{next(_STREAM_SEQ)}"


def telemetry_sink_active(path: Optional[str] = None) -> bool:
    """Whether :func:`emit_event` with this ``path`` would reach any sink
    — the cheap pre-check hot paths use to skip building span objects
    entirely when nobody is listening (docs/tracing.md)."""
    return bool(
        path or os.environ.get(TELEMETRY_ENV) or _active_recorder() is not None
    )


def emit_event(event: str, path: Optional[str] = None, **fields) -> None:
    """Emit one standalone structured event (``model_packed``,
    ``engine_warmup``, ``request_served``, ...) through the same sinks as
    fit telemetry: explicit ``path`` > ``SE_TPU_TELEMETRY`` env > the active
    ``record_fits()`` recorder.  JSONL writes are immediate — serving
    processes are long-running, so there is no fit-end flush to ride.
    A no-op (nothing allocated past the sink check) when no sink is active.
    """
    path = path or os.environ.get(TELEMETRY_ENV) or None
    recorder = _active_recorder()
    if not path and recorder is None:
        return
    ev: Dict[str, Any] = {"event": event, "ts": time.time()}
    ev.update(fields)
    ev.setdefault("fit_id", "serving")
    _flight.recorder().record(ev)
    if recorder is not None:
        recorder.record(ev)
    if path:
        _append_jsonl(path, [ev])


def empty_history() -> Dict[str, np.ndarray]:
    """The ``fit_history_`` of a fit that recorded no rounds: the same keys
    and dtypes, zero length."""
    return {
        "round": np.zeros(0, np.int64),
        "learner_index": np.zeros(0, np.int64),
        "duration_s": np.zeros(0, np.float64),
        "loss": np.zeros(0, np.float64),
        "step_size": np.zeros(0, np.float64),
    }


def _host(x) -> np.ndarray:
    """A tensor, list or array of per-round values as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
        return torch.stack([t.detach().cpu().double() for t in x]).numpy()
    return np.asarray(x, dtype=np.float64)


# ---------------------------------------------------------------------------
# per-fit handle
# ---------------------------------------------------------------------------

_FIT_SEQ = itertools.count()


class FitTelemetry:
    """Per-fit event emitter; ``FitTelemetry.start(...)`` returns a shared
    no-op singleton when no sink is active, so the disabled path costs one
    attribute check per call site and allocates nothing."""

    enabled = True

    def __init__(self, family: str, path: Optional[str],
                 recorder: Optional[TelemetryRecorder]):
        self.family = family
        self.fit_id = f"{family}:{os.getpid()}:{next(_FIT_SEQ)}"
        self._path = path
        self._recorder = recorder
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._phases: Dict[str, float] = {}
        self._rounds = 0
        self._host_blocked_s = 0.0
        self._finished = False
        self._t0 = time.perf_counter()
        self._last_mark = self._t0
        # causal tracing plane (telemetry/trace.py): every fit is one
        # trace; the root "fit" span's id is allocated up front so child
        # spans (round chunks, shard waits, checkpoint saves) can parent
        # to it before the root itself is emitted at finish()/abort()
        self.trace_id = new_trace_id()
        self._root_span_id = new_span_id()
        self._ts0 = time.time()
        self._tracer = Tracer(self._emit, trace_id=self.trace_id)
        self._compile0 = compile_snapshot()
        # incremental JSONL flush cursor (flush-on-crash support: the
        # host_preempt path flushes mid-fit; finish()/abort() flush the
        # remainder) and the measured-vs-estimated ledger baselines
        self._flushed = 0
        self._ledger_compile = self._compile0
        self._ledger_mem: Dict[str, int] = {}

    # -- construction -----------------------------------------------------

    @classmethod
    def start(cls, estimator=None, family: str = "", n: Optional[int] = None,
              d: Optional[int] = None, telemetry_path: Optional[str] = None,
              mesh=None, **meta) -> "FitTelemetry":
        """Resolve the sink (param > env > in-memory recorder) and open the
        stream; returns the disabled singleton when nothing is listening,
        and on every rank of a mesh fit but rank 0 (one stream a fit)."""
        if mesh is not None and mesh.rank != 0:
            return _DISABLED
        path = telemetry_path or getattr(estimator, "telemetry_path", None)
        path = path or os.environ.get(TELEMETRY_ENV) or None
        recorder = _active_recorder()
        if not path and recorder is None:
            return _DISABLED
        if not family and estimator is not None:
            family = type(estimator).__name__
        telem = cls(family, path, recorder)
        start_ev = {"event": "fit_start", "family": family}
        if n is not None:
            start_ev["n"] = int(n)
        if d is not None:
            start_ev["d"] = int(d)
        start_ev.update(meta)
        telem._emit(start_ev)
        _stack().append(telem)
        return telem

    # -- emission ---------------------------------------------------------

    def emit(self, event: str, **fields) -> None:
        """Append an ad-hoc structured event (``retry``, ``guard_nonfinite``,
        ``resume_from_checkpoint``, ...) to the stream — the hook the
        robustness runtime reports through (docs/robustness.md)."""
        ev: Dict[str, Any] = {"event": event}
        ev.update(fields)
        self._emit(ev)

    def _emit(self, event: Dict[str, Any]) -> None:
        event = dict(event)
        event.setdefault("fit_id", self.fit_id)
        event.setdefault("ts", time.time())
        with self._lock:
            self._events.append(event)
        _flight.recorder().record(event)
        if self._recorder is not None:
            self._recorder.record(event)

    def phase_mark(self, name: str) -> None:
        """Charge the host time since the previous mark (or fit start) to
        phase ``name`` — the span bookkeeping that makes the ``fit_end``
        phase map sum to wall time by construction."""
        now = time.perf_counter()
        with self._lock:
            self._phases[name] = self._phases.get(name, 0.0) + (
                now - self._last_mark
            )
            self._last_mark = now

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Measure a block into phase ``name`` without disturbing the
        running mark (for out-of-line work like checkpoint waits)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._phases[name] = self._phases.get(name, 0.0) + dt

    def host_blocked(self, seconds: float) -> None:
        """Charge ``seconds`` of driver time spent blocked on a device
        read between dispatches (the serialization the lookahead pipeline
        exists to hide — docs/pipeline.md); accumulated per fit and
        reported as ``host_blocked_us`` on ``fit_end``."""
        with self._lock:
            self._host_blocked_s += float(seconds)

    def blocking_read(self, fence: Any) -> None:
        """Fence on ``fence`` (any nest of tensors) and charge the
        wait to the host-blocked accumulator — the one call the round
        drivers make before touching a chunk's outputs."""
        t0 = time.perf_counter()
        block_on_arrays(fence)
        self.host_blocked(time.perf_counter() - t0)

    def flush(self, fsync: bool = False) -> int:
        """Append events emitted since the last flush to the JSONL sink
        (no-op without one); returns the row count written.  Crash paths
        pass ``fsync=True`` so the stream survives the process dying
        right after — the victim's half of a preemption would otherwise
        sit in the page cache when SIGKILL lands (docs/tracing.md)."""
        if not self._path:
            return 0
        with self._lock:
            pending = self._events[self._flushed:]
            self._flushed = len(self._events)
        if pending:
            _append_jsonl(self._path, pending, fsync=fsync)
        return len(pending)

    # -- causal tracing (telemetry/trace.py; docs/tracing.md) -------------

    def trace_context(self) -> TraceContext:
        """Propagation handle for a child span begun on another thread
        (checkpoint writer, prefetch reconstruction): parents to the
        fit's root span."""
        return TraceContext(self.trace_id, self._root_span_id)

    def begin_span(self, name: str, parent=None, thread=None,
                   annotate: bool = True, **attrs) -> Span:
        """Start a span on this fit's trace (defaults to a child of the
        root "fit" span).  The caller must guarantee ``end()`` on every
        path — ``with`` or try/finally."""
        if parent is None:
            parent = self.trace_context()
        return self._tracer.begin_span(
            name, parent=parent, thread=thread, annotate=annotate, **attrs
        )

    def emit_span(self, name: str, ts: float, dur_s: float, parent=None,
                  thread=None, **fields) -> str:
        """Emit an already-measured span (work done on a thread that must
        stay telemetry-free, e.g. the shard-prefetch worker); returns the
        span id for further parenting."""
        if parent is None:
            parent = self.trace_context()
        return self._tracer.emit_span(
            name, ts, dur_s, parent=parent, thread=thread, **fields
        )

    def _emit_root_span(self, wall: float, **attrs) -> None:
        rec: Dict[str, Any] = {
            "event": "span",
            "name": "fit",
            "trace_id": self.trace_id,
            "span_id": self._root_span_id,
            "parent_id": "",
            "ts": self._ts0,
            "dur_s": wall,
            "pid": os.getpid(),
            "family": self.family,
        }
        rec.update(attrs)
        self._emit(rec)

    def round_chunk(self, start_round: int, count: int, t0: float,
                    fence: Any = (), losses: Any = None, step_sizes: Any = None,
                    learner_index: Optional[int] = None,
                    phase: str = "rounds",
                    divisor: Optional[int] = None,
                    round_cost: Optional[Dict[str, Any]] = None) -> float:
        """Record ``count`` rounds launched as one chunk: fence on the chunk
        outputs, then emit a ``round_start``/``round_end`` pair per round at
        chunk_duration/count each (a chunk's rounds run back to back on the
        stream, and the host reads only the chunk's end).  ``divisor``
        overrides the per-round denominator when the chunk COMPUTED more
        rounds than it kept (boosting aborts discard the tail).

        ``round_cost`` (ops/tree.py ``round_cost_est``) attaches the static
        per-round cost model to every round_end — ``hist_tier``,
        ``pack_bits``, ``hbm_bytes_est`` — and, combined with the measured
        per-round duration, a per-round ``mfu_est`` (flops_est /
        (duration * peak_flops)), so MFU is observable per fit instead of
        only in one-off captures.

        Measured-vs-estimated ledger (docs/tracing.md#pod-scope): each
        chunk also records what the devices actually did against what
        the cost model predicted — the compile-count delta and
        per-device ``bytes_in_use`` delta since the previous chunk land
        on the chunk's first ``round_end`` (``chunk_compiles`` /
        ``chunk_compile_s`` / ``memory_delta``), and when the cost model
        supplies ``hbm_bw_est`` the roofline time ``modeled_s =
        max(flops/peak, hbm_bytes/bw)`` is compared against the measured
        per-round duration as ``cost_model_error_pct``."""
        if fence is not None and fence != ():
            block_on_arrays(fence)
        now = time.perf_counter()
        with self._lock:
            # a chunk launched ahead (lookahead) starts at the previous
            # commit: the chunks' times tile the fit, never overlap
            t0 = max(t0, self._last_mark)
        duration = now - t0
        per_round = duration / max(divisor if divisor else count, 1)
        loss_arr = None if losses is None else _host(losses).reshape(-1)
        step_arr = None
        if step_sizes is not None:
            step_arr = _host(step_sizes).astype(np.float64)
            step_arr = step_arr.reshape(step_arr.shape[0], -1).mean(axis=1)
        mem = device_memory_stats()
        c1, s1 = compile_snapshot()
        chunk_compiles = c1 - self._ledger_compile[0]
        chunk_compile_s = s1 - self._ledger_compile[1]
        self._ledger_compile = (c1, s1)
        mem_delta: Dict[str, int] = {}
        for dev, stats in mem.items():
            cur = int(stats.get("bytes_in_use", 0))
            prev = self._ledger_mem.get(dev)
            if prev is not None and cur != prev:
                mem_delta[dev] = cur - prev
            self._ledger_mem[dev] = cur
        cost_fields: Dict[str, Any] = {}
        if round_cost:
            for key in ("hist_tier", "pack_bits", "hbm_bytes_est",
                        "sampled_rows", "sample_bucket", "hbm_saved_est"):
                if key in round_cost:
                    cost_fields[key] = round_cost[key]
            flops = round_cost.get("flops_est")
            peak = round_cost.get("peak_flops")
            if flops and peak and per_round > 0:
                cost_fields["mfu_est"] = float(flops) / (per_round * float(peak))
                modeled = float(flops) / float(peak)
                bw = round_cost.get("hbm_bw_est")
                if bw:
                    modeled = max(
                        modeled,
                        float(round_cost.get("hbm_bytes_est", 0.0)) / float(bw),
                    )
                cost_fields["modeled_s"] = modeled
                cost_fields["cost_model_error_pct"] = (
                    100.0 * abs(per_round - modeled) / per_round
                )
                # live copy for the online watchdog (docs/operator.md):
                # the sentinel's cost-model tripwire, readable mid-fit
                _GLOBAL.gauge("fit/cost_model_error_pct").set(
                    cost_fields["cost_model_error_pct"]
                )
        for j in range(count):
            rnd = start_round + j
            li = rnd if learner_index is None else learner_index
            self._emit({"event": "round_start", "round": rnd,
                        "learner_index": li})
            end_ev: Dict[str, Any] = {
                "event": "round_end",
                "round": rnd,
                "learner_index": li,
                "duration_s": per_round,
                "phases": {"device_round": per_round},
            }
            end_ev.update(cost_fields)
            if j == 0:
                # the ledger deltas are chunk-granular (one dispatch);
                # charging them to every synthesized round would
                # overcount, so they ride the chunk's first round only
                end_ev["chunk_compiles"] = chunk_compiles
                end_ev["chunk_compile_s"] = chunk_compile_s
                if mem_delta:
                    end_ev["memory_delta"] = mem_delta
            if loss_arr is not None and j < loss_arr.shape[0]:
                end_ev["loss"] = float(loss_arr[j])
            if step_arr is not None and j < step_arr.shape[0]:
                end_ev["step_size"] = float(step_arr[j])
            if mem:
                end_ev["memory"] = mem
            self._emit(end_ev)
        with self._lock:
            self._rounds += count
            self._phases[phase] = self._phases.get(phase, 0.0) + duration
            self._last_mark = now
        return duration

    def member_fit(self, learner_index: int, duration_s: float,
                   loss: Optional[float] = None,
                   family: Optional[str] = None) -> None:
        """One sequentially-fitted member (stacking base learners): a
        round_start/round_end pair whose round index IS the learner index."""
        self._emit({"event": "round_start", "round": learner_index,
                    "learner_index": learner_index})
        ev: Dict[str, Any] = {
            "event": "round_end",
            "round": learner_index,
            "learner_index": learner_index,
            "duration_s": float(duration_s),
            "phases": {"member_fit": float(duration_s)},
        }
        if loss is not None:
            ev["loss"] = float(loss)
        if family:
            ev["member_family"] = family
        mem = device_memory_stats()
        if mem:
            ev["memory"] = mem
        self._emit(ev)
        with self._lock:
            self._rounds += 1
            self._phases["rounds"] = (
                self._phases.get("rounds", 0.0) + float(duration_s)
            )
            self._last_mark = time.perf_counter()

    def phase_probe(self, phases: Dict[str, float],
                    note: Optional[str] = None) -> None:
        """Fine-grained per-phase device costs from a one-round probe (see
        ``SE_TPU_TELEMETRY_PHASES``); informational — probe time is charged
        to the ``probe`` phase, not to the rounds."""
        ev: Dict[str, Any] = {
            "event": "phase_probe",
            "phases": {k: float(v) for k, v in phases.items()},
        }
        if note:
            ev["note"] = note
        self._emit(ev)

    def finish(self, model=None, **outcome) -> None:
        """Close the stream: charge the un-marked tail to ``finalize``,
        add the ``host_other`` remainder so phases sum EXACTLY to wall,
        emit ``fit_end``, flush the JSONL sink, and attach
        ``model.fit_history_``."""
        if self._finished:
            return
        self._finished = True
        self._unregister()
        self.phase_mark("finalize")
        wall = time.perf_counter() - self._t0
        with self._lock:
            phases = dict(self._phases)
        other = wall - sum(phases.values())
        if abs(other) > 1e-9:
            phases["host_other"] = other
        c1, s1 = compile_snapshot()
        ev: Dict[str, Any] = {
            "event": "fit_end",
            "family": self.family,
            "wall_s": wall,
            "rounds": self._rounds,
            "phases": phases,
            "compile_count": c1 - self._compile0[0],
            "compile_s": s1 - self._compile0[1],
            "host_blocked_us": self._host_blocked_s * 1e6,
        }
        if wall > 0:
            # live copy for the online watchdog (docs/operator.md): the
            # host-blocked share of the most recent finished fit
            _GLOBAL.gauge("fit/host_blocked_share").set(
                self._host_blocked_s / wall
            )
        mem = device_memory_stats()
        if mem:
            ev["memory"] = mem
        ev.update(outcome)
        self._emit_root_span(wall, rounds=self._rounds)
        self._emit(ev)
        self.flush()
        if model is not None:
            model.fit_history_ = self.history()

    def abort(self, error: BaseException, **outcome) -> None:
        """Terminal record for a fit that raised mid-round: emit
        ``fit_aborted`` (exception type + message, last completed round,
        phase breakdown) and flush the JSONL sink, so every stream ends
        with a terminal record even when ``fit()`` never returns."""
        if self._finished:
            return
        self._finished = True
        self._unregister()
        self.phase_mark("aborted")
        wall = time.perf_counter() - self._t0
        with self._lock:
            phases = dict(self._phases)
        ev: Dict[str, Any] = {
            "event": "fit_aborted",
            "family": self.family,
            "wall_s": wall,
            "rounds": self._rounds,
            "error_type": type(error).__name__,
            "error": str(error)[:500],
            "phases": phases,
        }
        ev.update(outcome)
        self._emit_root_span(wall, error=type(error).__name__)
        self._emit(ev)
        # fsync: abort runs on crash paths (preemption, guard abort)
        # where the process may be killed before the page cache drains
        self.flush(fsync=True)

    def _unregister(self) -> None:
        st = _stack()
        if self in st:
            st.remove(self)

    # -- consumption ------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def history(self) -> Dict[str, np.ndarray]:
        """Recorded rounds as aligned arrays — the ``fit_history_`` payload
        (round, learner_index, duration_s, loss, step_size; loss/step_size
        are NaN where a family does not produce them)."""
        ends = [e for e in self.events() if e["event"] == "round_end"]
        if not ends:
            return empty_history()
        return {
            "round": np.array([e["round"] for e in ends], np.int64),
            "learner_index": np.array(
                [e["learner_index"] for e in ends], np.int64
            ),
            "duration_s": np.array(
                [e.get("duration_s", np.nan) for e in ends], np.float64
            ),
            "loss": np.array(
                [e.get("loss", np.nan) for e in ends], np.float64
            ),
            "step_size": np.array(
                [e.get("step_size", np.nan) for e in ends], np.float64
            ),
        }

    @staticmethod
    def phases_enabled() -> bool:
        """Whether the opt-in fine-phase probe should run (it costs one
        extra round's pieces, each run twice, per fit)."""
        return os.environ.get(PHASES_ENV, "") not in ("", "0")


class _DisabledFitTelemetry(FitTelemetry):
    """Shared no-op: every method returns immediately, no state mutates.

    Audit discipline: every ``FitTelemetry`` method with side effects or
    allocations must be overridden here — inherited implementations run
    against state this ``__init__`` never creates.  The inherited
    surface as of the tracing plane: ``start``/``phases_enabled``
    (class/static, sinkless), ``span`` (overridden), everything else
    overridden below.  ``round_chunk``/``host_blocked`` take ``*a, **kw``
    /positional so their kwarg drift since PR 1 (``divisor``,
    ``round_cost``, ``phase``) cannot break the disabled path."""

    enabled = False
    trace_id = ""

    def __init__(self):  # noqa: D401 - deliberately skip parent init
        self.family = ""
        self.fit_id = ""

    def emit(self, event, **fields):
        # override: the inherited emit() builds the event dict before
        # handing it to _emit — a dead allocation on every robustness
        # event when telemetry is off
        pass

    def _emit(self, event):
        pass

    def phase_mark(self, name):
        pass

    # -- tracing: hand out the shared null objects, allocate nothing ------

    def trace_context(self):
        return NULL_CONTEXT

    def begin_span(self, name, parent=None, thread=None, annotate=True,
                   **attrs):
        return NULL_SPAN

    def emit_span(self, name, ts, dur_s, parent=None, thread=None,
                  **fields):
        return ""

    def _emit_root_span(self, wall, **attrs):
        pass

    @contextlib.contextmanager
    def span(self, name):
        yield

    def round_chunk(self, *a, **kw):
        return 0.0

    def flush(self, fsync=False):
        return 0

    def host_blocked(self, seconds):
        pass

    def blocking_read(self, fence):
        pass

    def member_fit(self, *a, **kw):
        pass

    def phase_probe(self, *a, **kw):
        pass

    def finish(self, model=None, **outcome):
        if model is not None and not hasattr(model, "fit_history_"):
            # the attribute is part of the fitted-model contract whether or
            # not telemetry ran; empty arrays keep downstream code uniform
            model.fit_history_ = self.history()

    def abort(self, error, **outcome):
        pass

    def events(self):
        return []

    def history(self):
        return empty_history()


_DISABLED = _DisabledFitTelemetry()


# -- active-fit stack (terminal fit_aborted records) -----------------------
#
# Each live FitTelemetry registers on a thread-local stack at start() and
# unregisters at finish()/abort().  The instrumented_fit wrapper snapshots
# the depth before running a fit body and, when the body raises, aborts
# everything pushed above that snapshot — so nested fits (GBM's init model,
# stacking's threaded members) each get their own terminal record without
# the families having to thread try/except through every loop.

_FIT_TLS = threading.local()


def _stack() -> list:
    st = getattr(_FIT_TLS, "items", None)
    if st is None:
        st = _FIT_TLS.items = []
    return st


def active_fit_depth() -> int:
    """Depth of this thread's live-fit stack (see instrumented_fit)."""
    return len(_stack())


def abort_active_fits(depth: int, error: BaseException) -> None:
    """Abort (emit ``fit_aborted`` + flush) every telemetry registered on
    this thread above ``depth``, innermost first; then leave a flight-
    recorder dump — guard aborts and host losses are exactly the deaths
    the black box exists for (telemetry/flight.py)."""
    st = _stack()
    path = None
    aborted = False
    while len(st) > depth:
        telem = st.pop()
        aborted = True
        path = path or getattr(telem, "_path", None)
        try:
            telem.abort(error)
        except Exception:
            logger.exception("failed to flush fit_aborted record")
    if aborted:
        _flight.dump_flight(
            reason=f"fit_abort:{type(error).__name__}", error=error,
            telemetry_path=path,
        )
