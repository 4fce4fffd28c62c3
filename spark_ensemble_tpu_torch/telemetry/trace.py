"""Causal tracing plane: spans over the repo's concurrent machinery
(PyTorch port of ``telemetry/trace.py``, with the same ids and records).

Every unit of work — a fit, a (possibly speculative) round chunk, a shard
load / prefetch wait, a checkpoint save, an engine warmup tier, a served
request — becomes a :class:`Span` with a
stable ``trace_id`` / ``span_id`` / ``parent_id``.  Spans are just one
more telemetry event type (``"event": "span"``) emitted through the
existing ``FitTelemetry._emit`` / ``emit_event`` chokepoints, so the
JSONL stream, ``tools/telemetry_report.py`` and every other consumer
keep working unchanged; ``tools/trace_viewer.py`` turns the same stream
into a Chrome/Perfetto ``trace_event`` JSON with one track per
thread/replica and flow arrows for hedges, replays and invalidated
speculative chunks (docs/tracing.md); it reads the port's streams as it
reads the JAX package's.

Propagation rules (the part a flat event stream cannot express):

- Same thread, same subsystem: pass the parent :class:`Span` to
  ``begin_span(..., parent=...)``.
- Across a thread or process boundary: capture ``span.context()`` (a
  :class:`TraceContext` — two strings, safe to close over or pickle) on
  the origin side and hand it to ``begin_span``/``emit_span`` on the
  far side.  The prefetcher worker → consumer and fit thread →
  checkpoint-writer seams both do this.
- Causality between *sibling* spans (a hedge twin racing its primary, a
  replay re-dispatch, a commit invalidating the speculative tail) is a
  flow: allocate ``new_flow_id()``, record it in the source span's
  ``flow_out`` list and the sink span's ``flow_in`` — the viewer renders
  the arrow.

Worker threads that must stay torch- and telemetry-free (the shard
prefetcher's contract) don't begin spans at all: the consumer
reconstructs the worker's span after the fact from measured wall-clock
timings via :meth:`Tracer.emit_span`.

While a ``torch.profiler`` capture is live on the thread (``profile_dir``,
or any caller's own profiler), every span begun and ended on that thread
is also a profiler scope: a ``RecordFunction`` at operator scope, listed
by the profiler beside the aten operators on the same clock, so the
kernels a span's operators launch link to it by correlation id.  It is
not a user annotation: those also get a device-side copy on the CUDA
timeline, which a reader of device activity would count as a kernel.
Outside a capture no scope is entered.

:func:`span` is the fit path's one entry point (docs/tracing.md has the
catalogue: ``fit``, ``fit.bin``, ``fit.round``, ``round.step``,
``tree.level``, ...).  It is a profiler scope and nothing else: a fit's
stream already has its rounds (``round_end``), its chunks
(``round_chunk``) and its phases (``fit_end``'s phase map).

Overhead discipline: with no telemetry sink the disabled ``FitTelemetry``
singleton hands out :data:`NULL_SPAN` / :data:`NULL_TRACER`, whose
methods are empty — the traced hot paths pay one attribute lookup and
one no-op call (<1% of fit wall, bench-pinned ``trace_overhead_pct``).
Outside a profiler, :func:`span` costs one profiler check and returns
:data:`NULL_SPAN`; it never fences, synchronizes or launches.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

__all__ = [
    "Span",
    "TraceContext",
    "Tracer",
    "NULL_SPAN",
    "NULL_TRACER",
    "new_trace_id",
    "new_span_id",
    "new_flow_id",
    "trace_annotations_enabled",
    "span",
    "fit_span",
]

#: whether a torch.profiler capture is live on this thread (a C call that
#: reads a thread-local; no allocation)
_profiler_enabled = torch._C._autograd._profiler_enabled

#: a profiler scope at operator level (``torch.profiler.record_function``
#: would open a user annotation, which gets a device-side copy)
_ProfilerScope = torch._C._profiler._RecordFunctionFast

#: per-thread state: ``depth``, the instrumented fits running on the thread
_TLS = threading.local()

# one process-wide monotone counter feeds every id family; ids embed the
# pid so streams appended by multiple processes never collide
_seq = itertools.count(1)


def new_trace_id() -> str:
    """A fresh trace id (one per causally-connected timeline: a fit, a
    router's lifetime)."""
    return f"t{os.getpid():x}.{next(_seq):x}"


def new_span_id() -> str:
    """A fresh span id, unique within the process's stream."""
    return f"s{os.getpid():x}.{next(_seq):x}"


def new_flow_id() -> int:
    """A fresh flow id (Perfetto flow ``id`` — an int) tying a source
    span's ``flow_out`` to a sink span's ``flow_in``."""
    return (os.getpid() << 24) | (next(_seq) & 0xFFFFFF)


def trace_annotations_enabled() -> bool:
    """Whether spans also enter profiler scopes: exactly while a
    ``torch.profiler`` capture is live on this thread."""
    return bool(_profiler_enabled())


def _enter_annotation(name: str):
    if not _profiler_enabled():
        return None
    ann = _ProfilerScope(name)
    ann.__enter__()
    return ann


def _exit_annotation(ann) -> None:
    if ann is not None:
        ann.__exit__(None, None, None)


class TraceContext:
    """The two strings that cross a thread/process boundary.

    Truthiness doubles as "is tracing live": the disabled path hands out
    :data:`NULL_CONTEXT`, which is falsy."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str = "", span_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id

    def __bool__(self) -> bool:
        return bool(self.trace_id)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


NULL_CONTEXT = TraceContext()


class Span:
    """One unit of work on the causal timeline.

    Use as a context manager, or call :meth:`end` in a ``finally`` —
    every call site guarantees one of the two.  ``end()`` is idempotent; an exceptional
    ``with``-exit records the exception type as an ``error`` attribute.
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "thread", "attrs",
        "_emit", "_ts", "_t0", "_done", "_ann",
    )

    def __init__(
        self,
        emit: Callable[[Dict[str, Any]], None],
        name: str,
        trace_id: str,
        parent_id: str = "",
        thread: Optional[str] = None,
        annotate: bool = True,
        **attrs: Any,
    ):
        self._emit = emit
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.thread = thread
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self._ts = time.time()
        self._t0 = time.perf_counter()
        self._done = False
        # annotate=False for spans that END on a different thread (queued
        # request spans resolve on a worker): a profiler scope is
        # same-thread scoped
        self._ann = _enter_annotation(name) if annotate else None

    def add(self, **attrs: Any) -> None:
        """Attach attributes to the span before (or at) ``end``."""
        self.attrs.update(attrs)

    def context(self) -> TraceContext:
        """The propagation handle for a child begun on another thread."""
        return TraceContext(self.trace_id, self.span_id)

    def end(self, **attrs: Any) -> None:
        if self._done:
            return
        self._done = True
        dur_s = time.perf_counter() - self._t0
        _exit_annotation(self._ann)
        self._ann = None
        if attrs:
            self.attrs.update(attrs)
        rec: Dict[str, Any] = {
            "event": "span",
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts": self._ts,
            "dur_s": dur_s,
            "pid": os.getpid(),
        }
        if self.thread:
            rec["thread"] = self.thread
        rec.update(self.attrs)
        self._emit(rec)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.end(error=exc_type.__name__)
        else:
            self.end()
        return False

    def __bool__(self) -> bool:
        return True


class _NullSpan:
    """The disabled path's span: every method is an empty no-op."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = ""

    def add(self, **attrs: Any) -> None:
        pass

    def context(self) -> TraceContext:
        return NULL_CONTEXT

    def end(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory bound to one emit chokepoint and one ``trace_id``.

    ``FitTelemetry`` owns one per fit (emitting through ``_emit`` so
    spans ride the fit's JSONL flush); ``InferenceEngine`` owns one per
    engine (emitting immediately through ``emit_event``)."""

    __slots__ = ("trace_id", "thread", "_emit")

    def __init__(
        self,
        emit: Callable[[Dict[str, Any]], None],
        trace_id: Optional[str] = None,
        thread: Optional[str] = None,
    ):
        self._emit = emit
        self.trace_id = trace_id or new_trace_id()
        self.thread = thread

    def begin_span(
        self,
        name: str,
        parent: Any = None,
        thread: Optional[str] = None,
        annotate: bool = True,
        **attrs: Any,
    ) -> Span:
        """Start a span.  ``parent`` is a :class:`Span`, a
        :class:`TraceContext`, or None (a root on this tracer's trace).
        The caller must guarantee ``end()`` on every path (``with`` or
        try/finally)."""
        trace_id = self.trace_id
        parent_id = ""
        if parent is not None:
            p_trace = getattr(parent, "trace_id", "")
            if p_trace:
                trace_id = p_trace
                parent_id = getattr(parent, "span_id", "")
        return Span(
            self._emit, name, trace_id, parent_id=parent_id,
            thread=thread or self.thread, annotate=annotate, **attrs,
        )

    def emit_span(
        self,
        name: str,
        ts: float,
        dur_s: float,
        parent: Any = None,
        thread: Optional[str] = None,
        flow_in: Optional[int] = None,
        flow_out: Optional[List[int]] = None,
        **attrs: Any,
    ) -> str:
        """Emit an already-finished span from measured timings — the
        reconstruction path for work done on a thread that must stay
        telemetry-free (the shard-prefetch worker).  Returns the new
        span's id so the caller can parent further spans under it."""
        trace_id = self.trace_id
        parent_id = ""
        if parent is not None:
            p_trace = getattr(parent, "trace_id", "")
            if p_trace:
                trace_id = p_trace
                parent_id = getattr(parent, "span_id", "")
        span_id = new_span_id()
        rec: Dict[str, Any] = {
            "event": "span",
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "ts": float(ts),
            "dur_s": float(dur_s),
            "pid": os.getpid(),
        }
        if thread or self.thread:
            rec["thread"] = thread or self.thread
        if flow_in is not None:
            rec["flow_in"] = flow_in
        if flow_out:
            rec["flow_out"] = list(flow_out)
        rec.update(attrs)
        self._emit(rec)
        return span_id


class _NullTracer:
    """Disabled tracer: hands out :data:`NULL_SPAN`, emits nothing."""

    __slots__ = ()
    trace_id = ""
    thread = None

    def begin_span(self, name, parent=None, thread=None, annotate=True,
                   **attrs) -> _NullSpan:
        return NULL_SPAN

    def emit_span(self, name, ts, dur_s, parent=None, thread=None,
                  flow_in=None, flow_out=None, **attrs) -> str:
        return ""

    def __bool__(self) -> bool:
        return False


NULL_TRACER = _NullTracer()


# ---------------------------------------------------------------------------
# the fit path's span entry point
# ---------------------------------------------------------------------------


def span(name: str):
    """The fit path's span: ``with span("fit.bin"): ...``.  A profiler
    scope named ``name`` while a ``torch.profiler`` capture is live on this
    thread, on the profiler's clock and in its event list; otherwise
    :data:`NULL_SPAN`, after one profiler check: no object, no record,
    nothing fenced or launched."""
    return _ProfilerScope(name) if _profiler_enabled() else NULL_SPAN


@contextlib.contextmanager
def fit_span() -> Iterator[None]:
    """:func:`span` over a whole fit: ``fit`` for a fit that starts on a
    thread with no fit running, ``fit.nested`` for one inside another (a
    GBM's prior, a Stacking member), so ``fit`` counts once per top-level
    fit."""
    depth = getattr(_TLS, "depth", 0)
    _TLS.depth = depth + 1
    try:
        with span("fit.nested" if depth else "fit"):
            yield
    finally:
        _TLS.depth = depth
