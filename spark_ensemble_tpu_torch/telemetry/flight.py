"""Crash flight recorder: a per-process black box for dead hosts (PyTorch
port of ``telemetry/flight.py``).

The telemetry JSONL sink is flush-on-finish by design (one append per
fit keeps the hot path allocation-only), which means the host that gets
preempted loses its stream exactly when it matters.  This module keeps
an always-on, allocation-cheap ring of the last K span/event rows every
emit chokepoint produced (``FitTelemetry._emit`` and ``emit_event``
record into it), and dumps the ring — plus device memory stats and the
``global_metrics()`` snapshot, which carries coordinator and breaker
state through their registered live sources — to a post-mortem JSON
file when the process is about to die (a fit that raises: a guard
abort, a chaos preemption; docs/tracing.md#pod-scope).  The memory
stats are ``torch.cuda``'s (``events.device_memory_stats``).

Overhead discipline: ``record`` stores one *reference* to the dict the
sink already built — no copy, no allocation beyond the preallocated
ring — and is only reached when a telemetry sink is active (the
disabled ``FitTelemetry`` singleton never calls ``_emit``), so the
no-sink path stays allocation-free (bench-pinned ``trace_overhead_pct``).

Dump location: ``SE_TPU_FLIGHT_DIR`` env, else the directory of the
active ``SE_TPU_TELEMETRY`` stream, else no dump (the recorder still
rings in memory).  The dump is written tmp-file + fsync + atomic rename
so a crash mid-dump never leaves a half-written black box.

Pure stdlib at module scope: the telemetry events module (and through
it ``torch.cuda``) is only touched lazily inside
:meth:`FlightRecorder.dump`, and a failure there degrades to a dump
without memory stats.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger("spark_ensemble_tpu_torch")

__all__ = [
    "FlightRecorder",
    "recorder",
    "dump_flight",
    "flight_dump_path",
    "FLIGHT_DIR_ENV",
    "DEFAULT_CAPACITY",
]

FLIGHT_DIR_ENV = "SE_TPU_FLIGHT_DIR"
DEFAULT_CAPACITY = 256


def _jsonable(obj: Any):
    """Last-resort JSON coercion for ring rows (numpy scalars etc.)."""
    try:
        return float(obj)
    except Exception:
        return str(obj)


class FlightRecorder:
    """Fixed-capacity ring of the last K telemetry rows.

    ``record`` is the hot path: one lock, one index store of a reference
    to the caller's dict (never copied — the row is immutable once
    emitted), one counter bump.  The ring list is preallocated at
    construction so steady-state recording allocates nothing.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive (got {capacity})")
        self.capacity = int(capacity)
        self._ring: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._next = 0
        self._lock = threading.Lock()

    def record(self, row: Dict[str, Any]) -> None:
        with self._lock:
            self._ring[self._next % self.capacity] = row
            self._next += 1

    @property
    def recorded(self) -> int:
        """Total rows ever recorded (>= len(rows()))."""
        with self._lock:
            return self._next

    def rows(self) -> List[Dict[str, Any]]:
        """The retained rows, oldest first."""
        with self._lock:
            n = self._next
            if n <= self.capacity:
                return [r for r in self._ring[:n] if r is not None]
            start = n % self.capacity
            out = self._ring[start:] + self._ring[:start]
        return [r for r in out if r is not None]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0

    def dump(self, path: str, reason: str = "",
             error: Optional[BaseException] = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the post-mortem JSON: the retained rows plus device
        memory stats and the process metrics snapshot (coordinator /
        breaker state rides the registered sources).  fsync'd and
        atomically renamed into place — the caller is usually about to
        re-raise a preemption, and the file must survive a SIGKILL
        landing right after."""
        payload: Dict[str, Any] = {
            "kind": "flight_recorder",
            "reason": reason,
            "pid": os.getpid(),
            "ts": time.time(),
            "capacity": self.capacity,
            "recorded": self.recorded,
            "rows": self.rows(),
        }
        if error is not None:
            payload["error_type"] = type(error).__name__
            payload["error"] = str(error)[:500]
        try:  # lazy: a dump must not fail for want of memory stats
            from spark_ensemble_tpu_torch.telemetry.events import (
                device_memory_stats,
                global_metrics,
            )

            payload["memory"] = device_memory_stats()
            payload["metrics"] = global_metrics().snapshot()
        except Exception:  # pragma: no cover - depends on install state
            pass
        if extra:
            payload.update(extra)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, default=_jsonable)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        try:  # fsync the directory so the rename itself is durable
            dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # pragma: no cover - exotic filesystems
            pass
        return path


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-global ring every emit chokepoint records into."""
    return _RECORDER


def flight_dump_path(telemetry_path: Optional[str] = None) -> Optional[str]:
    """Where this process's black box lands: ``SE_TPU_FLIGHT_DIR``, else
    next to the telemetry stream (explicit ``telemetry_path`` or the
    ``SE_TPU_TELEMETRY`` env), else None (no dump)."""
    d = os.environ.get(FLIGHT_DIR_ENV) or None
    if not d and telemetry_path:
        d = os.path.dirname(os.path.abspath(telemetry_path))
    if not d:
        tel = os.environ.get("SE_TPU_TELEMETRY") or None
        if tel:
            d = os.path.dirname(os.path.abspath(tel))
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        logger.exception("flight recorder: cannot create %s", d)
        return None
    return os.path.join(d, f"flight_p{os.getpid()}.json")


def dump_flight(reason: str = "", error: Optional[BaseException] = None,
                telemetry_path: Optional[str] = None,
                extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Best-effort black-box dump of the process ring; returns the path,
    or None when no dump directory resolves.  Never raises — this runs
    on teardown paths that must still re-raise the original error."""
    path = flight_dump_path(telemetry_path)
    if path is None:
        return None
    try:
        return _RECORDER.dump(path, reason=reason, error=error, extra=extra)
    except Exception:  # noqa: BLE001 - teardown path must not die
        logger.exception("flight recorder: dump to %s failed", path)
        return None
