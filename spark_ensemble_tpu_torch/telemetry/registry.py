"""Metric primitives: counters, gauges, streaming histograms, round timers
(PyTorch port of ``telemetry/registry.py``).

``MetricsRegistry`` is the process-local home for numeric telemetry
(per-round times, kernel-build counts, memory high-water marks): cheap
enough to update per round, thread-safe because
``StackingClassifier(parallelism>1)`` fits members from a thread pool.

PyTorch launches CUDA work asynchronously, so ``perf_counter()`` after a
call measures the launch, not the work.  ``RoundTimer.stop(*fence)``
first waits on the streams of every CUDA tensor reachable from the fence
objects (``utils/instrumentation.block_on_arrays``: one event per device's
current stream) and only then reads the clock; CPU tensors need no fence.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from spark_ensemble_tpu_torch.utils.instrumentation import block_on_arrays

__all__ = [
    "Counter",
    "Gauge",
    "StreamingHistogram",
    "RoundTimer",
    "MetricsRegistry",
]


class Counter:
    """Monotonically increasing count (e.g. kernel builds per process)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar (e.g. current device bytes_in_use)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class StreamingHistogram:
    """Fixed log2-bucketed streaming histogram: O(1) record, no sample
    retention, quantiles answered from bucket edges.  The span covers
    microseconds-to-hours of seconds-denominated durations and byte counts
    up to ~1 TiB; values outside clamp into the edge buckets."""

    _MIN_EXP = -20  # 2**-20 ~ 1e-6
    _MAX_EXP = 40  # 2**40  ~ 1e12

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        nbuckets = self._MAX_EXP - self._MIN_EXP + 1
        self._buckets = [0] * nbuckets
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _bucket_index(self, value: float) -> int:
        if value <= 0:
            return 0
        e = int(math.floor(math.log2(value)))
        return min(max(e - self._MIN_EXP, 0), len(self._buckets) - 1)

    def record(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._buckets[self._bucket_index(value)] += 1
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Upper-edge estimate of the ``q`` quantile (exact for the min/max
        of a one-bucket population; otherwise within a 2x bucket width)."""
        with self._lock:
            if self._count == 0:
                return None
            target = q * self._count
            seen = 0
            for idx, c in enumerate(self._buckets):
                seen += c
                if seen >= target:
                    return min(
                        float(2.0 ** (idx + self._MIN_EXP + 1)), self._max
                    )
            return self._max

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            if self._count == 0:
                return {"type": "histogram", "count": 0}
            mean = self._sum / self._count
            mn, mx, cnt, sm = self._min, self._max, self._count, self._sum
        return {
            "type": "histogram",
            "count": cnt,
            "sum": sm,
            "min": mn,
            "max": mx,
            "mean": mean,
            "p50": self.quantile(0.5),
            "p90": self.quantile(0.9),
            "p99": self.quantile(0.99),
        }

    def snapshot(self) -> Dict[str, Any]:
        return self.summary()


class RoundTimer:
    """Monotonic round timer whose ``stop`` fences on device work.

    ``start()`` reads ``perf_counter``; ``stop(*fence)`` first waits on
    the CUDA work behind every tensor reachable from the fence objects:
    without the fence, asynchronous launches make the elapsed time the cost
    of ENQUEUEING the round, not running it (the same reason
    ``instrumented_fit`` fences before closing a profiler trace).  Durations stream into a histogram, so the
    registry answers "p99 round time" without retaining per-round samples.
    """

    def __init__(self, name: str, histogram: StreamingHistogram):
        self.name = name
        self.histogram = histogram
        self._t0: Optional[float] = None

    def start(self) -> float:
        self._t0 = time.perf_counter()
        return self._t0

    def stop(self, *fence: Any) -> float:
        if self._t0 is None:
            raise RuntimeError(f"RoundTimer {self.name!r} stopped before start")
        if fence:
            block_on_arrays(list(fence))
        elapsed = time.perf_counter() - self._t0
        self._t0 = None
        self.histogram.record(elapsed)
        return elapsed

    def time(self, fn, *args, fence_result: bool = True, **kwargs):
        """Run ``fn`` under the timer; fences on its result by default."""
        self.start()
        result = fn(*args, **kwargs)
        self.stop(result if fence_result else ())
        return result


class MetricsRegistry:
    """Named get-or-create home for metrics; one instance per concern
    (the telemetry events module keeps a process-global one)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._sources: Dict[str, Any] = {}

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str) -> StreamingHistogram:
        return self._get_or_create(
            name, StreamingHistogram, lambda: StreamingHistogram(name)
        )

    def timer(self, name: str) -> RoundTimer:
        """A fresh timer over the (shared) histogram registered under
        ``name`` — timers hold in-flight start state, so unlike the other
        metric kinds they are NOT shared between callers."""
        return RoundTimer(name, self.histogram(name))

    def register_source(self, name: str, fn) -> None:
        """Register a LIVE snapshot source: ``fn()`` returns a JSON-ready
        value rendered into :meth:`snapshot` under ``name`` — how
        long-lived stateful objects (a ``FleetRouter``'s SLO counters)
        surface through the one-stop process snapshot without mirroring
        every update into counters.  Re-registering a name replaces the
        source; the owner unregisters on shutdown."""
        with self._lock:
            self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Point-in-time values of every metric plus every registered
        live source, JSON-ready.  Source callables run OUTSIDE the
        registry lock (they may take their owner's lock); a source that
        raises reports its error instead of poisoning the snapshot."""
        with self._lock:
            items: List[Tuple[str, Any]] = sorted(self._metrics.items())
            sources: List[Tuple[str, Any]] = sorted(self._sources.items())
        out = {name: m.snapshot() for name, m in items}
        for name, fn in sources:
            try:
                out[name] = {"type": "source", "value": fn()}
            except Exception as e:  # noqa: BLE001 - snapshot must not die
                out[name] = {
                    "type": "source",
                    "error": f"{type(e).__name__}: {e}",
                }
        return out
