"""Bucketed, graph-captured batch-inference engine over a packed model
(PyTorch port of ``serving/engine.py``, with the same constructor, methods,
events and ``stats()`` keys).

Serving traffic is many small requests of arbitrary row counts: each one
would pay a full round of kernel launches from the host, and each novel
size would allocate anew.  :class:`InferenceEngine` fixes both:

- **Shape buckets**: requests are zero-padded into a fixed set of
  power-of-two row buckets.  For every (method, bucket, tier) the engine
  captures one CUDA graph at warmup (warm-up runs, then
  ``torch.cuda.graph``, on the process's capture stream), over a static padded input ``[bucket, d]`` into
  which each request is copied and zero-padded on the host; a request is
  then one graph replay.  Steady-state serving captures nothing:
  ``stats()["compiles_since_warmup"]`` (graph captures and kernel builds,
  ``telemetry/events.note_compile``) stays 0 after :meth:`warmup`.  A
  graph that fails to capture raises; nothing falls back to eager
  launches on the card.
- **One copy of the request**: the static input buffer is the only
  device copy of a request (``donate`` is accepted and reported for the
  JAX package's API; on the card the buffer is reused by construction).
- **Micro-batching**: ``submit()`` returns a ``Future`` and a background
  worker coalesces queued requests into one replay, up to
  ``max_batch_size`` rows or ``max_delay_ms`` of waiting.

A captured graph writes one static output, so a replay is not reentrant
the way a JAX executable is: each graph replays under its own lock, and
its output is copied to the host before the lock is released.
``clone()`` replicas share the graphs (warm once) and their locks.
Captures are serialized process-wide, run on one stream per device
(:func:`capture_stream`) and in the ``"thread_local"`` error mode, so an
engine can warm while other engines serve and a fit runs on another
stream (:func:`side_stream`) of the same card (the registry warms
refreshed models under live fleet traffic); :meth:`release` drops the
graphs and frees their memory.

On ``device="cpu"`` the engine runs the same padded-bucket path eagerly,
with no graph: that path exists for the tests.

With the packed model's ``quality`` sidecar, the full-model graphs also
count a per-feature bin histogram of the padded rows
(``ops/binning.bin_occupancy``, an integer scatter with no host sync,
captured into the same graph), and a :class:`DriftMonitor` scores it in
windows, subtracting the zero pad rows exactly.

Every request emits a ``request_served`` event (latency, rows, bucket,
padding utilization, queue depth) through the telemetry sinks, and
per-engine counters and histograms land in
``telemetry.global_metrics()``.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_ensemble_tpu_torch.models.base import capture_program_work, program_call
from spark_ensemble_tpu_torch.ops.binning import Bins, bin_occupancy
from spark_ensemble_tpu_torch.serving.export import PackedModel, pack
from spark_ensemble_tpu_torch.telemetry.events import (
    compile_snapshot,
    emit_event,
    global_metrics,
    note_compile,
    serving_stream_id,
)
from spark_ensemble_tpu_torch.telemetry.quality import DriftMonitor
from spark_ensemble_tpu_torch.telemetry.trace import Tracer

__all__ = ["InferenceEngine"]

_SHUTDOWN = object()

#: eager runs on the side stream before a capture (allocator warm-up, and
#: the lazy initialization some kernels do on first use)
_CAPTURE_WARMUP_RUNS = 2

#: one capture at a time in the process.  Captures run in the
#: "thread_local" error mode, so other threads may replay graphs, copy
#: results to the host, allocate and launch (a refresh fit) meanwhile; but
#: ``torch.cuda.graph`` synchronizes the device before it begins, which
#: must never land inside another thread's capture.
_CAPTURE_LOCK = threading.Lock()

#: the one stream per device that captures (and their warm-up runs) go on
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_STREAMS_LOCK = threading.Lock()


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream every graph capture on ``device`` runs on, made once per
    process from PyTorch's high-priority stream pool.  A capture takes in
    whatever any thread queues on its stream, so work that runs beside
    captures (a refresh fit) must go on another stream:
    :func:`side_stream` makes one."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _STREAMS_LOCK:
        stream = _CAPTURE_STREAMS.get(index)
        if stream is None:
            stream = torch.cuda.Stream(device=device, priority=-1)
            _CAPTURE_STREAMS[index] = stream
        return stream


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """A stream of PyTorch's default-priority pool on ``device`` that is
    never :func:`capture_stream`'s.  The two pools are disjoint on a card
    with stream priorities; where the pools coincide, the pool hands its
    streams out round robin, so the next draw is another stream."""
    avoid = capture_stream(device).cuda_stream
    for _ in range(2):
        stream = torch.cuda.Stream(device=device)
        if stream.cuda_stream != avoid:
            return stream
    raise RuntimeError("the CUDA stream pool gave the capture stream twice running")


def _pow2_buckets(min_bucket: int, max_bucket: int) -> Tuple[int, ...]:
    out = []
    b = 1 << max(0, int(min_bucket) - 1).bit_length()
    while b < max_bucket:
        out.append(b)
        b <<= 1
    out.append(1 << max(0, int(max_bucket) - 1).bit_length())
    return tuple(sorted(set(out)))


class _Program:
    """One (method, bucket, tier) program: ``fn`` over a static padded
    input ``[bucket, d]``, captured as a CUDA graph on the card or run
    eagerly on the CPU.  ``run(X)`` copies the padded request in, runs,
    and returns host numpy copies of the outputs, under ``lock``.  Each
    run is one call of the program ``tag`` (``models/base.program_call``);
    a replay passes through no kernel wrapper, so it reports the work its
    capture recorded (``work``)."""

    def __init__(self, fn: Callable, bucket: int, d: int, device: torch.device,
                 tag: str):
        self.fn = fn
        self.tag = tag
        self.device = device
        self.lock = threading.Lock()
        self.x = torch.zeros((bucket, d), dtype=torch.float32, device=device)
        self.graph = None
        self.out = None
        self.work = None
        if device.type == "cuda":
            with _CAPTURE_LOCK:
                side = capture_stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    for _ in range(_CAPTURE_WARMUP_RUNS):
                        fn(self.x)
                torch.cuda.current_stream(device).wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                # only this thread is held to the capture's rules: fleet
                # workers replaying other graphs and a refresh fit on a
                # stream of its own (side_stream) go on while this graph
                # captures
                with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                    with capture_program_work(tag) as captured:
                        self.out = fn(self.x)
                self.work = None if captured is None else captured.work

    def run(self, Xp: np.ndarray) -> Tuple[np.ndarray, ...]:
        with self.lock:
            self.x.copy_(torch.from_numpy(Xp))
            with program_call(self.tag, self.x, work=self.work):
                if self.graph is not None:
                    self.graph.replay()
                    out = self.out
                else:
                    out = self.fn(self.x)
            # copied out before the lock is released: the next replay
            # overwrites the static outputs
            return tuple(t.cpu().numpy() for t in out)


class _Request:
    __slots__ = ("X", "n", "single", "future", "t_submit")

    def __init__(self, X, n, single, future, t_submit):
        self.X = X
        self.n = n
        self.single = single
        self.future = future
        self.t_submit = t_submit


class InferenceEngine:
    """Serve a fitted or packed model through fixed power-of-two batch
    buckets with graph-captured programs and an optional micro-batching
    queue.

    Parameters
    ----------
    model:
        A fitted model (packed automatically) or a :class:`PackedModel`;
        the engine serves on its device.
    methods:
        Model entry points to serve (``"predict"``, ``"predict_proba"``,
        ``"predict_raw"``).  Every configured method is captured for every
        bucket at :meth:`warmup`; calling an unconfigured method raises
        rather than capturing mid-serve.
    min_bucket / max_batch_size:
        Smallest and largest bucket row counts; buckets are the powers of
        two spanning them.  Requests larger than the top bucket are served
        in top-bucket chunks.
    max_delay_ms:
        Micro-batching window: how long the queue worker waits to coalesce
        more requests once one is pending.
    prefix_tiers:
        Ensemble-prefix member counts to capture as degraded tiers (see
        :meth:`PackedModel.take`): ``predict(..., tier=k)`` serves the
        first-k-member prefix through its own pre-captured graphs.
    donate:
        Accepted for the JAX package's API and reported in ``stats()``;
        default on for the card, off for the CPU.  The static input buffer
        is the one device copy of a request either way.
    warm:
        Capture and run every (method, bucket, tier) program at
        construction; pass ``False`` to warm explicitly later.
    drift / drift_window / drift_monitor:
        On-device feature-drift sketching (``telemetry/quality.py``).
        ``drift=None`` enables it exactly when the packed model carries
        its fit-time bin reference (``PackedModel.quality``);
        ``drift_monitor`` injects a shared monitor.
    """

    def __init__(
        self,
        model,
        *,
        methods: Tuple[str, ...] = ("predict",),
        min_bucket: int = 8,
        max_batch_size: int = 4096,
        max_delay_ms: float = 2.0,
        donate: Optional[bool] = None,
        warm: bool = True,
        label: str = "engine",
        telemetry_path: Optional[str] = None,
        prefix_tiers: Tuple[int, ...] = (),
        drift: Optional[bool] = None,
        drift_window: int = 2048,
        drift_monitor: Optional[DriftMonitor] = None,
    ):
        self._packed = model if isinstance(model, PackedModel) else pack(model)
        if self._packed.num_features <= 0:
            raise ValueError(
                "packed model reports no num_features; cannot size buckets"
            )
        self._methods = tuple(methods)
        for m in self._methods:
            if m not in ("predict", "predict_proba", "predict_raw"):
                raise ValueError(f"unknown serve method {m!r}")
        self._device = self._packed.device
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the packed model lives on CUDA but torch.cuda.is_available() "
                "is False; load it with device='cpu' to serve on the CPU"
            )
        self._buckets = _pow2_buckets(min_bucket, max_batch_size)
        self._max_batch = self._buckets[-1]
        self._max_delay_s = float(max_delay_ms) / 1000.0
        if donate is None:
            donate = self._device.type != "cpu"
        self._donate = bool(donate)
        self._label = label
        self._telemetry_path = telemetry_path
        self._stream = serving_stream_id(label)
        self._tracer = Tracer(self._emit_trace, thread=label)
        self._lock = threading.Lock()
        self._compiled: Dict[Tuple, _Program] = {}
        self._compile_s: Dict[Tuple, float] = {}
        # the live models the programs close over, rebuilt once over the
        # packed tensors on the device (prefix tiers from take(k), whose
        # bit-identity to a k-round fit is PackedModel.take's contract)
        self._prefix_tiers = tuple(sorted({int(k) for k in prefix_tiers}))
        self._models: Dict[int, Any] = {0: self._packed.model()}
        for k in self._prefix_tiers:
            self._models[k] = self._packed.take(k).model()
        quality = self._packed.quality
        if drift is None:
            drift = quality is not None
        if drift and quality is None:
            raise ValueError(
                "drift=True but the packed model carries no fit-time drift "
                "reference (PackedModel.quality is None); re-pack from a "
                "fit that captured one, or pass drift=False"
            )
        self._drift_enabled = bool(drift)
        self._bins = None
        if self._drift_enabled:
            self._bins = Bins(thresholds=torch.as_tensor(
                quality["thresholds"], dtype=torch.float32, device=self._device))
        self._drift = drift_monitor
        self._drift_owner = False
        if self._drift_enabled and self._drift is None:
            self._drift = DriftMonitor(
                quality["thresholds"],
                quality["occupancy"],
                window_rows=drift_window,
                stream=self._stream,
                telemetry_path=telemetry_path,
            )
            self._drift_owner = True
        self._metrics = global_metrics()
        self._queue: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self._worker: Optional[threading.Thread] = None
        self._stopped = False
        self._warm_snapshot = compile_snapshot()
        if warm:
            self.warmup()

    # -- capture -----------------------------------------------------------

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    @property
    def prefix_tiers(self) -> Tuple[int, ...]:
        return self._prefix_tiers

    @property
    def packed(self) -> PackedModel:
        return self._packed

    @property
    def drift_monitor(self) -> Optional[DriftMonitor]:
        """The live drift monitor (shared across clones), or ``None`` when
        sketching is disabled."""
        return self._drift

    def clone(self, label: str) -> "InferenceEngine":
        """A replica over the SAME captured graphs and device tensors: its
        own queue, worker thread and telemetry stream, but the program map
        (graphs and their replay locks) is shared, so N replicas warm
        once."""
        eng = InferenceEngine.__new__(InferenceEngine)
        eng.__dict__.update(self.__dict__)
        eng._label = label
        eng._stream = serving_stream_id(label)
        eng._tracer = Tracer(eng._emit_trace, thread=label)
        eng._lock = threading.Lock()
        eng._drift_owner = False  # shared: replicas fold into one stream
        eng._queue = queue_mod.SimpleQueue()
        eng._worker = None
        eng._stopped = False
        eng._warm_snapshot = compile_snapshot()
        return eng

    def bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._max_batch

    def _emit_trace(self, rec: Dict[str, Any]) -> None:
        # span records ride the same standalone-event sinks as
        # engine_warmup/request_served, tagged with this engine's stream
        rec = dict(rec)
        emit_event(
            rec.pop("event"), path=self._telemetry_path,
            fit_id=self._stream, **rec,
        )

    def _tier_key(self, method: str, bucket: int, tier: int):
        # full-model programs keep the (method, bucket) key; prefix tiers
        # append k
        return (method, bucket) if not tier else (method, bucket, tier)

    def _compile(self, method: str, bucket: int, tier: int = 0) -> _Program:
        key = self._tier_key(method, bucket, tier)
        with self._lock:
            prog = self._compiled.get(key)
        if prog is not None:
            return prog
        model = self._models[tier]
        # drift sketching rides ONLY the full-model programs: tier replays
        # (staged attribution) re-serve rows the tier-0 path counted
        bins = self._bins if not tier else None
        predict = getattr(model, method)

        def fn(X):
            out = predict(X)
            if bins is None:
                return (out,)
            return out, bin_occupancy(X, bins)

        wall0 = time.time()
        t0 = time.perf_counter()
        prog = _Program(fn, bucket, self._packed.num_features, self._device,
                        tag=f"engine:{method}" + (f":tier{tier}" if tier else ""))
        compile_s = time.perf_counter() - t0
        with self._lock:
            won = self._compiled.setdefault(key, prog)
            if won is prog:
                self._compile_s[key] = compile_s
        if won is prog:
            if prog.graph is not None:
                note_compile(compile_s)
            emit_event(
                "engine_warmup",
                path=self._telemetry_path,
                fit_id=self._stream,
                method=method,
                bucket=int(bucket),
                tier=int(tier),
                compile_s=compile_s,
            )
            self._tracer.emit_span(
                "engine_warmup", wall0, compile_s,
                method=method, bucket=int(bucket), tier=int(tier),
            )
        return won

    def warmup(self, methods: Optional[Tuple[str, ...]] = None) -> "InferenceEngine":
        """Capture every (method, bucket, tier) program and run each once
        on zeros, then snapshot the compile counters:
        ``stats()['compiles_since_warmup']`` counts from here."""
        d = self._packed.num_features
        for method in methods or self._methods:
            for b in self._buckets:
                for tier in (0,) + self._prefix_tiers:
                    self._compile(method, b, tier).run(
                        np.zeros((b, d), np.float32))
        self._warm_snapshot = compile_snapshot()
        return self

    # -- synchronous serving ----------------------------------------------

    def _normalize(self, X) -> Tuple[np.ndarray, bool]:
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        Xa = np.asarray(X, np.float32)
        single = Xa.ndim == 1
        if single:
            Xa = Xa[None, :]
        if Xa.ndim != 2 or Xa.shape[1] != self._packed.num_features:
            raise ValueError(
                f"request shape {np.shape(X)} does not match model "
                f"num_features={self._packed.num_features}"
            )
        return Xa, single

    def _run_padded(self, method: str, Xa: np.ndarray, tier: int = 0):
        """One program run: host-side zero-pad to the bucket, copy into the
        static input, replay, copy out, slice the real rows."""
        n = Xa.shape[0]
        b = self.bucket_for(n)
        key = self._tier_key(method, b, tier)
        prog = self._compiled.get(key) or self._compile(method, b, tier)
        if n < b:
            buf = np.zeros((b, Xa.shape[1]), np.float32)
            buf[:n] = Xa
            Xa = buf
        outs = prog.run(np.ascontiguousarray(Xa))
        if self._drift_enabled and not tier:
            out, hist = outs
            if self._drift is not None:
                # pad rows are subtracted inside the monitor
                self._drift.observe(hist, pad_rows=b - n)
            return out[:n], b
        return outs[0][:n], b

    def _serve_rows(self, method: str, Xa: np.ndarray, tier: int = 0):
        """Serve up to any row count: top-bucket chunks + one padded tail.
        Returns host arrays."""
        n = Xa.shape[0]
        if n <= self._max_batch:
            return self._run_padded(method, Xa, tier)
        outs = []
        for i in range(0, n, self._max_batch):
            out, _ = self._run_padded(method, Xa[i : i + self._max_batch], tier)
            outs.append(out)
        return np.concatenate(outs, axis=0), self._max_batch

    def _check_method(self, method: str, tier: int = 0):
        if not self._models:
            raise RuntimeError(
                f"engine {self._label!r} was released (evicted or removed "
                "from its registry); build a new engine to serve again"
            )
        if method not in self._methods:
            raise ValueError(
                f"engine was not configured to serve {method!r} "
                f"(methods={self._methods}); construct with "
                f"methods=(..., {method!r}) so it warms"
            )
        if tier and tier not in self._prefix_tiers:
            raise ValueError(
                f"engine has no prefix tier {tier} "
                f"(prefix_tiers={self._prefix_tiers}); construct with "
                f"prefix_tiers=(..., {tier}) so it warms"
            )

    def _record(self, method: str, rows: int, bucket: int, latency_s: float,
                queue_depth: int, batch_rows: int, source: str,
                tier: int = 0) -> None:
        util = batch_rows / bucket if bucket else 0.0
        emit_event(
            "request_served",
            path=self._telemetry_path,
            fit_id=self._stream,
            method=method,
            rows=int(rows),
            bucket=int(bucket),
            batch_rows=int(batch_rows),
            bucket_utilization=util,
            latency_ms=latency_s * 1e3,
            queue_depth=int(queue_depth),
            source=source,
            tier=int(tier),
        )
        self._metrics.counter("serving/requests").inc()
        self._metrics.counter("serving/rows").inc(int(rows))
        self._metrics.histogram("serving/latency_ms").record(latency_s * 1e3)
        self._metrics.histogram("serving/bucket_utilization").record(util)
        self._metrics.gauge("serving/queue_depth").set(queue_depth)

    def predict(self, X, method: str = "predict", tier: int = 0) -> np.ndarray:
        """Synchronous bucketed inference -> host array; the result is on
        the host before the latency is recorded.  ``tier=k`` serves
        through the pre-captured first-k-member prefix."""
        self._check_method(method, tier)
        t0 = time.perf_counter()
        Xa, single = self._normalize(X)
        out, bucket = self._serve_rows(method, Xa, tier)
        self._record(
            method, Xa.shape[0], bucket, time.perf_counter() - t0,
            queue_depth=0, batch_rows=Xa.shape[0], source="sync", tier=tier,
        )
        return out[0] if single else out

    def predict_proba(self, X) -> np.ndarray:
        return self.predict(X, method="predict_proba")

    def predict_raw(self, X) -> np.ndarray:
        return self.predict(X, method="predict_raw")

    # -- micro-batching queue ---------------------------------------------

    def submit(self, X, method: str = "predict", tier: int = 0) -> Future:
        """Queue a request; a background worker coalesces pending requests
        into one replay (up to ``max_batch_size`` rows or
        ``max_delay_ms`` of waiting) and resolves each caller's Future with
        its own rows.  Requests only coalesce within a (method, tier)."""
        self._check_method(method, tier)
        if self._stopped:
            raise RuntimeError("engine is stopped")
        Xa, single = self._normalize(X)
        fut: Future = Future()
        req = _Request(Xa, Xa.shape[0], single, fut, time.perf_counter())
        self._ensure_worker()
        self._queue.put(((method, tier), req))
        return fut

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop,
                    name=f"se-torch-{self._label}",
                    daemon=True,
                )
                self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=0.2)
            except queue_mod.Empty:
                if self._stopped:
                    return
                continue
            if item is _SHUTDOWN:
                return
            key, first = item
            batch = [first]
            rows = first.n
            deadline = time.perf_counter() + self._max_delay_s
            while rows < self._max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue_mod.Empty:
                    break
                if item is _SHUTDOWN:
                    self._serve_batch(key, batch)
                    return
                nxt_key, req = item
                if nxt_key != key:
                    # a (method, tier) switch flushes the coalesced batch
                    self._serve_batch(key, batch)
                    key, batch, rows = nxt_key, [req], req.n
                    deadline = time.perf_counter() + self._max_delay_s
                    continue
                batch.append(req)
                rows += req.n
            self._serve_batch(key, batch)

    def _serve_batch(self, key: Tuple[str, int], batch: List[_Request]) -> None:
        method, tier = key
        try:
            depth = len(batch)
            Xa = (
                batch[0].X
                if depth == 1
                else np.concatenate([r.X for r in batch], axis=0)
            )
            out, bucket = self._serve_rows(method, Xa, tier)
            now = time.perf_counter()
            offset = 0
            for r in batch:
                part = out[offset : offset + r.n]
                offset += r.n
                self._record(
                    method, r.n, bucket, now - r.t_submit,
                    queue_depth=depth, batch_rows=Xa.shape[0], source="queue",
                    tier=tier,
                )
                r.future.set_result(part[0] if r.single else part)
        except Exception as e:  # resolve every caller, never hang a Future
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    # -- lifecycle / introspection ----------------------------------------

    def stop(self) -> None:
        """Drain and stop the queue worker (idempotent)."""
        self._stopped = True
        if self._drift_owner and self._drift is not None:
            self._drift.close()
        worker = self._worker
        if worker is not None and worker.is_alive():
            self._queue.put(_SHUTDOWN)
            if worker is not threading.current_thread():
                worker.join(timeout=5.0)

    def release(self) -> None:
        """Stop this engine, then drop the captured graphs (and with them
        their private memory pools), the static buffers and the live
        models over the packed tensors, which this engine and every clone
        of it share: their device memory frees at once.  The registry's
        eviction and removal call it.  Serving afterwards raises."""
        self.stop()
        with self._lock:
            self._compiled.clear()
            self._compile_s.clear()
            self._models.clear()

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stats(self) -> Dict[str, Any]:
        """Warmup + steady-state counters; ``compiles_since_warmup`` must
        stay 0 on a warmed engine."""
        c, s = compile_snapshot()
        with self._lock:
            compiled = {
                (f"{k[0]}@{k[1]}" if len(k) == 2 else f"{k[0]}@{k[1]}~{k[2]}"):
                    self._compile_s.get(k)
                for k in sorted(self._compiled)
            }
        return {
            "buckets": self._buckets,
            "methods": self._methods,
            "prefix_tiers": self._prefix_tiers,
            "donate": self._donate,
            "compiled": compiled,
            "compiles_since_warmup": c - self._warm_snapshot[0],
            "compile_s_since_warmup": s - self._warm_snapshot[1],
            "packed_bytes": self._packed.nbytes,
            "drift_enabled": self._drift_enabled,
            "drift": (
                self._drift.snapshot() if self._drift is not None else None
            ),
        }
