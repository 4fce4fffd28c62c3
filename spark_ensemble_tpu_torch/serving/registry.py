"""Multi-model serving registry with LRU eviction of device buffers
(PyTorch port of ``serving/registry.py``, with the same methods, events
and ``stats()`` keys).

A serving process typically hosts more models than fit on the card at
once (per-tenant models, A/B variants, rollback generations).
:class:`ModelRegistry` keeps every registered model's packed form and at
most ``capacity`` of them *active* -- live on their device with a warmed
:class:`InferenceEngine`.  Each entry serves on the device of the model it
was given (CUDA unless the caller packed on the CPU).  Activating a model
beyond capacity offloads the least-recently-used one: its engine stops and
releases its CUDA graphs, static buffers and live models
(:meth:`InferenceEngine.release`), and its :class:`PackedModel` arrays move
back to host memory, so ``torch.cuda.memory_allocated()`` falls by at
least the entry's packed bytes; next use re-uploads and re-captures.

Thread-safe throughout — request threads race on ``engine()``/``predict()``
the way serving frontends do.  Evictions emit ``model_evicted`` telemetry
events; per-model request events come from the engines themselves.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional

from spark_ensemble_tpu_torch.serving.engine import InferenceEngine
from spark_ensemble_tpu_torch.serving.export import PackedModel, pack
from spark_ensemble_tpu_torch.telemetry.events import (
    emit_event,
    global_metrics,
    serving_stream_id,
)

__all__ = ["ModelRegistry"]


class _Entry:
    __slots__ = (
        "packed", "engine", "opts", "hits", "activations", "last_used",
        "pins", "pending_offload", "pending_remove",
    )

    def __init__(self, packed: PackedModel, opts: Dict[str, Any]):
        self.packed = packed
        self.engine: Optional[InferenceEngine] = None
        self.opts = opts
        self.hits = 0
        self.activations = 0
        self.last_used = 0.0
        # in-flight requests holding this version's device buffers: LRU
        # eviction (or explicit evict/rollback) defers while pins > 0, so a
        # hot-swap can never free arrays out from under an unsent reply
        self.pins = 0
        self.pending_offload = False
        self.pending_remove = False


class ModelRegistry:
    """Thread-safe name -> model registry serving through per-model
    :class:`InferenceEngine` instances, keeping at most ``capacity`` models
    device-resident (LRU eviction; see module docstring).

    ``engine_opts`` (and per-``register`` overrides) are forwarded to every
    :class:`InferenceEngine` the registry constructs."""

    def __init__(
        self,
        capacity: int = 4,
        *,
        telemetry_path: Optional[str] = None,
        **engine_opts,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self._capacity = int(capacity)
        self._telemetry_path = telemetry_path
        self._engine_opts = dict(engine_opts)
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._stream = serving_stream_id("registry")
        self._metrics = global_metrics()

    # -- membership --------------------------------------------------------

    def register(self, name: str, model, *, warm: bool = False, **engine_opts):
        """Register a fitted model or :class:`PackedModel` under ``name``
        (packing live models on the spot, on their device).  Registration
        captures nothing by default; pass ``warm=True`` to activate (device
        upload + graph capture) immediately."""
        packed = model if isinstance(model, PackedModel) else pack(model)
        with self._lock:
            if name in self._entries:
                raise ValueError(
                    f"model {name!r} is already registered (remove() first)"
                )
            opts = dict(self._engine_opts)
            opts.update(engine_opts)
            self._entries[name] = _Entry(packed, opts)
        if warm:
            self.engine(name)
        return self

    def remove(self, name: str) -> None:
        """Unregister ``name``.  A removal racing a live pin lease (a
        :class:`FleetRouter` / shadow engine, or a queued ``submit()``
        reply) DEFERS like ``_offload``: the entry leaves the name space
        immediately from the caller's point of view after the last pin
        releases, and the engine is only stopped once no in-flight request
        can still be computing on its buffers — popping eagerly here used
        to orphan the entry (``_release`` found nothing and the engine
        leaked, running, forever)."""
        with self._lock:
            entry = self._entries[name]
            if entry.pins > 0:
                # a lease still holds this version's device buffers:
                # _release() completes the removal at pin zero
                entry.pending_remove = True
                return
            del self._entries[name]
            engine, entry.engine = entry.engine, None
        if engine is not None:
            engine.release()

    def names(self):
        with self._lock:
            return list(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- serving -----------------------------------------------------------

    def engine(self, name: str) -> InferenceEngine:
        """The warmed engine for ``name`` (most-recently-used); activates
        the model if offloaded and LRU-evicts over-capacity residents."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(
                    f"no model {name!r} registered "
                    f"(registered: {sorted(self._entries)})"
                )
            self._entries.move_to_end(name)
            entry.hits += 1
            entry.last_used = time.time()
            if entry.engine is None:
                entry.packed.ensure_device()
                entry.engine = InferenceEngine(
                    entry.packed,
                    warm=True,
                    label=f"registry:{name}",
                    telemetry_path=self._telemetry_path,
                    **entry.opts,
                )
                entry.activations += 1
                self._metrics.counter("serving/activations").inc()
                self._evict_over_capacity()
            return entry.engine

    def _acquire(self, name: str) -> InferenceEngine:
        with self._lock:
            engine = self.engine(name)
            self._entries[name].pins += 1
            return engine

    def _release(self, name: str) -> None:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:  # removed while in flight; nothing to free
                return
            entry.pins = max(entry.pins - 1, 0)
            if entry.pins == 0 and entry.pending_remove:
                # complete the deferred remove(); engine.release() is safe
                # under the RLock (idempotent, self-join guarded)
                entry.pending_remove = False
                del self._entries[name]
                engine, entry.engine = entry.engine, None
                if engine is not None:
                    engine.release()
                return
            if entry.pins == 0 and entry.pending_offload:
                entry.pending_offload = False
                if entry.engine is not None:
                    self._offload(name)

    @contextlib.contextmanager
    def lease(self, name: str):
        """The warmed engine for ``name``, pinned against eviction for the
        duration of the ``with`` block: a hot-swap/rollback that evicts
        this version mid-request defers its offload until the last lease
        is released (i.e. the reply was sent)."""
        engine = self._acquire(name)
        try:
            yield engine
        finally:
            self._release(name)

    def predict(self, name: str, X, method: str = "predict"):
        with self.lease(name) as engine:
            return engine.predict(X, method=method)

    def submit(self, name: str, X, method: str = "predict"):
        engine = self._acquire(name)
        try:
            fut = engine.submit(X, method=method)
        except BaseException:
            self._release(name)
            raise
        # the version stays pinned until the reply is delivered — the
        # done-callback runs after set_result/set_exception, when the
        # caller's rows are already materialized host-side
        fut.add_done_callback(lambda _f: self._release(name))
        return fut

    # -- eviction ----------------------------------------------------------

    def _resident(self):
        return [
            (n, e) for n, e in self._entries.items() if e.engine is not None
        ]

    def _evict_over_capacity(self) -> None:
        # called under self._lock; OrderedDict is LRU-ordered by move_to_end
        resident = self._resident()
        while len(resident) > self._capacity:
            name, _ = resident.pop(0)
            self._offload(name)

    def _offload(self, name: str) -> None:
        entry = self._entries[name]
        if entry.pins > 0:
            # a request resolved against this version and has not replied
            # yet: defer — _release() completes the offload at pin zero
            entry.pending_offload = True
            return
        engine, entry.engine = entry.engine, None
        if engine is not None:
            # the graphs' pools, static buffers and the live models over
            # the packed tensors go with the engine and every clone of it
            engine.release()
        freed = entry.packed.nbytes
        entry.packed.offload()
        self._metrics.counter("serving/evictions").inc()
        emit_event(
            "model_evicted",
            path=self._telemetry_path,
            fit_id=self._stream,
            model=name,
            bytes_freed=freed,
        )

    def evict(self, name: str) -> None:
        """Explicitly offload ``name``'s device buffers (it stays
        registered; next use re-activates)."""
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"no model {name!r} registered")
            if self._entries[name].engine is not None:
                self._offload(name)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            for entry in self._entries.values():
                if entry.engine is not None:
                    entry.engine.release()
                    entry.engine = None

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                name: {
                    "resident": e.engine is not None,
                    "pins": e.pins,
                    "pending_remove": e.pending_remove,
                    "hits": e.hits,
                    "activations": e.activations,
                    "last_used": e.last_used,
                    "bytes": e.packed.nbytes,
                }
                for name, e in self._entries.items()
            }
