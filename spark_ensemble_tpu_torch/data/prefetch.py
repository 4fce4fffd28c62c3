"""Shard prefetch for the streaming fit (PyTorch port of
``data/prefetch.py``).

Worker threads (``prefetch_depth`` of them; the JAX package runs one)
read shard files from disk while the device works on the current shard:
the round loop's host I/O hides behind device compute instead of
serializing with it. A read is one ``readinto`` and one zip CRC, both
outside the interpreter lock (``data/shards._read_packed``), so the
workers read in parallel with each other and with the consumer's
launches. The schedule is the consumer's by construction: every sweep
walks shards ``0..S-1`` in order and sweeps repeat back-to-back
(``max_depth + 1`` sweeps a round), so the prefetcher keeps the next
``prefetch_depth`` indices of the cyclic order in flight.

Threading contract: the worker threads only touch numpy and file I/O.
Every torch call runs on the consumer thread inside ``sweep()``.  On CUDA
the consumer copies each shard into one of two pinned host buffers and
from there to the card on a side stream; the compute stream waits on the
copy's event, and the shard's device tensor is recorded on the compute
stream, so the allocator cannot hand its memory out again while a kernel
still reads it.  A pinned buffer is refilled only after its previous copy's
event has completed.  The histogram products stay on the compute stream,
where the resident stream tier runs them.

Abandon-safety: a sweep generator may die mid-round (a chaos preemption, a
retry unwinding the round).  In-flight futures are keyed by shard index,
not by queue position, so the next sweep reconciles against whatever is
already loading: shard content is immutable, a loaded shard is valid
whenever it arrives.

Telemetry, all on the consumer thread: each shard's I/O is mirrored into
the process-wide registry (``data/shard_*`` counters and histograms of
``telemetry.global_metrics()``), and with the fit's telemetry the
consumer's wait is charged to ``host_blocked_us`` and both sides become
spans: the worker's load, rebuilt from its measured wall window on the
``se-tpu-shard`` track, and the consumer's wait, with a flow arrow from
load to wait when the wait was a prefetch miss.  The wait for a pinned
staging buffer's previous copy before it is refilled is timed apart, as
``reuse_wait_s``.  ``take_stats`` keeps the per-fit ledger the per-round
events read.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from spark_ensemble_tpu_torch.autotune.resolve import resolve as _tuned
from spark_ensemble_tpu_torch.models.base import resolve_device
from spark_ensemble_tpu_torch.telemetry.events import global_metrics
from spark_ensemble_tpu_torch.telemetry.trace import new_flow_id

#: default lookahead (shards in flight past the one being consumed): the
#: "prefetch_depth" tunable's default
DEFAULT_PREFETCH_DEPTH = 2


def _mirror_shard_metrics(hit: bool, nbytes: int, load_s: float,
                          wait_s: float) -> None:
    """Mirror one shard's I/O into the process-global registry, so
    ``global_metrics().snapshot()`` is a one-stop process view: the per-fit
    ``take_stats()`` ledger resets on read, these accumulate for the life
    of the process."""
    g = global_metrics()
    g.counter("data/shard_loads").inc()
    g.counter("data/shard_bytes").inc(nbytes)
    g.counter(
        "data/shard_prefetch_hits" if hit else "data/shard_prefetch_misses"
    ).inc()
    g.histogram("data/shard_load_s").record(load_s)
    g.histogram("data/shard_wait_s").record(wait_s)


class ShardLoadError(RuntimeError):
    """A shard read failed on the prefetch worker thread.

    Worker exceptions only surface when the consumer awaits the future,
    possibly several shards after the one that broke.  This wrapper pins
    the failure to its shard index (``.shard``) and keeps the original
    exception as ``__cause__``, so a streaming-fit abort names the file
    that failed.  A ``RuntimeError``, so the retry layer treats a flaky
    read like any other transient fault."""

    def __init__(self, shard: int, cause: BaseException):
        super().__init__(f"shard {shard} failed to load: {cause!r}")
        self.shard = int(shard)


class ShardPrefetcher:
    """Cyclic shard prefetcher over a ``ShardStore`` (or any
    object with ``num_shards``, ``n`` and ``load_shard``).

    ``sweep()`` yields ``(shard_index, words)``: with ``to_device`` the
    packed words as an int32 tensor on ``device`` (the port's bit patterns
    of the stored uint32 words), else the host ``u32`` numpy array."""

    def __init__(self, store, depth: Optional[int] = None,
                 to_device: bool = True, device="cuda", telem=None):
        self.store = store
        self.telem = telem
        if depth is None:
            depth = int(_tuned("prefetch_depth", DEFAULT_PREFETCH_DEPTH,
                               n=store.n))
        self.depth = max(1, int(depth))
        self.to_device = to_device
        self.device = resolve_device(device) if to_device else None
        self._ex = ThreadPoolExecutor(
            max_workers=self.depth, thread_name_prefix="se-torch-shard"
        )
        self._pending: Dict[int, Future] = {}
        self._closed = False
        self._stats = self._zero_stats()
        # CUDA staging: two pinned host buffers, each with the event of its
        # last copy to the card, and the side stream those copies run on
        self._staging = []
        self._slot = 0
        self._side = None

    @staticmethod
    def _zero_stats():
        return {
            "loads": 0, "hits": 0, "misses": 0, "bytes": 0,
            "load_s": 0.0, "wait_s": 0.0, "reuse_wait_s": 0.0,
            "errors": 0, "last_error": None,
        }

    def _read(self, s: int) -> Tuple[np.ndarray, float, float]:
        # worker thread: numpy and file I/O only.  The wall-clock start
        # rides back so the consumer can rebuild the load as a span
        wall0 = time.time()
        t0 = time.perf_counter()
        arr = self.store.load_shard(s)
        return arr, time.perf_counter() - t0, wall0

    def _schedule_from(self, pos: int) -> None:
        S = self.store.num_shards
        for j in range(self.depth + 1):
            if len(self._pending) > self.depth:
                break
            s = (pos + j) % S
            if s not in self._pending:
                self._pending[s] = self._ex.submit(self._read, s)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host words -> int32 tensor on ``self.device`` (consumer thread)."""
        host = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
        if self.device.type != "cuda":
            return host.to(self.device)
        if not self._staging or self._staging[0][0].shape != host.shape:
            self._staging = [[torch.empty(host.shape, dtype=torch.int32).pin_memory(),
                              None] for _ in range(2)]
            self._side = torch.cuda.Stream(device=self.device)
        slot = self._staging[self._slot]
        self._slot ^= 1
        buf, done = slot
        if done is not None:
            # the buffer's previous copy must land before it is refilled: a
            # wait on the round path, kept apart from the shard wait
            t0 = time.perf_counter()
            done.synchronize()
            self._stats["reuse_wait_s"] += time.perf_counter() - t0
        buf.copy_(host)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._side):
            out = buf.to(self.device, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(self._side)
        compute.wait_event(slot[1])
        # allocated on the side stream, read on the compute stream
        out.record_stream(compute)
        return out

    def sweep(self) -> Iterator[Tuple[int, object]]:
        """Yield ``(shard_index, words)`` for shards ``0..S-1``."""
        if self._closed:
            raise RuntimeError("prefetcher is closed")
        S = self.store.num_shards
        for pos in range(S):
            self._schedule_from(pos)
            fut = self._pending.pop(pos, None)
            if fut is None:  # pragma: no cover - reconcile safety net
                fut = self._ex.submit(self._read, pos)
            hit = fut.done()
            wait_wall0 = time.time()
            t0 = time.perf_counter()
            try:
                arr, load_s, load_wall0 = fut.result()
            except Exception as e:
                # attribute the abort to the shard that broke: the wait is
                # still charged and the failure lands in take_stats()
                st = self._stats
                st["wait_s"] += time.perf_counter() - t0
                st["errors"] += 1
                st["last_error"] = f"shard {pos}: {type(e).__name__}: {e}"
                global_metrics().counter("data/shard_errors").inc()
                raise ShardLoadError(pos, e) from e
            wait_s = time.perf_counter() - t0
            st = self._stats
            st["loads"] += 1
            st["bytes"] += arr.nbytes
            st["load_s"] += load_s
            st["hits" if hit else "misses"] += 1
            st["wait_s"] += wait_s
            _mirror_shard_metrics(hit, arr.nbytes, load_s, wait_s)
            if self.telem is not None and self.telem.enabled:
                # the overlap miss the prefetcher exists to hide, charged
                # to the same ledger as the device-read fences
                self.telem.host_blocked(wait_s)
                flow = None if hit else new_flow_id()
                self.telem.emit_span(
                    "shard_load", load_wall0, load_s,
                    thread="se-tpu-shard", shard=pos, bytes=arr.nbytes,
                    flow_out=None if flow is None else [flow],
                )
                self.telem.emit_span(
                    "shard_wait", wait_wall0, wait_s,
                    shard=pos, hit=hit, flow_in=flow,
                )
            # keep the worker busy while the device consumes this shard
            self._schedule_from(pos + 1)
            yield pos, (self._upload(arr) if self.to_device else arr)

    def take_stats(self) -> Dict[str, float]:
        """Counters accumulated since the last take (loads / hits / misses
        / bytes / load_s / wait_s / reuse_wait_s / errors / last_error),
        then reset."""
        out, self._stats = self._stats, self._zero_stats()
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._ex.shutdown(wait=True)
        for _, done in self._staging:
            if done is not None:
                # graftlint: ignore[unfenced-blocking-read] -- close(): the last copies land before their pinned buffers are freed, off the round path
                done.synchronize()
        self._staging = []

    def __enter__(self) -> "ShardPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
