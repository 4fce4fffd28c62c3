"""Per-program cost inventory: the ``/programz`` operator surface (PyTorch
port of ``telemetry/programz.py``).

The round ledger (``telemetry/events.py``) prices every round with the
analytic model ``ops/tree.py::round_cost_est``; this module adds the third
leg of the cost triangle: what the program's own launches did.  The port
compiles no programs, so a program is one call of a chokepoint the JAX
package runs as one cached program (``models/base.py::program_call``: a
GBM, Boosting or Bagging round chunk, an elastic sweep step, an ensemble
model's predict, an engine graph), keyed by ``(tag, shape signature)``.
A process-wide :class:`ProgramInventory`, installed as the program sink by
:func:`enable`, records per program its calls and host walls and the work
its kernel launches reported (``ops/hist_kernels.py::kernel_work``, through
the wrappers' work hook, which :func:`enable` installs too; the matmul and
stream tiers report their one-hot products the same way).  Every kernel
launch is also a row of its own, tagged with the kernel's name
(``"kind": "kernel"``), so ``/programz`` shows each kernel's calls, bytes
and operations beside the programs that launched it.

A record holds shapes, dtypes and summed work, never a tensor, so it pins
no device memory.  Analysis is decoupled from capture, as in the JAX
package:

- **capture** is a dict update per program call and per kernel launch;
- **shallow analysis** (``deep=False``, the sampler's default) is host
  arithmetic over the recorded work: per call, the ops and bytes of its
  launches.  It launches nothing, builds nothing with nvcc and captures no
  graph.  Because it is only arithmetic, the round ledger's join
  (:func:`xla_cost_fields`) analyzes a pending record on the spot instead
  of waiting for the sampler;
- **deep analysis** (``analyze_pending(deep=True)``, explicit calls only)
  reads the peak device memory of each program's next call from the
  allocator's process-wide peak (``torch.cuda.max_memory_allocated``, which
  ``events.device_memory_stats`` reports as ``peak_bytes_in_use``).  The
  peak is never reset, so a running fit's own reading stays whole: a call
  that raises the process's peak gives the bytes in use at its peak
  (``peak_hbm_bytes``); a call that stays below an earlier peak gives only
  ``peak_hbm_bytes_at_most`` (that earlier peak).

The JAX event keys are kept, because ``tools/telemetry_report.py`` and
``tools/perf_sentinel.py`` read them.  On the card they mean:

- ``program_tag``: the round chunk's program tag (``gbm_cls_round``, ...);
- ``xla_flops``: the ops a round's launches did (``kernel_work``: one add
  per statistic cell for the histogram and leaf kernels, one compare per
  routed (row, member), ``2*m*k*n`` per one-hot matmul);
- ``xla_bytes_accessed``: the bytes a round's launches moved, each input
  read and each output written once;
- ``xla_modeled_s``: ``max(xla_flops / peak, xla_bytes_accessed / bw)`` at
  the card's peak rate and memory bandwidth (``round_cost``);
- ``mfu_xla``: ``xla_flops`` over the measured round time at peak;
- ``xla_vs_analytic_flops_ratio``: ``xla_flops`` over ``round_cost_est``'s
  ``flops_est`` (one-hot MACs: the kernels' adds are far fewer);
- ``xla_peak_hbm_bytes``: the deep analysis's measured peak, when taken.

``/programz`` scrapes (``telemetry/exporter.py``) render stored rows only.
The :class:`HbmSampler` is the background thread publishing
``hbm/gpu:<i>/*`` gauges into ``global_metrics()`` and draining pending
shallow analysis off the hot path.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from spark_ensemble_tpu_torch.models.base import open_programs

__all__ = [
    "ProgramRecord",
    "ProgramInventory",
    "HbmSampler",
    "global_inventory",
    "enable",
    "disable",
    "enabled",
    "xla_cost_fields",
]

#: LRU bound on retained records (host metadata of a few hundred bytes
#: each): hygiene, not memory pressure
_MAX_RECORDS = 256


def _peak_bytes() -> Optional[int]:
    """The allocator's process-wide peak on the current card, or None when
    CUDA is not up (this never initializes it)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.max_memory_allocated())


class ProgramRecord:
    """One distinct program or kernel: identity, call accounting, summed
    launch work, and the analysis once :meth:`ProgramInventory.
    analyze_pending` (or the round ledger's join) ran."""

    __slots__ = (
        "tag", "signature", "kind", "first_ts", "last_ts", "calls",
        "first_call_s", "total_call_s", "work", "analysis",
        "analysis_error", "analyzed",
    )

    def __init__(self, tag: str, signature: tuple, kind: str,
                 call_s: Optional[float] = None):
        now = time.time()
        self.tag = tag
        self.signature = signature
        self.kind = kind
        self.first_ts = now
        self.last_ts = now
        self.calls = 0
        self.first_call_s = call_s
        self.total_call_s = 0.0 if call_s is not None else None
        self.work: Dict[str, List[int]] = {}
        self.analysis: Dict[str, Any] = {}  # deep results
        self.analysis_error: Optional[str] = None
        self.analyzed = False

    def _add(self, call_s: Optional[float], work: Dict[str, List[int]]) -> None:
        self.calls += 1
        self.last_ts = time.time()
        if call_s is not None and self.total_call_s is not None:
            self.total_call_s += call_s
        for kernel, (launches, nbytes, nops) in work.items():
            w = self.work.setdefault(kernel, [0, 0, 0])
            w[0] += launches
            w[1] += nbytes
            w[2] += nops

    @property
    def status(self) -> str:
        if self.analyzed:
            return "analyzed"
        if self.analysis_error is not None:
            return "unavailable"
        return "pending"

    def totals(self) -> Tuple[int, int, int]:
        """``(launches, bytes, ops)`` summed over every call and kernel."""
        return tuple(sum(w[i] for w in self.work.values()) for i in range(3))

    def row(self) -> Dict[str, Any]:
        """JSON-ready ``/programz`` row: the JAX package's keys, plus
        ``kind`` and the summed launch work (``launches``, ``bytes``,
        ``ops``, and per kernel under ``kernels``)."""
        launches, nbytes, nops = self.totals()
        out: Dict[str, Any] = {
            "tag": self.tag,
            "kind": self.kind,
            "signature": [list(s) for s in self.signature],
            "calls": self.calls,
            "first_ts": self.first_ts,
            "last_ts": self.last_ts,
            "first_call_s": self.first_call_s,
            "total_call_s": self.total_call_s,
            "status": self.status,
            "launches": launches,
            "bytes": nbytes,
            "ops": nops,
            "kernels": {k: {"launches": w[0], "bytes": w[1], "ops": w[2]}
                        for k, w in sorted(self.work.items())},
        }
        out.update(self.per_call())
        out.update(self.analysis)
        if self.analysis_error:
            out["analysis_error"] = self.analysis_error
        return out

    def per_call(self) -> Dict[str, float]:
        """The shallow analysis, once analyzed: ``flops``,
        ``bytes_accessed`` and ``launches_per_call`` averaged over the
        calls so far (host arithmetic on the summed work)."""
        if not self.analyzed:
            return {}
        calls = max(self.calls, 1)
        launches, nbytes, nops = self.totals()
        return {"flops": nops / calls, "bytes_accessed": nbytes / calls,
                "launches_per_call": launches / calls}

    def _analyze(self) -> None:
        """Shallow analysis: marks the record analyzed when it has work
        (its per-call numbers are then :meth:`per_call`), else
        unavailable.  Host arithmetic only."""
        if self.totals()[0]:
            self.analyzed = True
            self.analysis_error = None
        else:
            self.analysis_error = (
                "no kernel or matmul work recorded for this program"
            )


class ProgramInventory:
    """Process-wide program inventory; installed as the ``models/base``
    program sink and the kernel wrappers' work hook by :func:`enable`, and
    scraped by ``/programz``."""

    def __init__(self, max_records: int = _MAX_RECORDS):
        self._lock = threading.Lock()
        self._records: "OrderedDict[Tuple[str, tuple], ProgramRecord]" = (
            OrderedDict()
        )
        self._max = int(max_records)
        self._calls = 0
        self._deep_keys: set = set()

    def _record(self, tag: str, sig: tuple, kind: str,
                call_s: Optional[float], work) -> ProgramRecord:
        key = (tag, sig)
        with self._lock:
            self._calls += 1
            rec = self._records.get(key)
            if rec is None:
                rec = ProgramRecord(tag, sig, kind, call_s)
                self._records[key] = rec
                while len(self._records) > self._max:
                    self._records.popitem(last=False)
            else:
                self._records.move_to_end(key)
            rec._add(call_s, work)
        return rec

    # -- capture ------------------------------------------------------------

    def __call__(self, call) -> ProgramRecord:
        return self.record_call(call)

    def record_call(self, call) -> ProgramRecord:
        """The ``models/base`` program sink: one finished
        :class:`~spark_ensemble_tpu_torch.models.base.ProgramCall`."""
        rec = self._record(call.tag, call.signature, "program", call.call_s,
                           call.work)
        if call.peak0 is not None:
            with self._lock:
                self._finish_deep(rec, call)
        self._publish_gauges()
        return rec

    def record_kernel(self, kernel: str, sig: tuple, nbytes: int,
                      nops: int) -> None:
        """The kernel wrappers' work hook: one launch (or plain-version
        call on the CPU) of ``kernel``; its work also goes to this thread's
        open program calls."""
        self._record(kernel, sig, "kernel", None, {kernel: [1, nbytes, nops]})
        for call in open_programs():
            call.add_work(kernel, nbytes, nops)

    # -- deep analysis --------------------------------------------------------

    def begin_call(self, call) -> None:
        """Called as a program call starts: when its record asked for deep
        analysis, note the allocator's peak before it (the peak is updated
        as the host allocates, so no fence is needed)."""
        if self._deep_keys and (call.tag, call.signature) in self._deep_keys:
            call.peak0 = _peak_bytes()

    def _finish_deep(self, rec: ProgramRecord, call) -> None:
        after = _peak_bytes()
        if after is None:
            return
        if after > call.peak0:
            rec.analysis["peak_hbm_bytes"] = float(after)
            rec.analysis.pop("peak_hbm_bytes_at_most", None)
        else:
            rec.analysis["peak_hbm_bytes_at_most"] = float(call.peak0)
        self._deep_keys.discard((call.tag, call.signature))

    # -- analysis -------------------------------------------------------------

    def analyze_pending(self, limit: Optional[int] = None,
                        deep: bool = False) -> int:
        """Analyze up to ``limit`` pending records -> the number analyzed
        (or marked unavailable).  ``deep=True`` also asks every program
        record for its next call's peak device memory."""
        with self._lock:
            recs = list(self._records.values())
        pending = [r for r in recs if r.status == "pending"]
        if limit is not None:
            pending = pending[: max(int(limit), 0)]
        for rec in pending:
            rec._analyze()
        if deep:
            self._deep_keys.update(
                (r.tag, r.signature) for r in recs if r.kind == "program")
        if pending:
            self._publish_gauges()
        return len(pending)

    # -- consumption ----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def records(self) -> List[ProgramRecord]:
        with self._lock:
            return list(self._records.values())

    def rows(self, top: Optional[int] = None) -> List[Dict[str, Any]]:
        """``/programz`` rows, heaviest first (ops per call, then calls);
        pure rendering of stored state."""
        rows = [r.row() for r in self.records()]
        rows.sort(
            key=lambda r: (-float(r.get("flops", 0.0)), -r["calls"], r["tag"])
        )
        if top is not None:
            rows = rows[: max(int(top), 0)]
        return rows

    def kernel_rows(self, kernel: str) -> List[Dict[str, Any]]:
        """Every row of one kernel (one per shape signature)."""
        return [r.row() for r in self.records()
                if r.kind == "kernel" and r.tag == kernel]

    def summary(self) -> Dict[str, Any]:
        recs = self.records()
        with self._lock:
            calls = self._calls
        return {
            "programs": sum(1 for r in recs if r.kind == "program"),
            "kernels": sum(1 for r in recs if r.kind == "kernel"),
            "calls": calls,
            "analyzed": sum(1 for r in recs if r.status == "analyzed"),
            "pending": sum(1 for r in recs if r.status == "pending"),
            "unavailable": sum(1 for r in recs if r.status == "unavailable"),
        }

    def emit_rows(self, top: Optional[int] = None,
                  path: Optional[str] = None) -> int:
        """Emit one ``program`` telemetry event per ``/programz`` row into
        the active JSONL sink -> the number emitted."""
        from spark_ensemble_tpu_torch.telemetry.events import emit_event

        rows = self.rows(top=top)
        for row in rows:
            emit_event("program", path=path, **row)
        return len(rows)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._calls = 0
            self._deep_keys = set()

    def _publish_gauges(self) -> None:
        from spark_ensemble_tpu_torch.telemetry.events import global_metrics

        s = self.summary()
        reg = global_metrics()
        reg.gauge("programz/programs").set(s["programs"])
        reg.gauge("programz/analyzed").set(s["analyzed"])
        reg.gauge("programz/pending").set(s["pending"])


_GLOBAL_INVENTORY = ProgramInventory()


def global_inventory() -> ProgramInventory:
    """The process-global inventory (what /programz serves)."""
    return _GLOBAL_INVENTORY


def enable() -> ProgramInventory:
    """Install the global inventory as the ``models/base`` program sink and
    the kernel wrappers' work hook.  Programs called BEFORE enabling stay
    invisible, and an engine graph captured before it replays with no
    recorded work: enable the operator plane before fitting or warming up
    (``telemetry/exporter.py`` does this)."""
    from spark_ensemble_tpu_torch.models.base import set_program_sink
    from spark_ensemble_tpu_torch.ops.hist_kernels import set_work_hook

    set_work_hook(_GLOBAL_INVENTORY.record_kernel)
    set_program_sink(_GLOBAL_INVENTORY)
    return _GLOBAL_INVENTORY


def disable() -> None:
    from spark_ensemble_tpu_torch.models.base import set_program_sink
    from spark_ensemble_tpu_torch.ops.hist_kernels import set_work_hook

    set_program_sink(None)
    set_work_hook(None)


def enabled() -> bool:
    from spark_ensemble_tpu_torch.models.base import _PROGRAM_SINK

    return _PROGRAM_SINK[0] is not None


# ---------------------------------------------------------------------------
# round-ledger join (telemetry/events.py round_chunk)
# ---------------------------------------------------------------------------


def xla_cost_fields(round_cost: Optional[Dict[str, Any]],
                    per_round_s: float,
                    rounds_per_dispatch: int,
                    call=None) -> Dict[str, Any]:
    """The launch leg of the three-way ``round_end`` cost line: the work of
    the chunk's program call ``call`` itself, whose record is analyzed on
    the spot when pending (host arithmetic).  Empty without a recorded
    call, or when the program launched nothing the inventory counts.
    Never raises; launches, builds and captures nothing."""
    rec = None if call is None else call.record
    if rec is None:
        return {}
    if rec.status == "pending":
        with _GLOBAL_INVENTORY._lock:
            rec._analyze()
    if not rec.analyzed:
        return {}
    _, nbytes, flops = call.totals()
    rounds = max(int(rounds_per_dispatch), 1)
    fields: Dict[str, Any] = {"program_tag": rec.tag}
    if flops:
        per_round_flops = flops / rounds
        fields["xla_flops"] = per_round_flops
        peak = (round_cost or {}).get("peak_flops")
        if peak and per_round_s > 0:
            fields["mfu_xla"] = per_round_flops / (per_round_s * float(peak))
        if peak:
            modeled = per_round_flops / float(peak)
            bw = (round_cost or {}).get("hbm_bw_est")
            if bw and nbytes:
                modeled = max(modeled, (nbytes / rounds) / float(bw))
            fields["xla_modeled_s"] = modeled
        flops_est = (round_cost or {}).get("flops_est")
        if flops_est:
            fields["xla_vs_analytic_flops_ratio"] = (
                per_round_flops / float(flops_est)
            )
    if nbytes:
        fields["xla_bytes_accessed"] = nbytes / rounds
    peak_hbm = rec.analysis.get("peak_hbm_bytes")
    if peak_hbm:
        fields["xla_peak_hbm_bytes"] = peak_hbm
    return fields


# ---------------------------------------------------------------------------
# background device-memory sampler
# ---------------------------------------------------------------------------


class HbmSampler:
    """Daemon thread sampling each card's allocator stats into
    ``global_metrics()`` gauges (``hbm/gpu:<i>/bytes_in_use`` and
    ``hbm/gpu:<i>/peak_bytes_in_use``, from ``events.
    device_memory_stats``) and draining pending shallow analysis off the
    hot path.  It publishes no gauge on the CPU, or before the process
    has brought CUDA up (a sample never initializes it)."""

    def __init__(self, interval_s: float = 1.0, analyze: bool = True,
                 analyze_per_tick: int = 1,
                 inventory: Optional[ProgramInventory] = None):
        self.interval_s = float(interval_s)
        self._analyze = bool(analyze)
        self._per_tick = int(analyze_per_tick)
        self._inventory = inventory or _GLOBAL_INVENTORY
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.errors = 0
        self.last_error: Optional[str] = None

    def sample_once(self) -> Dict[str, Dict[str, int]]:
        import torch

        from spark_ensemble_tpu_torch.telemetry.events import (
            device_memory_stats,
            global_metrics,
        )

        stats: Dict[str, Dict[str, int]] = {}
        if torch.cuda.is_initialized():
            stats = device_memory_stats()
        reg = global_metrics()
        for dev, s in stats.items():
            for key in ("bytes_in_use", "peak_bytes_in_use"):
                if key in s:
                    reg.gauge(f"hbm/{dev}/{key}").set(float(s[key]))
        if self._analyze:
            self._inventory.analyze_pending(limit=self._per_tick, deep=False)
        self.ticks += 1
        return stats

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:  # noqa: BLE001 - counted, not fatal
                # to the thread: the plane's owner reads ``errors``
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"

    def start(self) -> "HbmSampler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="se-tpu-hbm-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
