"""Round execution: the family-agnostic RoundExecutor, the chunk
lifecycle both ensemble families share, lookahead depth resolution and
the opt-in device patience recurrence (PyTorch port of ``execution.py``).

:class:`RoundExecutor` runs every speculative round loop through
:class:`RoundAdapter`: the executor owns window fill, in-order commit and
invalidation of chunks in flight.  ``_ChunkLoop`` is the adapter of both
round loops (``models/gbm.py``'s ``_GBMLoop`` and
``models/boosting.py``'s ``_BoostingLoop``): it owns a chunk's life from
launch to commit (the chunk clamped to the next checkpoint boundary, its
dispatch under the retry layer and the chaos sites, the one host read of
its flags and values, the kill sites after its commit, and the
checkpointer's join or abandon), and each family keeps its chunk math,
its carry (attributes of its loop object) and its commit rules.

A chunk is a run of rounds (the ``scan_chunk`` Param, clamped to the next
checkpoint boundary).  Its launches go onto the CUDA stream as the host
issues them; the host reads the chunk's outputs (its finite flags and
validation losses, in one transfer) only when it commits it.  With depth
``k`` the executor keeps up to ``k`` chunks launched past the one being
committed, so the card computes chunk ``j+1`` while the host reads chunk
``j``.

Exactness holds because every round's keys and masks derive from its
absolute round index: a mid-chunk validation stop or a guard recovery
discards the speculative chunks and rewinds the carry, and a replay
re-launches the same kernels over the same keys, bit for bit.
``SE_TPU_PIPELINE=0`` pins the synchronous path; unset, the depth is the
autotuned ``pipeline_depth`` (default :data:`DEFAULT_PIPELINE_DEPTH`).

``SE_TPU_DEVICE_PATIENCE=1`` folds a chunk's validation losses through
the patience recurrence on the device, in float32, and reads back four
scalars; the host reference steps in float64, so decisions can differ at
tolerance boundaries.  It is off by default.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from typing import Any, List, Optional, Tuple

import torch

from spark_ensemble_tpu_torch.models.base import program_call, resolved_scan_chunk
from spark_ensemble_tpu_torch.robustness.chaos import controller
from spark_ensemble_tpu_torch.robustness.retry import retry_call
from spark_ensemble_tpu_torch.telemetry.trace import NULL_SPAN, new_flow_id

PIPELINE_ENV = "SE_TPU_PIPELINE"
DEVICE_PATIENCE_ENV = "SE_TPU_DEVICE_PATIENCE"

#: deepest supported lookahead window; beyond 2 the host is never the
#: bottleneck and speculative work wasted on a stop grows linearly
MAX_PIPELINE_DEPTH = 2

#: default depth when ``SE_TPU_PIPELINE`` is unset
DEFAULT_PIPELINE_DEPTH = 1


def resolve_pipeline_depth(n_rows: Optional[int] = None) -> int:
    """Lookahead depth of a fit over ``n_rows`` rows: ``SE_TPU_PIPELINE``
    clamped to ``[0, MAX_PIPELINE_DEPTH]`` (a value that is not an integer
    is ignored), else the autotuned ``pipeline_depth`` (clamped alike),
    else :data:`DEFAULT_PIPELINE_DEPTH`.  Read per fit, so a test can flip
    the env between fits."""
    raw = os.environ.get(PIPELINE_ENV)
    if raw is not None and raw.strip():
        try:
            return max(0, min(MAX_PIPELINE_DEPTH, int(raw)))
        except ValueError:
            pass  # an unparsable env degrades to the tunable
    from spark_ensemble_tpu_torch.autotune.resolve import resolve

    depth = resolve("pipeline_depth", DEFAULT_PIPELINE_DEPTH, n=n_rows)
    try:
        return max(0, min(MAX_PIPELINE_DEPTH, int(depth)))
    except (TypeError, ValueError):
        return DEFAULT_PIPELINE_DEPTH


def device_patience_enabled() -> bool:
    """Whether the opt-in device patience recurrence is active."""
    return os.environ.get(DEVICE_PATIENCE_ENV, "") not in ("", "0")


def device_patience_step(errs: torch.Tensor, best: float, v: int, tol: float,
                         limit: int, telem=None) -> Tuple[float, int, bool, int]:
    """Fold a chunk's per-round validation losses on the device and read
    back four scalars ``(best, v, stopped, kept)``, ``kept`` counting the
    rounds up to and including the stopping round.  The recurrence runs in
    float32, as the JAX package's ``lax.scan`` does.  The read is charged
    to ``telem``'s ``host_blocked_us``."""
    f32 = torch.float32
    dev = errs.device
    best_t = torch.tensor(best if math.isfinite(best) else float("inf"),
                          dtype=f32, device=dev)
    v_t = torch.tensor(int(v), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    kept = torch.zeros((), dtype=torch.int32, device=dev)
    tol_t = torch.tensor(tol, dtype=f32, device=dev)
    for err in errs.to(f32):
        no_improve = (best_t - err) < tol_t * torch.clamp(err, min=0.01)
        new_v = torch.where(no_improve, v_t + 1, torch.zeros_like(v_t))
        new_best = torch.where(no_improve, best_t, err)
        stop_now = ~done & (new_v >= limit)
        best_t = torch.where(done, best_t, new_best)
        v_t = torch.where(done, v_t, new_v)
        kept = torch.where(done, kept, kept + 1)
        done = done | stop_now
    # graftlint: ignore[f64-upcast] -- one 4-scalar readback: float64 carries the f32 loss and the int32 counts exactly
    out = torch.stack([t.double() for t in (best_t, v_t, done, kept)])
    if telem is not None:
        telem.blocking_read(out)
    host = out.tolist()
    return float(host[0]), int(host[1]), bool(host[2]), int(host[3])


# ---------------------------------------------------------------------------
# the family-agnostic round executor
# ---------------------------------------------------------------------------


class RoundAdapter:
    """One ensemble family's view of its round loop, as seen by
    :class:`RoundExecutor`.

    - ``should_continue()``: loop predicate over committed state (round
      count, patience, abort/halt flags).
    - ``can_launch()``: whether the launch frontier has rounds left.
    - ``window()``: cap on chunks in flight for the next fill, normally
      ``depth + 1``; a family with a probe chunk (Boosting's abort ramp)
      returns 1 until the probe commits.
    - ``launch() -> entry``: plan one chunk at the frontier, launch it and
      advance the frontier.  The entry is opaque to the executor.
    - ``commit(entry, speculated) -> bool``: read the chunk's outputs and
      run the family's bookkeeping; ``speculated`` is True when later
      chunks are in flight (the family then commits under the entry's own
      carry snapshot).  Return True to invalidate everything in flight.
    - ``reset_frontier()``: rewind the launch frontier to committed state.
    - ``finish()``: post-loop join (the checkpointer's ``wait()``); runs
      only on a clean exit, so a ``raise`` guard policy propagates.
    """

    #: chunks in flight past the committing one; 0 pins the synchronous path
    depth: int = 0

    #: the fit's FitTelemetry, when the family wires one through: the
    #: executor traces each chunk's launch-to-commit life as a span with
    #: its committed / invalidated / abandoned fate (telemetry/trace.py);
    #: None traces nothing
    telem = None

    #: extra fields merged into every round_chunk span (a dict, e.g. the
    #: GBM sampling stage's ``{"sampling": "goss", "sample_bucket": 256}``);
    #: None adds nothing
    span_fields = None

    def should_continue(self) -> bool:
        raise NotImplementedError

    def can_launch(self) -> bool:
        raise NotImplementedError

    def window(self) -> int:
        return self.depth + 1

    def launch(self) -> Any:
        raise NotImplementedError

    def commit(self, entry: Any, speculated: bool) -> bool:
        raise NotImplementedError

    def reset_frontier(self) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        pass


class RoundExecutor:
    """The round loop every family routes through: fills the
    adapter's lookahead window, commits chunks strictly in launch order,
    and on invalidation drops the speculative tail unread.  At depth 0 the
    window never holds more than one chunk: the synchronous loop.

    With the adapter's ``telem`` each chunk is a ``round_chunk`` span,
    begun before its launch and ended at its commit with its fate; a
    commit that invalidates the speculative tail draws a flow arrow from
    its span to each invalidated chunk's."""

    def __init__(self, adapter: RoundAdapter):
        self.adapter = adapter

    def run(self) -> RoundAdapter:
        a = self.adapter
        telem = a.telem
        pending: deque = deque()
        seq = 0
        try:
            while a.should_continue():
                while a.can_launch() and len(pending) < max(1, a.window()):
                    # span first, then launch: the chunk span covers the
                    # launch and stays open until its commit resolves
                    # its fate
                    pending.append((
                        NULL_SPAN if telem is None else telem.begin_span(
                            "round_chunk", chunk_seq=seq,
                            speculative=bool(pending),
                            **(a.span_fields or {}),
                        ),
                        a.launch(),
                    ))
                    seq += 1
                if not pending:
                    # frontier exhausted with nothing in flight: committed
                    # state lags the frontier and nothing can commit
                    break
                sp, entry = pending.popleft()
                invalidate = False
                fate = "aborted"
                flow = None
                try:
                    invalidate = a.commit(entry, speculated=bool(pending))
                    fate = "committed"
                    if invalidate and pending and sp:
                        flow = new_flow_id()
                        sp.add(flow_out=[flow])
                finally:
                    sp.end(fate=fate)
                if invalidate:
                    while pending:
                        psp, _ = pending.popleft()
                        if flow is None:
                            psp.end(fate="invalidated")
                        else:
                            psp.end(fate="invalidated", flow_in=flow)
                    a.reset_frontier()
        finally:
            # a raise mid-loop (guard policy, chaos fault) discards the
            # in-flight tail unread: their spans still close
            while pending:
                psp, _ = pending.popleft()
                psp.end(fate="abandoned")
        a.finish()
        return a


class _ChunkLoop(RoundAdapter):
    """One fit's round loop: the chunk lifecycle both families share.
    ``i`` counts the committed rounds and ``i_disp`` the launched ones;
    a subclass holds the carry as attributes and supplies:

    - ``run_chunk(i0, c, *args) -> out``: rounds ``i0 .. i0+c`` from the
      carry, advancing it only once the whole chunk ran (so a retried
      chunk starts from the same state); ``out`` is the family's tuple of
      round-stacked outputs;
    - ``snapshot()`` / ``restore(snap)``: copy and set the carry;
    - ``program_args(c)``: the signature of the chunk's program call;
    - ``poison(site, out)``: the chaos ``nan_grad`` site on ``out``;
    - ``host_values(out)``: the ``f32[c]`` values the host reads with the
      guard's flags; ``guarded(out)``: what the guard checks;
    - ``settle(c, snap, t0, out, bad, rows) -> invalidate``: the
      family's commit rules over the host ``rows`` of the chunk of ``c``
      rounds from ``i`` (``bad`` its first poisoned round, or None),
      advancing ``i``;
    - ``preemptible()``: whether the kill sites open after this commit
      (after every one, unless the family says otherwise).

    Each launched entry carries two carry snapshots: the chunk start (the
    guard's rewind point) and the chunk end (the state a checkpoint must
    see, so a speculative chunk is never saved before its predecessor
    commits).  A module-level class, not one made per fit: a class object
    sits in reference cycles of its own, and one made inside the fit kept
    every tensor its methods' closures reach (the carry, the binned
    features) alive until the cycle collector ran."""

    def __init__(self, est, *, ckpt, guard, telem, label: str, tag: str,
                 i: int, n_rows: Optional[int]):
        self.est, self.ckpt, self.guard = est, ckpt, guard
        self.telem = telem  # the executor traces chunk spans
        self.label, self.tag = label, tag
        self.ctl = controller()
        self.retry_policy = est._retry_policy()
        self.refresh_fit = est._is_refresh_fit
        self.chunk = resolved_scan_chunk(est, n_rows)
        self.depth = resolve_pipeline_depth(n_rows)
        self.i = self.i_disp = i
        self.programs = {}  # chunk start -> its program call, until committed

    def run(self) -> "_ChunkLoop":
        try:
            return RoundExecutor(self).run()
        except BaseException:
            self.ckpt.abandon()
            raise

    def can_launch(self) -> bool:
        return self.i_disp < self.est.num_base_learners

    def next_chunk(self) -> int:
        """Rounds the next launch asks for, before the clamps."""
        return self.chunk

    def launch(self):
        c = min(self.next_chunk(), self.est.num_base_learners - self.i_disp)
        if self.ckpt.enabled:
            c = min(c, self.ckpt.rounds_until_save(self.i_disp))
        snap_pre = self.snapshot()
        t0 = time.perf_counter()
        out = self.dispatch(self.i_disp, c)
        entry = (self.i_disp, c, snap_pre, self.snapshot(), t0, out)
        self.i_disp += c
        return entry

    def dispatch(self, i0: int, c: int, *args):
        """Rounds ``i0 .. i0+c`` as one call of the program ``tag``
        (``models/base.program_call``; a committed chunk's call joins its
        ``round_end`` events) under the retry layer: a transient
        ``RuntimeError`` re-runs the same chunk from the same carry."""
        site = f"{self.label}:round:{i0}"

        def attempt():
            self.ctl.transient(site)
            with program_call(self.tag, *self.program_args(c)) as call:
                out = self.run_chunk(i0, c, *args)
            self.programs[i0] = call
            return out

        out = retry_call(attempt, self.retry_policy,
                         op=f"{self.label}.round_chunk", telem=self.telem)
        return self.poison(site, out)

    def read(self, out) -> Tuple[Optional[int], List[List[float]]]:
        """One host transfer of a chunk -> (first poisoned round | None,
        its ``host_values`` as lists of floats)."""
        parts = self.host_values(out)
        if self.guard.active:
            parts.append(self.guard.flags(*self.guarded(out)).to(torch.float32))
        if not parts:
            return None, []
        host = torch.cat(parts).tolist()
        c = len(host) // len(parts)
        rows = [host[j * c:(j + 1) * c] for j in range(len(parts))]
        bad = None
        if self.guard.active:
            bad = next((j for j, f in enumerate(rows.pop()) if f), None)
        return bad, rows

    def commit(self, entry, speculated: bool) -> bool:
        _, c, snap_pre, snap_post, t0, out = entry
        if self.telem.enabled:
            # host-blocked accounting (a pure fence): the wait the
            # lookahead exists to overlap
            self.telem.blocking_read(out)
        bad, rows = self.read(out)
        if speculated:
            # commit under this chunk's own end state: a save must
            # persist committed arrays, not the speculative frontier
            frontier = self.snapshot()
            self.restore(snap_post)
        invalidate = self.settle(c, snap_pre, t0, out, bad, rows)
        if speculated and not invalidate:
            self.restore(frontier)
        if self.preemptible():
            # chaos: a preemption lands here, after the chunk's periodic
            # save, so kill-and-resume runs cross a real checkpoint
            # boundary
            self.ctl.preempt(f"{self.label}:after_round:{self.i}")
            if self.refresh_fit:
                # refresh-only kill site: a warm-start refresh fit dies
                # mid-fit, and the served model must stay untouched
                self.ctl.refresh_crash(f"{self.label}:refresh_round:{self.i}")
        return invalidate

    def preemptible(self) -> bool:
        return True

    def reset_frontier(self) -> None:
        self.i_disp = self.i

    def finish(self) -> None:
        # join the in-flight save (and surface its failure) before the
        # model is assembled
        self.ckpt.wait()
