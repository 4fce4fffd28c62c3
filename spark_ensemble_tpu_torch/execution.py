"""Round execution: the family-agnostic RoundExecutor, lookahead depth
resolution and the opt-in device patience recurrence (PyTorch port of
``execution.py``).

:class:`RoundExecutor` runs every speculative round loop.  Both round
loops (``models/gbm.py``'s ``_drive_rounds`` and
``models/boosting.py``'s ``_drive_boosting_rounds``) plug into it through
:class:`RoundAdapter`: the executor owns window fill, in-order commit and
invalidation of chunks in flight; each family keeps its chunk math, guard
recovery and checkpoint payloads behind the adapter hooks.

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
from collections import deque
from typing import Any, Optional, Tuple

import torch

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
    out = torch.stack([best_t.double(), v_t.double(), done.double(),
                       kept.double()])
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
