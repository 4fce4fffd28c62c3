"""Training instrumentation: structured logging and profiler hooks (PyTorch
port of ``utils/instrumentation.py``).

``instrumented`` logs a fit's params on entry and its failure on exit, as
the reference's ``instrumented { instr => ... }`` wrapper does;
``instrumented_fit`` decorates every estimator ``fit`` with it, with a
``torch.profiler`` capture of the whole fit when the estimator's
``profile_dir`` is set, and with a terminal ``fit_aborted`` record for
every telemetry stream the fit (or a nested fit on this thread) left open
when it raises (``telemetry/events.py``).

PyTorch launches CUDA work asynchronously, as JAX dispatches it:
:func:`block_on_arrays` is the fence.  It walks a model (or any nest of
lists, tuples, dicts and models) for CUDA tensors and waits for each
device's current stream through one recorded event, not for the whole
device; CPU tensors need no fence.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch

logger = logging.getLogger("spark_ensemble_tpu_torch")


class Instrumentation:
    def __init__(self, stage: str):
        self.stage = stage
        self.t0 = time.perf_counter()

    def log_params(self, params: Dict[str, Any]) -> None:
        clean = {
            k: v for k, v in params.items() if isinstance(v, (bool, int, float, str))
        }
        logger.info("[%s] params: %s", self.stage, clean)

    def log_dataset(self, n: int, d: int, num_classes: Optional[int] = None) -> None:
        extra = f", numClasses={num_classes}" if num_classes is not None else ""
        logger.info("[%s] dataset: n=%d, d=%d%s", self.stage, n, d, extra)

    def log_named_value(self, name: str, value) -> None:
        logger.info("[%s] %s=%s", self.stage, name, value)

    def log_outcome(self, **kv) -> None:
        elapsed = time.perf_counter() - self.t0
        logger.info("[%s] done in %.3fs: %s", self.stage, elapsed, kv)


@contextlib.contextmanager
def instrumented(stage: str) -> Iterator[Instrumentation]:
    """``with instrumented("GBMRegressor.fit") as instr:``, the analogue of
    the reference's ``instrumented { instr => ... }`` wrapper."""
    instr = Instrumentation(stage)
    try:
        yield instr
    except Exception:
        logger.exception("[%s] failed", stage)
        raise


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of CPU and CUDA activity around
    the block when ``log_dir`` is set, written as a Chrome trace
    ``trace_<ns>_<pid>.pt.trace.json`` into ``log_dir`` (a no-op
    otherwise).  ``utils/profiling.py`` summarizes it."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.time_ns()}_{os.getpid()}.pt.trace.json"))


def instrumented_fit(fit):
    """Decorator for estimator ``fit`` methods: runs the body inside the
    ``instrumented`` logging scope and, when the estimator's
    ``profile_dir`` param is set, inside a ``torch.profiler`` capture of
    the whole fit, fenced on the result before the capture stops."""

    @functools.wraps(fit)
    def wrapper(self, *args, **kwargs):
        # lazy import: events imports block_on_arrays from this module
        from spark_ensemble_tpu_torch.telemetry import events as _events

        profile_dir = getattr(self, "profile_dir", None)
        depth0 = _events.active_fit_depth()
        with instrumented(f"{type(self).__name__}.fit"), profile_trace(
            profile_dir
        ):
            try:
                result = fit(self, *args, **kwargs)
            except BaseException as e:
                # a terminal fit_aborted record for every telemetry this
                # fit (and any nested fit on this thread) opened but never
                # closed: JSONL streams always end with a terminal event
                _events.abort_active_fits(depth0, e)
                raise
            if profile_dir:
                # launches are asynchronous: without this fence the capture
                # would stop before the card ran the fit's last kernels
                block_on_arrays(result)
            return result

    return wrapper


def block_on_arrays(obj) -> None:
    """Wait for the CUDA work behind every tensor reachable from ``obj``
    (fitted models keep tensors under ``.params``; composites nest child
    models in attributes).  One event on each device's current stream:
    the tensors' producers ran on it, in order."""
    seen = set()
    devices = set()

    def walk(o):
        if id(o) in seen:
            return
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                devices.add(o.device)
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
        elif isinstance(o, dict):
            for x in o.values():
                walk(x)
        elif hasattr(o, "predict") and hasattr(o, "__dict__"):
            for x in vars(o).values():
                walk(x)

    walk(obj)
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
