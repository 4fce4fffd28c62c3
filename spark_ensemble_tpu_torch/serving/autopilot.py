"""Closed-loop fleet autopilot (PyTorch port of ``serving/autopilot.py``,
with the same rules, actions and events): watchdog verdicts in, fleet
actions out.

:class:`Autopilot` closes train -> serve -> observe -> train
(docs/autopilot.md) over the port's ``take(k)`` prefixes, the pin-leased
:class:`ModelRegistry`, shadow divergence verdicts and the watchdog:

- **Scale**: a sustained ``serving_p99_ms``/``hedge_rate`` alert or queue
  buildup past ``queue_high`` adds a replica
  (:meth:`FleetRouter.add_replica`, a clone that captures nothing); a
  fully-healthy verdict held for ``calm_ticks`` with shallow queues
  removes one, within ``[min_replicas, max_replicas]``.
- **Refresh**: a ``quality_psi_max`` drift alert triggers a background
  warm-start refresh fit (:func:`spark_ensemble_tpu_torch.serving.export
  .fit_resume` -- the committed rounds are rehydrated, only new rounds
  train, bit-identical to one longer fit), the refreshed model registers
  in the registry as ``<name>@v<N>``, and the fleet rolls onto it
  torn-free via :meth:`FleetRouter.swap_model`.  On CUDA the refresh fit
  runs on a stream of its own (:meth:`Autopilot.refresh_stream`), so the
  fleet's graph replays are not queued behind its kernels, and a graph
  captured meanwhile never takes in the fit's work.  A crashed refresh (chaos ``refresh_crash``)
  leaves the serving model untouched and the next attempt retries from
  the same committed state.
- **Rollback**: a ``shadow_divergence`` alert while a refreshed version is
  serving swaps back to the pinned previous registry version -- the old
  entry was never removed, so rollback is one more rolling swap that
  captures nothing.

Every action is emitted as a ``fleet_action`` telemetry event wrapped in a
span on the ``autopilot`` track whose ``flow_out`` arrow ties the decision
to the ``fleet_swap``/``fleet_scale`` row it caused.

Determinism: :meth:`step` is a pure control-loop tick (probe -> decide ->
act) driven by the caller; ``start()`` merely runs it on a timer thread.
The loop only reads host-side snapshots: no device values, no host syncs.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from spark_ensemble_tpu_torch.robustness.chaos import ChaosPreemption
from spark_ensemble_tpu_torch.serving.engine import side_stream
from spark_ensemble_tpu_torch.telemetry.events import (
    emit_event,
    global_metrics,
    serving_stream_id,
)
from spark_ensemble_tpu_torch.telemetry.trace import Tracer, new_flow_id

__all__ = ["Autopilot"]

#: watchdog rules whose active alert means "the fleet is under-provisioned"
SCALE_UP_RULES = ("serving_p99_ms", "hedge_rate")


def _on_stream(stream, device: torch.device, fn: Callable[[], Any]):
    """``fn()`` on ``stream`` when ``device`` is CUDA (the kernels'
    wrappers launch on the current stream, and the leaf pass keeps a
    workspace per stream), synchronized before the result is handed to
    other threads; on the CPU, just ``fn()``."""
    if device.type != "cuda":
        return fn()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out = fn()
    stream.synchronize()
    return out


class Autopilot:
    """Control loop from watchdog verdicts to fleet actions (module
    docstring; docs/autopilot.md).

    Parameters
    ----------
    router:
        The :class:`~spark_ensemble_tpu_torch.serving.fleet.FleetRouter` under
        control.
    watchdog:
        A :class:`~spark_ensemble_tpu_torch.telemetry.watchdog.Watchdog`; each
        :meth:`step` advances it one ``evaluate_once`` tick (callers that
        run the watchdog's own thread should NOT also start the
        autopilot's, or rules tick twice per interval).
    registry / model_name:
        The :class:`ModelRegistry` hosting the served model (defaults to
        the router's own when built via ``from_registry``).  Needed for
        refresh + rollback; scale actions work without one.
    refresh_data:
        Zero-arg callable returning ``(X, y)`` or ``(X, y, sample_weight)``
        — the ORIGINAL training matrix ``fit_resume`` requires.  No
        callable means drift alerts are observed but not acted on.
    refresh_rounds:
        New rounds per refresh fit.
    min_replicas / max_replicas:
        Elastic-width bounds for scale actions.
    queue_high / queue_low:
        Max per-replica queue depth that triggers scale-up / permits
        scale-down.
    calm_ticks:
        Consecutive fully-healthy steps required before a scale-down (and
        between any two scale actions — flap damping).
    background_refresh:
        ``True`` runs the refresh fit on a daemon thread (serving never
        waits on training); ``False`` runs it inline in :meth:`step`, which
        is what the deterministic chaos battery drives.
    """

    def __init__(
        self,
        router,
        watchdog,
        *,
        registry=None,
        model_name: Optional[str] = None,
        refresh_data: Optional[Callable[[], tuple]] = None,
        refresh_rounds: int = 10,
        min_replicas: int = 1,
        max_replicas: int = 8,
        queue_high: int = 8,
        queue_low: int = 1,
        calm_ticks: int = 3,
        background_refresh: bool = True,
        interval_s: float = 2.0,
        telemetry_path: Optional[str] = None,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got "
                f"[{min_replicas}, {max_replicas}]"
            )
        self._router = router
        self._watchdog = watchdog
        self._registry = registry if registry is not None else getattr(
            router, "_registry", None
        )
        self._model_name = model_name or getattr(
            router, "_registry_name", None
        )
        self._refresh_data = refresh_data
        self._refresh_rounds = int(refresh_rounds)
        self._min_replicas = int(min_replicas)
        self._max_replicas = int(max_replicas)
        self._queue_high = int(queue_high)
        self._queue_low = int(queue_low)
        self._calm_ticks = int(calm_ticks)
        self._background = bool(background_refresh)
        self.interval_s = float(interval_s)
        self._telemetry_path = telemetry_path
        self._stream = serving_stream_id("autopilot")
        self._tracer = Tracer(self._emit_trace, thread="autopilot")
        self._metrics = global_metrics()
        self._lock = threading.Lock()
        self._steps = 0
        self._calm = 0
        self._last_scale_step = -(10**9)
        self._refresh_generation = 0
        self._refresh_streams: Dict[int, Any] = {}
        self._refresh_inflight = False
        self._refresh_thread: Optional[threading.Thread] = None
        # rollback pin: the registry name serving BEFORE the last refresh
        # swap; consumed (cleared) by one rollback
        self._rollback_name: Optional[str] = None
        #: every action record this autopilot ever took (tests + statusz)
        self.actions: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- telemetry ---------------------------------------------------------

    def _emit_trace(self, rec: Dict[str, Any]) -> None:
        rec = dict(rec)
        emit_event(
            rec.pop("event"), path=self._telemetry_path,
            fit_id=self._stream, **rec,
        )

    def _act(self, action: str, trigger: str, fn, **attrs) -> Dict[str, Any]:
        """Run one fleet action inside a ``fleet_action`` span whose flow
        arrow points at the swap/scale row it causes; the matching event
        row carries the same fields (docs/telemetry.md)."""
        fid = new_flow_id()
        record: Dict[str, Any] = {
            "action": action, "trigger": trigger, "flow": fid, **attrs,
        }
        span = self._tracer.begin_span(
            "fleet_action", annotate=False, action=action, trigger=trigger,
        )
        span.attrs.setdefault("flow_out", []).append(fid)
        with span:
            try:
                result = fn()
                record["status"] = "ok"
                if isinstance(result, dict):
                    record.update(result)
                elif result is not None:
                    record["result"] = result
            except ChaosPreemption as e:
                # a killed refresh fit: serving model untouched, retryable
                record["status"] = "failed"
                record["error"] = str(e)
            except Exception as e:  # noqa: BLE001 - autopilot never crashes serving
                record["status"] = "failed"
                record["error"] = f"{type(e).__name__}: {e}"
            span.add(status=record["status"])
        with self._lock:
            self.actions.append(record)
        emit_event(
            "fleet_action", path=self._telemetry_path,
            fit_id=self._stream, **record,
        )
        self._metrics.counter(f"autopilot/{action}").inc()
        return record

    # -- the control loop --------------------------------------------------

    def step(self, snapshot: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
        """One deterministic tick: advance the watchdog, read the fleet's
        queue state, decide, act.  Returns the action records taken this
        tick (empty list = healthy steady state)."""
        readings = self._watchdog.evaluate_once(snapshot)
        slo = self._router.slo_snapshot()
        depth = max(
            (r["queue_depth"] for r in slo["replicas"].values()), default=0
        )
        n_replicas = len(slo["replicas"])
        taken: List[Dict[str, Any]] = []
        with self._lock:
            self._steps += 1
            step = self._steps
        active = {
            name for name, r in readings.items() if r.get("active")
        }
        healthy = not active and depth <= self._queue_low
        with self._lock:
            self._calm = self._calm + 1 if healthy else 0
            calm = self._calm
            cooled = step - self._last_scale_step > self._calm_ticks

        # -- rollback first: a diverging candidate outranks everything ----
        if "shadow_divergence" in active and self._rollback_name is not None:
            name, self._rollback_name = self._rollback_name, None
            taken.append(self._act(
                "rollback", "shadow_divergence",
                lambda: self._router.swap_model(name),
                value=readings["shadow_divergence"]["value"],
                threshold=readings["shadow_divergence"]["threshold"],
                target=name,
            ))

        # -- refresh: sustained drift retrains the tail, not the prefix ----
        elif "quality_psi_max" in active and self._refresh_data is not None:
            with self._lock:
                start = not self._refresh_inflight
                if start:
                    self._refresh_inflight = True
            if start:
                if self._background:
                    t = threading.Thread(
                        target=self._refresh,
                        args=(readings["quality_psi_max"],),
                        name="se-torch-autopilot-refresh",
                        daemon=True,
                    )
                    self._refresh_thread = t
                    t.start()
                else:
                    taken.append(self._refresh(readings["quality_psi_max"]))

        # -- elastic width --------------------------------------------------
        pressured = bool(active & set(SCALE_UP_RULES)) or depth >= self._queue_high
        if pressured and n_replicas < self._max_replicas and cooled:
            with self._lock:
                self._last_scale_step = step
            trigger = next(
                (r for r in SCALE_UP_RULES if r in active), "queue_depth"
            )
            taken.append(self._act(
                "scale_up", trigger, self._router.add_replica,
                queue_depth=depth, replicas=n_replicas + 1,
            ))
        elif (
            n_replicas > self._min_replicas
            and calm >= self._calm_ticks
            and cooled
        ):
            with self._lock:
                self._last_scale_step = step
                self._calm = 0
            taken.append(self._act(
                "scale_down", "calm", self._router.remove_replica,
                queue_depth=depth, replicas=n_replicas - 1,
            ))
        return taken

    def refresh_stream(self, device: torch.device):
        """The CUDA stream this autopilot's refresh fits run on for
        ``device`` (None on the CPU), made once.  It is never the stream
        that graph captures run on, so a registry may warm the refreshed
        model, or re-activate an evicted one, while a refresh fits."""
        device = torch.device(device)
        if device.type != "cuda":
            return None
        index = device.index if device.index is not None else torch.cuda.current_device()
        with self._lock:
            stream = self._refresh_streams.get(index)
            if stream is None:
                stream = side_stream(device)
                self._refresh_streams[index] = stream
        return stream

    def _refresh(self, reading: Dict[str, Any]) -> Dict[str, Any]:
        """The drift response: warm-start ``fit_resume`` on the served
        model's committed rounds, register the result as a NEW registry
        version, and roll the fleet onto it.  The previous version's name
        is pinned for rollback; a chaos ``refresh_crash`` mid-fit aborts
        before anything registers, leaving the serving model untouched."""
        from spark_ensemble_tpu_torch.serving.export import fit_resume

        def run():
            data = self._refresh_data()
            X, y = data[0], data[1]
            sw = data[2] if len(data) > 2 else None
            packed = self._router._base.packed
            stream = self.refresh_stream(packed.device)
            new_packed = _on_stream(stream, packed.device, lambda: fit_resume(
                packed, X, y, self._refresh_rounds, sample_weight=sw
            ))
            with self._lock:
                self._refresh_generation += 1
                gen = self._refresh_generation
            base = self._model_name or "fleet"
            new_name = f"{base.split('@')[0]}@v{gen}"
            if self._registry is not None:
                self._registry.register(new_name, new_packed, warm=True)
                prev = getattr(self._router, "_registry_name", None)
                info = self._router.swap_model(new_name)
                with self._lock:
                    self._rollback_name = prev
                self._model_name = new_name
            else:
                info = self._router.swap_model(new_packed, name=new_name)
            return {
                "model": new_name,
                "new_rounds": self._refresh_rounds,
                "members": new_packed.num_members,
                **{f"swap_{k}" if not k.startswith("swap") else k: v
                   for k, v in info.items()},
            }

        try:
            return self._act(
                "refresh", "quality_psi_max", run,
                value=reading.get("value"),
                threshold=reading.get("threshold"),
            )
        finally:
            with self._lock:
                self._refresh_inflight = False

    # -- lifecycle / introspection -----------------------------------------

    def statusz(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "steps": self._steps,
                "calm": self._calm,
                "refresh_inflight": self._refresh_inflight,
                "refresh_generation": self._refresh_generation,
                "rollback_pin": self._rollback_name,
                "bounds": [self._min_replicas, self._max_replicas],
                "actions": list(self.actions),
            }

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 - the pilot never downs the plane
                pass

    def start(self) -> "Autopilot":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="se-torch-autopilot", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        rt = self._refresh_thread
        if rt is not None and rt.is_alive():
            rt.join(timeout=60.0)

    def __enter__(self) -> "Autopilot":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def join_refresh(self, timeout: Optional[float] = None) -> bool:
        """Wait for an in-flight background refresh (tests / shutdown);
        returns True when no refresh is running afterwards."""
        rt = self._refresh_thread
        if rt is not None and rt.is_alive():
            rt.join(timeout=timeout)
        with self._lock:
            return not self._refresh_inflight
