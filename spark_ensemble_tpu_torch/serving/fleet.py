"""Resilient serving fleet (PyTorch port of ``serving/fleet.py``, with the
same methods, events, chaos sites and ``slo_snapshot()`` keys):
replicated engines, health-checked routing, hedged retries, and graceful
ensemble-prefix degradation.

A single :class:`InferenceEngine` has no failure story: one stalled worker
or one slow reply stalls every caller behind it.  :class:`FleetRouter` puts
a fault-tolerance tier above the engine:

- **Replication without re-capture**: N replicas are
  :meth:`InferenceEngine.clone`\\ s of one warmed engine -- each has its
  own request queue and worker thread, but all share the same CUDA graphs
  and device tensors, so fleet warmup costs O(methods x buckets x tiers),
  not x N, and steady-state serving captures nothing.  The clones share
  each graph's replay lock, so replicas serialize their replays of one
  graph on the card; chaos stalls and slow replies sleep outside it.
- **Health-checked routing**: requests go to the live replica with the
  shallowest queue.  Every replica runs a circuit breaker
  (``healthy -> degraded -> ejected -> half_open``): failures degrade it,
  a failure streak or an injected crash ejects it, and after a
  :class:`~spark_ensemble_tpu_torch.robustness.retry.RetryPolicy` backoff
  a single half-open probe request decides re-admission.
- **Hedged retries under a deadline budget**: every request carries a
  deadline; if the first dispatch has not replied by the live p99 latency
  estimate, a second dispatch fires on another replica and the first
  completion wins (duplicate completions are dropped at the Future, never
  delivered twice).
- **Graceful ensemble-prefix degradation**: boosted ensembles are
  stagewise, so the first k rounds of a GBM ARE a valid (bit-identical to
  a k-round fit) cheaper model -- :meth:`PackedModel.take`.  Under deadline
  pressure or queue buildup the router serves a pre-captured prefix tier
  and marks the response ``degraded=True`` instead of shedding; a staged
  load-shedder (:class:`FleetOverloadError`) is the last resort.
- **Crash semantics**: a replica death (chaos ``replica_crash`` or
  :meth:`kill_replica`) drains that replica's queue and replays every
  unanswered request on a healthy replica -- zero lost and zero duplicated
  responses.
- **Torn-free hot swap + elastic width**: :meth:`swap_model` replaces the
  served model replica-by-replica under live traffic -- each replica
  leaves rotation, drains, rebinds to a clone of the new (already warmed)
  engine, and re-admits -- so every response is computed entirely by
  exactly one model version and a registry-leased swap captures nothing.
  :meth:`add_replica` / :meth:`remove_replica` resize the fleet the same
  way, and ``serving/autopilot.py`` drives all three from watchdog
  verdicts.

The fleet serves on the device of the packed model it is given (CUDA
unless the caller packed on the CPU); a CUDA model with no card raises, as
the engine does.  Per-replica SLO telemetry flows through the serving
event stream (``fleet_request`` / ``replica_state`` / ``hedge_fired`` /
``request_shed`` / ``fleet_slo`` / ``fleet_swap`` / ``fleet_scale``), and
the whole state machine is deterministically drivable via the chaos
serving faults (``replica_stall`` / ``replica_crash`` / ``slow_reply`` /
``swap_crash`` / ``scale_crash``; docs/fleet.md).
"""

from __future__ import annotations

import collections
import dataclasses
import queue as queue_mod
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from spark_ensemble_tpu_torch.robustness.chaos import ChaosReplicaCrash, controller
from spark_ensemble_tpu_torch.robustness.retry import RetryPolicy
from spark_ensemble_tpu_torch.serving.engine import InferenceEngine
from spark_ensemble_tpu_torch.telemetry.quality import staged_attribution
from spark_ensemble_tpu_torch.telemetry.events import (
    compile_snapshot,
    emit_event,
    global_metrics,
    serving_stream_id,
    telemetry_sink_active,
)
from spark_ensemble_tpu_torch.telemetry.trace import NULL_SPAN, Tracer, new_flow_id

__all__ = [
    "REPLICA_STATES",
    "FleetDeadlineError",
    "FleetOverloadError",
    "FleetResponse",
    "FleetRouter",
]

REPLICA_STATES = ("healthy", "degraded", "ejected", "half_open", "swapping")

_SHUTDOWN = object()
_KILL = object()


class FleetOverloadError(RuntimeError):
    """Staged shedding's last resort: every degradation lever (hedging,
    prefix tiers) is exhausted and queues are still past ``shed_depth`` —
    or no live replica exists to route to."""


class FleetDeadlineError(TimeoutError):
    """A synchronous :meth:`FleetRouter.predict` wait outlived its grace
    window (``deadline_ms x deadline_grace``) with no replica reply."""


@dataclasses.dataclass
class FleetResponse:
    """One served request: the prediction plus how it was served.

    ``degraded`` is the explicit contract flag: ``True`` iff the value was
    computed by an ensemble-prefix tier (``tier`` = member count) rather
    than the full model.

    The quality fields are populated only for attribution-sampled requests
    (``attribution_fraction``; telemetry/quality.py): ``staged_margins``
    maps each prefix-tier member count to its disagreement with the full
    model, ``uncertainty`` is the max disagreement (per-member
    disagreement score), and ``quality_flagged`` marks it crossing the
    router's ``uncertainty_threshold``."""

    value: np.ndarray
    tier: int
    degraded: bool
    replica: str
    hedged: bool
    replays: int
    latency_ms: float
    uncertainty: Optional[float] = None
    staged_margins: Optional[Dict[str, float]] = None
    quality_flagged: bool = False
    # model generation that computed this value (bumped by swap_model);
    # the torn-free contract: exactly ONE version per response, ever
    version: int = 0


class _FleetRequest:
    __slots__ = (
        "seq", "X", "method", "tier", "deadline_at", "t_submit",
        "future", "outstanding", "replays", "hedged", "hedge_timer",
        "primary", "span", "flow_in",
    )

    def __init__(self, seq, X, method, tier, deadline_at, t_submit):
        self.seq = seq
        self.X = X
        self.method = method
        self.tier = tier
        self.deadline_at = deadline_at
        self.t_submit = t_submit
        self.future: Future = Future()
        self.outstanding = 0   # dispatches not yet succeeded/failed
        self.replays = 0
        self.hedged = False
        self.hedge_timer: Optional[threading.Timer] = None
        self.primary: Optional[str] = None
        # causal tracing (telemetry/trace.py): the request's span on the
        # router track, and a (replica_name, flow_id) pair the NEXT serve
        # on that replica consumes as its incoming hedge/replay arrow
        self.span = NULL_SPAN
        self.flow_in: Optional[Tuple[str, int]] = None


class _Replica:
    __slots__ = (
        "name", "engine", "queue", "worker", "state", "inflight",
        "fail_streak", "slow_streak", "ok_streak", "ejections",
        "reopen_at", "probing", "served", "failed", "latencies",
        "transitions", "version",
    )

    def __init__(self, name: str, engine: InferenceEngine, version: int = 0):
        self.name = name
        self.engine = engine
        self.version = version
        self.queue: "queue_mod.SimpleQueue" = queue_mod.SimpleQueue()
        self.worker: Optional[threading.Thread] = None
        self.state = "healthy"
        self.inflight = 0          # dispatched to this replica, unanswered
        self.fail_streak = 0
        self.slow_streak = 0
        self.ok_streak = 0
        self.ejections = 0
        self.reopen_at = 0.0       # monotonic time the breaker half-opens
        self.probing = False
        self.served = 0
        self.failed = 0
        self.latencies: "collections.deque" = collections.deque(maxlen=512)
        self.transitions = 0


def _quantile_ms(window, q: float, default_ms: float) -> float:
    if not window:
        return default_ms
    xs = sorted(window)
    i = min(int(q * len(xs)), len(xs) - 1)
    return xs[i]


class FleetRouter:
    """Route requests across N replicated engines with breakers, hedging,
    and prefix degradation (see module docstring).

    Parameters
    ----------
    model:
        A fitted model, :class:`PackedModel`, or an already-warmed
        :class:`InferenceEngine` (e.g. from a shared
        :class:`~spark_ensemble_tpu_torch.serving.registry.ModelRegistry` via
        :meth:`from_registry`).  Anything else is packed and warmed here.
    replicas:
        Replica count; each is a :meth:`clone` sharing the warm programs.
    prefix_tiers:
        Ensemble-prefix tiers to pre-warm for degradation (ignored when
        ``model`` is an engine — its tiers are used).  One or two tiers
        give the staged ladder: mild pressure serves the largest prefix,
        severe pressure the smallest.
    deadline_ms:
        Default per-request deadline budget: drives tier selection at
        dispatch, the hedge-timer clamp, and the sync-predict grace wait.
    hedge_init_ms:
        Hedge-timer seed before any latency history exists; afterwards the
        timer fires at the live p99 estimate.
    degrade_depth / shed_depth:
        Queue-depth stages: past ``degrade_depth`` requests serve prefix
        tiers; past ``shed_depth`` they shed (:class:`FleetOverloadError`).
    eject_after / recover_after / slow_ms / slow_streak_limit:
        Breaker tuning: consecutive failures to eject, consecutive
        successes to re-promote a degraded replica, and what counts as a
        slow serve (a streak of which degrades).
    breaker_backoff:
        :class:`RetryPolicy` whose deterministic ``delay(replica, n)``
        schedules the n-th ejection's half-open probe.
    drift / drift_window:
        Forwarded to the base :class:`InferenceEngine` when the fleet
        builds it: on-device feature-drift sketching over the packed
        model's fit-time bin reference (telemetry/quality.py).  All
        replicas share one :class:`DriftMonitor`, so the window stream is
        fleet-wide.  Ignored when ``model`` is already an engine.
    attribution_fraction / uncertainty_threshold:
        Staged attribution sampling: every ``1/fraction``-th full-model
        request is decomposed over the prefix tiers (deterministic
        ``seq``-based sampling, no RNG) and its ``FleetResponse`` carries
        ``staged_margins`` / ``uncertainty`` / ``quality_flagged``.
        ``0.0`` (default) keeps the serve path at exactly one program
        replay per request.
    shadow:
        Optional :class:`~spark_ensemble_tpu_torch.telemetry.quality
        .ShadowScorer`; sees every delivered full-tier request AFTER the
        reply resolves (sampling happens inside the scorer).  The caller
        owns its lifecycle (``close()``).
    """

    def __init__(
        self,
        model,
        *,
        replicas: int = 2,
        methods: Tuple[str, ...] = ("predict",),
        prefix_tiers: Tuple[int, ...] = (),
        min_bucket: int = 8,
        max_batch_size: int = 256,
        deadline_ms: float = 250.0,
        deadline_grace: float = 4.0,
        hedge_init_ms: float = 25.0,
        hedge_min_ms: float = 1.0,
        degrade_depth: int = 8,
        shed_depth: int = 64,
        max_replays: Optional[int] = None,
        eject_after: int = 3,
        recover_after: int = 8,
        slow_ms: float = 250.0,
        slow_streak_limit: int = 3,
        breaker_backoff: Optional[RetryPolicy] = None,
        donate: Optional[bool] = None,
        label: str = "fleet",
        telemetry_path: Optional[str] = None,
        drift: Optional[bool] = None,
        drift_window: int = 2048,
        attribution_fraction: float = 0.0,
        uncertainty_threshold: float = 0.5,
        shadow=None,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1; got {replicas}")
        if not (0.0 <= float(attribution_fraction) <= 1.0):
            raise ValueError(
                "attribution_fraction must be in [0, 1]; got "
                f"{attribution_fraction}"
            )
        # a router-built base engine is router-owned: stop() must stop it
        # so its drift monitor's quality/* source dies with the fleet (an
        # injected engine stays caller-owned, e.g. from_registry leases)
        self._owns_base = not isinstance(model, InferenceEngine)
        if isinstance(model, InferenceEngine):
            base = model
        else:
            base = InferenceEngine(
                model,
                methods=methods,
                prefix_tiers=prefix_tiers,
                min_bucket=min_bucket,
                max_batch_size=max_batch_size,
                donate=donate,
                warm=True,
                label=f"{label}:warm",
                telemetry_path=telemetry_path,
                drift=drift,
                drift_window=drift_window,
            )
        self._base = base
        self._tiers = base.prefix_tiers  # ascending member counts
        self._deadline_s = float(deadline_ms) / 1e3
        self._deadline_grace = float(deadline_grace)
        self._hedge_init_s = float(hedge_init_ms) / 1e3
        self._hedge_min_s = float(hedge_min_ms) / 1e3
        self._degrade_depth = int(degrade_depth)
        self._shed_depth = int(shed_depth)
        self._max_replays = (
            int(max_replays) if max_replays is not None else int(replicas)
        )
        self._eject_after = int(eject_after)
        self._recover_after = int(recover_after)
        self._slow_s = float(slow_ms) / 1e3
        self._slow_streak_limit = int(slow_streak_limit)
        self._backoff = breaker_backoff or RetryPolicy(
            max_retries=0, base_delay=0.25, max_delay=5.0
        )
        self._label = label
        self._telemetry_path = telemetry_path
        self._stream = serving_stream_id(label)
        self._tracer = Tracer(self._emit_trace, thread="router")
        self._t_start = time.time()
        self._metrics = global_metrics()
        # live statusz/SLO source: MetricsRegistry.snapshot() pulls this
        # router's counters on demand (one-stop process snapshot)
        self._source_name = f"fleet/{self._stream}"
        self._metrics.register_source(self._source_name, self.slo_snapshot)
        self._lock = threading.Lock()
        # control-plane lock: serializes swap_model/add_replica/
        # remove_replica against each other (the hot `_lock` is never held
        # across a rebind's quiesce wait)
        self._ctl_lock = threading.Lock()
        self._seq = 0
        self._version = 0
        self._next_replica_idx = int(replicas)
        self._stopped = False
        self._registry = None
        self._registry_name = None
        self._registry_release = None
        self._window: "collections.deque" = collections.deque(maxlen=256)
        self._counters = {
            "requests": 0, "hedges_fired": 0, "hedges_won": 0,
            "shed": 0, "degraded": 0, "replays": 0, "crashes": 0,
            "attributed": 0, "quality_flagged": 0,
            "swaps": 0, "scale_ups": 0, "scale_downs": 0,
        }
        # model-quality plane (telemetry/quality.py, docs/quality.md):
        # every 1/attribution_fraction-th full-model request is decomposed
        # over the pre-warmed prefix tiers (staged margins + per-member
        # disagreement as uncertainty).  Attribution is the ONE quality
        # layer that adds dispatches (one per tier, all pre-warmed), which
        # is why it defaults off; the drift sketch rides inside the predict
        # programs and the shadow scorer samples after delivery.
        self._attr_period = (
            max(1, int(round(1.0 / float(attribution_fraction))))
            if float(attribution_fraction) > 0.0
            else 0
        )
        self._uncertainty_threshold = float(uncertainty_threshold)
        self._shadow = shadow
        self._replicas = [
            _Replica(f"{label}:r{i}", base.clone(f"{label}:r{i}"))
            for i in range(int(replicas))
        ]
        for rep in self._replicas:
            self._ensure_worker(rep)
        # warm boundary for the zero-steady-state-compile contract: every
        # program (full + prefix tiers) exists before the first request
        self._warm_snapshot = compile_snapshot()

    # -- registry integration ----------------------------------------------

    @classmethod
    def from_registry(cls, registry, name: str, **opts) -> "FleetRouter":
        """A fleet over a :class:`ModelRegistry` entry, sharing its warmed
        engine's compiled programs and pinning the entry against LRU
        eviction until :meth:`stop` (the registry's lease machinery — a
        hot-swap cannot free buffers under a live fleet)."""
        engine = registry._acquire(name)
        try:
            router = cls(engine, **opts)
        except BaseException:
            registry._release(name)
            raise
        router._registry = registry
        router._registry_name = name
        router._registry_release = lambda: registry._release(name)
        return router

    # -- routing -----------------------------------------------------------

    def _emit_trace(self, rec: Dict[str, Any]) -> None:
        # span chokepoint: spans ride the same standalone-event sinks as
        # the fleet's SLO events, tagged with this router's stream id
        rec = dict(rec)
        emit_event(
            rec.pop("event"), path=self._telemetry_path,
            fit_id=self._stream, **rec,
        )

    def _set_state(self, rep: _Replica, state: str, reason: str) -> None:
        # called under self._lock; telemetry goes out band via a timer-free
        # emit (file append) — cheap enough to keep transitions atomic
        prev, rep.state = rep.state, state
        if prev == state:
            return
        rep.transitions += 1
        emit_event(
            "replica_state",
            path=self._telemetry_path,
            fit_id=self._stream,
            replica=rep.name,
            state=state,
            prev=prev,
            reason=reason,
            ejections=rep.ejections,
        )
        self._metrics.counter("fleet/breaker_transitions").inc()

    def _pick(self, exclude: Set[str]) -> Optional[_Replica]:
        """Routing policy, called under ``self._lock``: due half-open
        probes first (one request decides re-admission), then the
        shallowest healthy queue; degraded replicas stay in rotation with
        a depth penalty so a lone healthy replica is not overloaded."""
        now = time.monotonic()
        for rep in self._replicas:
            if rep.state == "ejected" and now >= rep.reopen_at:
                self._set_state(rep, "half_open", "backoff elapsed")
                rep.probing = False
        for rep in self._replicas:
            if (
                rep.state == "half_open"
                and not rep.probing
                and rep.name not in exclude
            ):
                rep.probing = True
                self._ensure_worker(rep)
                return rep
        cands = [
            (rep.inflight + (4 if rep.state == "degraded" else 0), i, rep)
            for i, rep in enumerate(self._replicas)
            if rep.state in ("healthy", "degraded")
            and rep.name not in exclude
        ]
        if not cands:
            return None
        return min(cands)[2]

    def _choose_tier(self, remaining_s: float, depth: int) -> int:
        """Staged degradation: mild pressure serves the largest prefix,
        severe pressure the smallest; no tiers configured means the full
        model always (shedding is then the only pressure valve)."""
        if not self._tiers:
            return 0
        p99 = self._p99_s()
        severe = (
            remaining_s < 0.5 * p99 or depth >= 2 * self._degrade_depth
        )
        moderate = remaining_s < p99 or depth >= self._degrade_depth
        if severe:
            return self._tiers[0]
        if moderate:
            return self._tiers[-1]
        return 0

    def _p99_s(self) -> float:
        return _quantile_ms(self._window, 0.99, self._hedge_init_s * 1e3) / 1e3

    def _dispatch(self, req: _FleetRequest, rep: _Replica) -> None:
        # called under self._lock
        rep.inflight += 1
        req.outstanding += 1
        rep.queue.put(req)

    def submit(
        self,
        X,
        method: str = "predict",
        deadline_ms: Optional[float] = None,
    ) -> Future:
        """Route a request; the Future resolves to a :class:`FleetResponse`
        (or raises: shed, no live replica, or replay budget exhausted)."""
        if self._stopped:
            raise RuntimeError("fleet is stopped")
        # validate shape HERE: a malformed request must fail the caller,
        # not look like a replica fault and trip its breaker (a tensor on
        # any device is copied to the host once, here)
        Xa, single = self._base._normalize(X)
        deadline_s = (
            self._deadline_s if deadline_ms is None else float(deadline_ms) / 1e3
        )
        t0 = time.perf_counter()
        with self._lock:
            self._seq += 1
            self._counters["requests"] += 1
            rep = self._pick(exclude=set())
            if rep is None:
                self._counters["shed"] += 1
                shed_reason = "no live replica"
            elif rep.inflight >= self._shed_depth:
                self._counters["shed"] += 1
                shed_reason = f"queue depth {rep.inflight} >= {self._shed_depth}"
            else:
                shed_reason = None
                tier = self._choose_tier(deadline_s, rep.inflight)
                req = _FleetRequest(
                    self._seq, Xa[0] if single else Xa, method, tier,
                    t0 + deadline_s, t0,
                )
                req.primary = rep.name
                if telemetry_sink_active(self._telemetry_path):
                    # root of this request's causal tree on the router
                    # track; ends in _resolve/_fail — on a worker thread,
                    # so no same-thread profiler annotation
                    req.span = self._tracer.begin_span(
                        "fleet_request", annotate=False,
                        seq=self._seq, method=method, tier=tier,
                    )
                self._dispatch(req, rep)
        if shed_reason is not None:
            emit_event(
                "request_shed",
                path=self._telemetry_path,
                fit_id=self._stream,
                reason=shed_reason,
            )
            self._metrics.counter("fleet/shed").inc()
            raise FleetOverloadError(f"request shed: {shed_reason}")
        self._arm_hedge(req, deadline_s)
        return req.future

    def predict(
        self,
        X,
        method: str = "predict",
        deadline_ms: Optional[float] = None,
    ) -> FleetResponse:
        """Synchronous :meth:`submit`; waits up to ``deadline x grace``
        then raises :class:`FleetDeadlineError`."""
        deadline_s = (
            self._deadline_s if deadline_ms is None else float(deadline_ms) / 1e3
        )
        fut = self.submit(X, method=method, deadline_ms=deadline_s * 1e3)
        try:
            return fut.result(timeout=deadline_s * self._deadline_grace)
        except (_FutureTimeout, TimeoutError) as e:  # distinct until 3.11
            raise FleetDeadlineError(
                f"no reply within {deadline_s * self._deadline_grace:.3f}s "
                f"(deadline {deadline_s:.3f}s x grace {self._deadline_grace})"
            ) from e

    # -- hedging -----------------------------------------------------------

    def _arm_hedge(self, req: _FleetRequest, deadline_s: float) -> None:
        if len(self._replicas) < 2:
            return
        hedge_s = min(max(self._p99_s(), self._hedge_min_s), 0.8 * deadline_s)
        timer = threading.Timer(hedge_s, self._fire_hedge, args=(req,))
        timer.daemon = True
        req.hedge_timer = timer
        timer.start()

    def _fire_hedge(self, req: _FleetRequest) -> None:
        if req.future.done():
            return
        with self._lock:
            if req.hedged or req.future.done():
                return
            rep = self._pick(exclude={req.primary} if req.primary else set())
            if rep is None:
                return
            req.hedged = True
            self._counters["hedges_fired"] += 1
            fid = None
            if req.span:
                # flow arrow request-span -> the hedge twin's serve span
                fid = new_flow_id()
                req.span.attrs.setdefault("flow_out", []).append(fid)
                req.flow_in = (rep.name, fid)
            self._dispatch(req, rep)
        emit_event(
            "hedge_fired",
            path=self._telemetry_path,
            fit_id=self._stream,
            seq=req.seq,
            primary=req.primary,
            hedge=rep.name,
            flow=fid,
        )
        self._metrics.counter("fleet/hedges").inc()

    # -- replica workers ---------------------------------------------------

    def _ensure_worker(self, rep: _Replica) -> None:
        if rep.worker is None or not rep.worker.is_alive():
            rep.worker = threading.Thread(
                target=self._worker_loop,
                args=(rep,),
                name=f"se-torch-{rep.name}",
                daemon=True,
            )
            rep.worker.start()

    def _worker_loop(self, rep: _Replica) -> None:
        while True:
            item = rep.queue.get()
            if item is _SHUTDOWN:
                return
            if item is _KILL:
                self._on_crash(rep, None, ChaosReplicaCrash("killed"))
                return
            req: _FleetRequest = item
            if req.future.done():
                with self._lock:
                    rep.inflight -= 1
                    req.outstanding -= 1
                continue
            try:
                self._serve_on(rep, req)
            except ChaosReplicaCrash as e:
                self._on_crash(rep, req, e)
                return
            except Exception as e:  # breaker food, never a worker death
                if self._on_failure(rep, req, e):
                    return

    def _serve_on(self, rep: _Replica, req: _FleetRequest) -> None:
        # a hedge/replay flow arrow targets ONE replica: only the serve
        # that actually runs on it consumes the arrow (the original
        # dispatch on the primary must not claim a hedge's flow id)
        fid = None
        fe = req.flow_in
        if fe is not None and fe[0] == rep.name:
            fid = fe[1]
            req.flow_in = None
        serve_sp = (
            self._tracer.begin_span(
                "serve", parent=req.span, thread=rep.name, annotate=False,
                seq=req.seq, replica=rep.name, tier=req.tier,
                flow_in=fid,
            )
            if req.span else NULL_SPAN
        )
        with serve_sp:
            self._serve_on_inner(rep, req, serve_sp)

    def _serve_on_inner(
        self, rep: _Replica, req: _FleetRequest, serve_sp
    ) -> None:
        ctrl = controller()
        site = f"{self._label}:{rep.name}:req{req.seq}"
        # snapshot the bound engine + version ONCE: the whole serve — the
        # predict AND any staged attribution — runs against one model
        # generation even if a rolling swap rebinds the replica meanwhile
        # (it cannot while this serve is in flight, but the single read
        # makes the no-torn-response invariant structural, not scheduled)
        eng = rep.engine
        version = rep.version
        stall = ctrl.stall_s(site)
        if stall:
            time.sleep(stall)  # a stuck replica: hedge timer's territory
        ctrl.crash(site)  # may raise ChaosReplicaCrash
        t0 = time.perf_counter()
        out = eng.predict(req.X, method=req.method, tier=req.tier)
        slow = ctrl.slow_s(site)
        if slow:
            time.sleep(slow)  # alive but slow: breaker's slow streak
        serve_s = time.perf_counter() - t0
        # staged attribution (telemetry/quality.py): sampled full-model
        # requests are decomposed over the pre-warmed prefix tiers BEFORE
        # delivery, so the caller's FleetResponse carries the fields
        attribution = None
        if (
            self._attr_period
            and req.tier == 0
            and self._tiers
            and req.seq % self._attr_period == 0
        ):
            attribution = staged_attribution(
                eng, req.X, method=req.method,
                uncertainty_threshold=self._uncertainty_threshold,
                full=out,
            )
            self._metrics.histogram("quality/uncertainty").record(
                attribution["uncertainty"]
            )
            with self._lock:
                self._counters["attributed"] += 1
                if attribution["flagged"]:
                    self._counters["quality_flagged"] += 1
        now = time.perf_counter()
        resp = FleetResponse(
            value=out,
            tier=req.tier,
            degraded=req.tier != 0,
            replica=rep.name,
            hedged=req.hedged,
            replays=req.replays,
            latency_ms=(now - req.t_submit) * 1e3,
            uncertainty=(
                attribution["uncertainty"] if attribution else None
            ),
            staged_margins=(
                attribution["margins"] if attribution else None
            ),
            quality_flagged=(
                attribution["flagged"] if attribution else False
            ),
            version=version,
        )
        delivered = self._resolve(req, resp)
        if delivered and self._shadow is not None and req.tier == 0:
            # shadow scoring rides AFTER delivery: the candidate's eval can
            # never add latency to the answer the caller already has
            try:
                self._shadow.observe(req.X, out, request_id=req.seq)
            except Exception:  # noqa: BLE001 - quality plane never breaks serving
                pass
        serve_sp.add(delivered=delivered, serve_ms=serve_s * 1e3)
        with self._lock:
            rep.inflight -= 1
            req.outstanding -= 1
            rep.served += 1
            rep.fail_streak = 0
            rep.latencies.append(serve_s * 1e3)
            if delivered:
                self._window.append(resp.latency_ms)
                if resp.degraded:
                    self._counters["degraded"] += 1
                if resp.hedged and req.primary != rep.name:
                    self._counters["hedges_won"] += 1
            if serve_s + (slow or 0.0) > self._slow_s:
                rep.slow_streak += 1
                rep.ok_streak = 0
                if (
                    rep.state == "healthy"
                    and rep.slow_streak >= self._slow_streak_limit
                ):
                    self._set_state(rep, "degraded", "slow streak")
            else:
                rep.slow_streak = 0
                rep.ok_streak += 1
                if rep.state == "half_open":
                    rep.probing = False
                    rep.ejections = 0
                    self._set_state(rep, "healthy", "probe succeeded")
                elif (
                    rep.state == "degraded"
                    and rep.ok_streak >= self._recover_after
                ):
                    self._set_state(rep, "healthy", "recovered")
        if delivered:
            emit_event(
                "fleet_request",
                path=self._telemetry_path,
                fit_id=self._stream,
                seq=req.seq,
                replica=rep.name,
                method=req.method,
                rows=int(np.shape(req.X)[0]) if np.ndim(req.X) > 1 else 1,
                tier=req.tier,
                degraded=resp.degraded,
                hedged=resp.hedged,
                replays=req.replays,
                latency_ms=resp.latency_ms,
                version=resp.version,
                # attribution-sampled requests carry their uncertainty so
                # telemetry_report can quantile it offline
                **(
                    {
                        "uncertainty": resp.uncertainty,
                        "quality_flagged": resp.quality_flagged,
                    }
                    if resp.uncertainty is not None
                    else {}
                ),
            )
            self._metrics.counter("fleet/requests").inc()
            self._metrics.histogram("fleet/latency_ms").record(
                resp.latency_ms
            )

    def _resolve(self, req: _FleetRequest, resp: FleetResponse) -> bool:
        try:
            req.future.set_result(resp)
        except InvalidStateError:
            return False  # the other dispatch won; drop, never duplicate
        if req.hedge_timer is not None:
            req.hedge_timer.cancel()
        req.span.end(
            replica=resp.replica, hedged=resp.hedged, replays=resp.replays,
            degraded=resp.degraded, latency_ms=resp.latency_ms,
        )
        return True

    # -- failure / crash handling ------------------------------------------

    def _eject(self, rep: _Replica, reason: str) -> None:
        # called under self._lock
        rep.ejections += 1
        rep.probing = False
        rep.reopen_at = time.monotonic() + self._backoff.delay(
            rep.name, rep.ejections
        )
        self._set_state(rep, "ejected", reason)

    def _drain(self, rep: _Replica) -> List[_FleetRequest]:
        # called under self._lock: pull every queued request off a dead
        # replica so it can be replayed elsewhere
        drained: List[_FleetRequest] = []
        while True:
            try:
                item = rep.queue.get_nowait()
            except queue_mod.Empty:
                return drained
            if item in (_SHUTDOWN, _KILL):
                continue
            rep.inflight -= 1
            item.outstanding -= 1
            drained.append(item)

    def _redispatch(
        self, req: _FleetRequest, exclude: Set[str], error: BaseException
    ) -> None:
        # called under self._lock
        if req.future.done():
            return
        if req.replays >= self._max_replays:
            self._fail(req, error)
            return
        rep = self._pick(exclude)
        if rep is None and exclude:
            rep = self._pick(set())  # better a suspect replica than a loss
        if rep is None:
            if req.outstanding <= 0:
                self._fail(
                    req, FleetOverloadError("no live replica to replay on")
                )
            return
        req.replays += 1
        self._counters["replays"] += 1
        if req.span:
            # flow arrow request-span -> the replayed serve's span
            fid = new_flow_id()
            req.span.attrs.setdefault("flow_out", []).append(fid)
            req.flow_in = (rep.name, fid)
        self._dispatch(req, rep)

    @staticmethod
    def _fail(req: _FleetRequest, error: BaseException) -> None:
        try:
            req.future.set_exception(error)
        except InvalidStateError:
            pass  # a racing dispatch delivered first — the caller won
        else:
            req.span.end(error=type(error).__name__)

    def _on_crash(
        self,
        rep: _Replica,
        req: Optional[_FleetRequest],
        error: ChaosReplicaCrash,
    ) -> None:
        with self._lock:
            self._counters["crashes"] += 1
            rep.failed += 1
            if req is not None:
                rep.inflight -= 1
                req.outstanding -= 1
            self._eject(rep, f"crash: {error}")
            pending = self._drain(rep)
            if req is not None and not req.future.done():
                pending.insert(0, req)
            for p in pending:
                self._redispatch(p, {rep.name}, error)
        self._metrics.counter("fleet/crashes").inc()

    def _on_failure(
        self, rep: _Replica, req: _FleetRequest, error: BaseException
    ) -> bool:
        """Breaker bookkeeping for a non-crash serve failure; returns True
        when the replica was ejected (its worker thread exits)."""
        with self._lock:
            rep.inflight -= 1
            req.outstanding -= 1
            rep.failed += 1
            rep.fail_streak += 1
            rep.ok_streak = 0
            ejected = False
            if rep.state == "half_open":
                self._eject(rep, f"probe failed: {type(error).__name__}")
                ejected = True
            elif rep.fail_streak >= self._eject_after:
                self._eject(rep, f"fail streak: {type(error).__name__}")
                ejected = True
            elif rep.state == "healthy":
                self._set_state(rep, "degraded", type(error).__name__)
            self._redispatch(req, {rep.name}, error)
            if ejected:
                for p in self._drain(rep):
                    self._redispatch(p, {rep.name}, error)
            return ejected

    # -- fault injection (bench / tests) -----------------------------------

    def kill_replica(self, name: Optional[str] = None) -> str:
        """Deterministically crash one replica (default: the first live
        one): its worker dies mid-queue and the crash path drains/replays
        exactly like a chaos ``replica_crash``."""
        with self._lock:
            live = [
                r for r in self._replicas
                if r.state in ("healthy", "degraded")
            ]
            if name is not None:
                live = [r for r in self._replicas if r.name == name]
            if not live:
                raise ValueError(f"no live replica to kill (name={name!r})")
            rep = live[0]
            rep.queue.put(_KILL)
            return rep.name

    # -- hot swap / elastic width ------------------------------------------

    def _quiesce(self, rep: _Replica, timeout_s: float = 30.0) -> None:
        """Wait for a replica already OUT of rotation (drained queue, no
        routable state) to finish its in-flight serve, then stop its worker
        thread.  Called under ``_ctl_lock`` only — never under ``_lock``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if rep.inflight <= 0:
                    break
            time.sleep(0.001)
        worker = rep.worker
        rep.queue.put(_SHUTDOWN)
        if (
            worker is not None
            and worker.is_alive()
            and worker is not threading.current_thread()
        ):
            worker.join(timeout=5.0)

    def _rebind_replica(self, rep: _Replica, new_base, version: int, ctl) -> bool:
        """One rolling-swap step: take ``rep`` out of rotation, hold its
        queued requests, let the in-flight serve finish on the OLD engine
        (whole-version responses, never torn), rebind to a clone of
        ``new_base``, then re-admit and re-dispatch the held requests onto
        the new engine.  The held requests' futures are untouched
        throughout, so nothing is dropped and hedge duplicates still dedupe
        at the Future.  Returns True when chaos ``swap_crash`` fired
        mid-rebind — the kill lands while the replica is out of rotation
        with an empty queue, so it can strand NOTHING and recovery is
        simply completing the rebind with a fresh clone."""
        with self._lock:
            self._set_state(rep, "swapping", f"rebind to v{version}")
            held = self._drain(rep)
        self._quiesce(rep)
        crashed = False
        try:
            ctl.swap_crash(f"{self._label}:{rep.name}:swap")
        except ChaosReplicaCrash:
            crashed = True
            with self._lock:
                self._counters["crashes"] += 1
                rep.failed += 1
                rep.ejections += 1
            self._metrics.counter("fleet/crashes").inc()
        old = rep.engine
        rep.engine = new_base.clone(rep.name)
        rep.version = version
        old.stop()
        with self._lock:
            rep.fail_streak = 0
            rep.slow_streak = 0
            rep.ok_streak = 0
            rep.probing = False
            for req in held:
                if not req.future.done():
                    self._dispatch(req, rep)
            self._set_state(
                rep,
                "healthy",
                "rebind recovered from crash" if crashed
                else f"serving v{version}",
            )
            self._ensure_worker(rep)
        return crashed

    def _resolve_swap_target(self, model, name, version):
        """Resolve ``swap_model``'s target to a WARMED engine + ownership:
        a registry name acquires a pin lease on its already-warmed engine
        (zero compiles), an injected engine stays caller-owned, and a raw
        model/PackedModel is packed + warmed here mirroring the base
        engine's configuration (its warmup is the swap's only compile cost
        and moves the steady-state compile boundary)."""
        if isinstance(model, str):
            if self._registry is None:
                raise ValueError(
                    "swap_model(<name>) requires a registry-backed fleet "
                    "(FleetRouter.from_registry)"
                )
            registry, reg_name = self._registry, model
            engine = registry._acquire(reg_name)
            return engine, False, (lambda: registry._release(reg_name)), reg_name
        if isinstance(model, InferenceEngine):
            return model, False, None, name or model._label
        base = InferenceEngine(
            model,
            methods=self._base._methods,
            prefix_tiers=self._tiers,
            min_bucket=self._base._buckets[0],
            max_batch_size=self._base._max_batch,
            donate=self._base._donate,
            warm=True,
            label=f"{self._label}:v{version}:warm",
            telemetry_path=self._telemetry_path,
        )
        self._warm_snapshot = compile_snapshot()
        return base, True, None, name or f"{self._label}:v{version}"

    def swap_model(self, model, *, name: Optional[str] = None) -> Dict[str, Any]:
        """Rolling, torn-free hot swap of the served model under live
        traffic.

        ``model`` is a registry name (the fleet must come from
        :meth:`from_registry`; the new version's engine is pin-leased and
        its warm programs are shared into every replica via ``clone()``, so
        the swap adds ZERO compiles), an already-warmed
        :class:`InferenceEngine`, or a fitted model / ``PackedModel``
        (packed + warmed here first).

        Replicas rebind one at a time (:meth:`_rebind_replica`): the rest
        of the fleet keeps serving, queued requests are held and re-served
        on the new engine, and the in-flight request finishes on the old
        one — every response is computed entirely by exactly ONE model
        version, and zero requests are dropped.  The previous base engine
        is retired (stopped if router-owned, lease released if from a
        registry) only after the last replica rebinds, so a rollback swap
        can re-acquire it from the registry at any point.

        Returns a summary dict (``version``, ``swap_ms``,
        ``swap_compiles``, ``swap_crashes``) and emits it as a
        ``fleet_swap`` telemetry event."""
        if self._stopped:
            raise RuntimeError("fleet is stopped")
        ctl = controller()
        t0 = time.perf_counter()
        c0, _ = compile_snapshot()
        with self._ctl_lock:
            version = self._version + 1
            new_base, new_owns, new_release, new_name = (
                self._resolve_swap_target(model, name, version)
            )
            if (
                new_base._packed.num_features
                != self._base._packed.num_features
            ):
                if new_owns:
                    new_base.release()
                if new_release is not None:
                    new_release()
                raise ValueError(
                    "swap target serves "
                    f"num_features={new_base._packed.num_features}, fleet "
                    f"serves {self._base._packed.num_features}; a swap must "
                    "not invalidate requests already admitted"
                )
            crashes = 0
            for rep in list(self._replicas):
                crashes += int(self._rebind_replica(rep, new_base, version, ctl))
            old_base, self._base = self._base, new_base
            old_owns, self._owns_base = self._owns_base, new_owns
            old_release = self._registry_release
            self._registry_release = new_release
            self._registry_name = new_name if new_release is not None else None
            self._tiers = new_base.prefix_tiers
            with self._lock:
                self._version = version
                self._counters["swaps"] += 1
            if old_owns:
                old_base.release()
            if old_release is not None:
                old_release()
            c1, _ = compile_snapshot()
            out = {
                "version": version,
                "model": new_name,
                "replicas": len(self._replicas),
                "swap_ms": (time.perf_counter() - t0) * 1e3,
                "swap_compiles": c1 - c0,
                "swap_crashes": crashes,
            }
        emit_event(
            "fleet_swap",
            path=self._telemetry_path,
            fit_id=self._stream,
            **out,
        )
        self._metrics.counter("fleet/swaps").inc()
        return out

    def add_replica(self, name: Optional[str] = None) -> str:
        """Grow the fleet by one replica: a ``clone()`` of the warm base
        engine (shared programs — zero compiles), entered into rotation
        only once its worker is live.  Chaos ``scale_crash`` kills the
        warm-in BEFORE rotation entry, where it can strand nothing;
        recovery re-clones and proceeds (faults are at-most-once per
        site)."""
        if self._stopped:
            raise RuntimeError("fleet is stopped")
        ctl = controller()
        t0 = time.perf_counter()
        with self._ctl_lock:
            with self._lock:
                if name is None:
                    name = f"{self._label}:r{self._next_replica_idx}"
                    self._next_replica_idx += 1
                elif any(r.name == name for r in self._replicas):
                    raise ValueError(f"replica {name!r} already exists")
                version = self._version
            engine = self._base.clone(name)
            try:
                ctl.scale_crash(f"{self._label}:{name}:warm_in")
            except ChaosReplicaCrash:
                engine.stop()
                with self._lock:
                    self._counters["crashes"] += 1
                self._metrics.counter("fleet/crashes").inc()
                engine = self._base.clone(name)
            rep = _Replica(name, engine, version)
            with self._lock:
                self._replicas.append(rep)
                self._counters["scale_ups"] += 1
                self._ensure_worker(rep)
                n = len(self._replicas)
        emit_event(
            "fleet_scale",
            path=self._telemetry_path,
            fit_id=self._stream,
            direction="up",
            replica=name,
            replicas=n,
            warm_ms=(time.perf_counter() - t0) * 1e3,
        )
        return name

    def remove_replica(self, name: Optional[str] = None) -> str:
        """Shrink the fleet by one replica (default: the last one): it
        leaves rotation first, its queued requests replay on the
        survivors, the in-flight serve finishes, and only then do the
        worker and the engine clone die — zero drops by construction."""
        if self._stopped:
            raise RuntimeError("fleet is stopped")
        with self._ctl_lock:
            with self._lock:
                if len(self._replicas) <= 1:
                    raise ValueError("cannot remove the last replica")
                if name is None:
                    rep = self._replicas[-1]
                else:
                    match = [r for r in self._replicas if r.name == name]
                    if not match:
                        raise ValueError(f"no replica {name!r}")
                    rep = match[0]
                self._replicas.remove(rep)  # out of rotation: no new work
                for req in self._drain(rep):
                    self._redispatch(
                        req,
                        {rep.name},
                        FleetOverloadError(f"replica {rep.name} removed"),
                    )
                self._counters["scale_downs"] += 1
                n = len(self._replicas)
            self._quiesce(rep)
            rep.engine.stop()
        emit_event(
            "fleet_scale",
            path=self._telemetry_path,
            fit_id=self._stream,
            direction="down",
            replica=rep.name,
            replicas=n,
        )
        return rep.name

    # -- lifecycle / introspection ----------------------------------------

    def stop(self) -> None:
        """Stop every replica worker, emit the final SLO rows, release any
        registry pin (idempotent)."""
        if self._stopped:
            return
        self._stopped = True
        self._metrics.unregister_source(self._source_name)
        self.emit_slo()
        for rep in self._replicas:
            worker = rep.worker
            if worker is not None and worker.is_alive():
                rep.queue.put(_SHUTDOWN)
                if worker is not threading.current_thread():
                    worker.join(timeout=5.0)
        if self._owns_base:
            self._base.release()
        release, self._registry_release = self._registry_release, None
        if release is not None:
            release()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def slo_snapshot(self) -> Dict[str, Any]:
        """Aggregate + per-replica SLO counters: p50/p99 latency, queue
        depth, hedges, breaker transitions, degraded share."""
        c, s = compile_snapshot()
        with self._lock:
            requests = self._counters["requests"]
            served = sum(r.served for r in self._replicas)
            per_replica = {
                rep.name: {
                    "state": rep.state,
                    "version": rep.version,
                    "served": rep.served,
                    "failed": rep.failed,
                    "queue_depth": rep.inflight,
                    "transitions": rep.transitions,
                    "ejections": rep.ejections,
                    "p50_ms": _quantile_ms(rep.latencies, 0.50, 0.0),
                    "p99_ms": _quantile_ms(rep.latencies, 0.99, 0.0),
                }
                for rep in self._replicas
            }
            out = {
                "label": self._label,
                "version": self._version,
                "replicas": per_replica,
                "requests": requests,
                "served": served,
                "p50_ms": _quantile_ms(self._window, 0.50, 0.0),
                "p99_ms": _quantile_ms(self._window, 0.99, 0.0),
                "degraded_share": (
                    self._counters["degraded"] / requests if requests else 0.0
                ),
                # probed live by the watchdog via the fleet/* source
                # (docs/operator.md) — keep in the SLO row, not just statusz
                "hedge_rate": (
                    self._counters["hedges_fired"] / requests
                    if requests else 0.0
                ),
                "compiles_since_warmup": c - self._warm_snapshot[0],
                "compile_s_since_warmup": s - self._warm_snapshot[1],
                "prefix_tiers": self._tiers,
            }
            out.update(self._counters)
            return out

    def statusz(self) -> Dict[str, Any]:
        """Live operator view of the fleet — the serving analogue of a
        /statusz page: identity + uptime, model shape, the per-replica
        state machines with queue depth and rolling p50/p99, hedge rate,
        and the zero-steady-state-compile counter.  Built over
        :meth:`slo_snapshot`, also exported live through
        ``global_metrics().snapshot()`` as ``fleet/<stream>`` and printed
        by ``tools/serving_smoke.py fleet``."""
        snap = self.slo_snapshot()
        requests = snap["requests"]
        return {
            "label": self._label,
            "version": snap["version"],
            "stream": self._stream,
            "trace_id": self._tracer.trace_id,
            "uptime_s": time.time() - self._t_start,
            "stopped": self._stopped,
            "deadline_ms": self._deadline_s * 1e3,
            "prefix_tiers": list(self._tiers),
            "pinned": self._registry_release is not None,
            "model": {
                "num_members": self._base._packed.num_members,
                "num_features": self._base._packed.num_features,
            },
            "requests": requests,
            "p50_ms": snap["p50_ms"],
            "p99_ms": snap["p99_ms"],
            "hedge_rate": (
                snap["hedges_fired"] / requests if requests else 0.0
            ),
            "compiles_since_warmup": snap["compiles_since_warmup"],
            "replicas": snap["replicas"],
            "counters": {
                k: snap[k] for k in (
                    "hedges_fired", "hedges_won", "shed", "degraded",
                    "replays", "crashes",
                )
            },
        }

    def emit_slo(self) -> Dict[str, Any]:
        """Emit one ``fleet_slo`` event per replica plus an aggregate row
        (the CI serving-chaos job's uploaded artifact)."""
        snap = self.slo_snapshot()
        for name, rep in snap["replicas"].items():
            emit_event(
                "fleet_slo",
                path=self._telemetry_path,
                fit_id=self._stream,
                replica=name,
                **rep,
            )
        emit_event(
            "fleet_slo",
            path=self._telemetry_path,
            fit_id=self._stream,
            replica="*",
            requests=snap["requests"],
            p50_ms=snap["p50_ms"],
            p99_ms=snap["p99_ms"],
            hedges_fired=snap["hedges_fired"],
            hedges_won=snap["hedges_won"],
            shed=snap["shed"],
            replays=snap["replays"],
            crashes=snap["crashes"],
            degraded_share=snap["degraded_share"],
            compiles_since_warmup=snap["compiles_since_warmup"],
        )
        return snap

    def stats(self) -> Dict[str, Any]:
        """Engine-level stats (shared programs) + the SLO snapshot."""
        out = self._base.stats()
        out["fleet"] = self.slo_snapshot()
        return out
