"""Deterministic chaos-injection harness for the training runtime
(PyTorch port of ``robustness/chaos.py``).

Fault tolerance that is never exercised does not work.  This module
injects the failure modes the runtime defends against (NaN gradients,
mid-round preemption, transient device errors, checkpoint corruption) at
well-defined *sites* inside the fit loops, with deterministic draws, so a
failing run reproduces from the seed alone.  The port wires the sites of
its planes: ``nan_grad``, ``preempt`` and ``transient`` in GBM, Boosting,
Bagging and Stacking, and ``ckpt_corrupt`` in the checkpointer.  The
serving and distributed fault kinds keep their hooks, for the planes that
are still to port.

Environment contract (read per call, cached while it stays the same):

- ``SE_TPU_CHAOS``: enables injection; an integer seed (non-numeric values
  are hashed to one).  Unset/empty -> no-op controller.
- ``SE_TPU_CHAOS_FAULTS``: comma list restricting the active fault kinds
  (subset of :data:`FAULT_KINDS`; default all).
- ``SE_TPU_CHAOS_RATE``: per-site firing probability (default 0.05).
- ``SE_TPU_CHAOS_LOG``: JSONL path appending one record per injected fault.

Every fault fires **at most once per site**, so retried and replayed work
succeeds on the second attempt, and ``preempt`` carries a global budget
(default 1), so a high rate kills a fit once, not forever.  Tests bypass
the environment through :func:`install`.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, Iterable, Optional, Set, Tuple

import torch

logger = logging.getLogger("spark_ensemble_tpu_torch")

FAULT_KINDS = (
    "nan_grad", "preempt", "transient", "ckpt_corrupt",
    # serving-fleet faults (fired from FleetRouter replica workers only)
    "replica_stall", "replica_crash", "slow_reply",
    # elastic-training faults (fired from the distributed sweep only):
    # host_preempt kills one whole host mid-round (survivors repartition
    # and resume); host_stall makes one host drag a sweep step — the
    # straggler the pod skew report must attribute (telemetry/podview.py)
    "host_preempt",
    "host_stall",
    # fleet control-loop faults (docs/autopilot.md): swap_crash kills a
    # replica mid-rebind during a rolling hot swap, scale_crash kills a
    # just-added replica during its warm-in, refresh_crash kills a
    # background warm-start refresh fit mid-round (the serving model must
    # stay untouched and the refresh retryable)
    "swap_crash",
    "scale_crash",
    "refresh_crash",
)


class ChaosPreemption(Exception):
    """Injected mid-round kill.  Deliberately **not** a ``RuntimeError`` so
    the retry layer never swallows it — a preemption must propagate and be
    recovered via checkpoint resume, exactly like a real SIGTERM."""


class ChaosTransientError(RuntimeError):
    """Injected transient device error; a ``RuntimeError`` on purpose so
    the retry/backoff layer treats it like a real XLA hiccup."""


class ChaosHostPreemption(Exception):
    """Injected whole-host kill during a distributed sweep.  Raised only
    on the *victim* process (survivors get ``elastic.HostLostError``
    instead); not a ``RuntimeError`` so no retry layer can swallow it —
    the victim must actually leave the mesh, exactly like a real pod
    preemption notice."""


class ChaosReplicaCrash(Exception):
    """Injected serving-replica death.  Not a ``RuntimeError`` so nothing
    between the replica worker and the fleet router can swallow it: the
    router must observe the crash, eject the replica, and replay its queue
    on a healthy one — exactly like a real worker-process kill."""


def _replace_first_float_leaf(tree, fn):
    """``tree`` with ``fn`` applied to its first floating tensor, leaves
    taken in ``jax.tree_util`` order (dict keys sorted, NamedTuple and
    sequence fields in order), so both packages poison the same leaf."""
    done = [False]

    def walk(node):
        if done[0] or node is None:
            return node
        if isinstance(node, dict):
            out = dict(node)
            for k in sorted(node):
                out[k] = walk(node[k])
            return out
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, torch.Tensor) and node.is_floating_point():
            done[0] = True
            return fn(node)
        return node

    return walk(tree)


class ChaosController:
    """Deterministic per-site fault injector.

    ``seed`` fixes every draw; ``rate`` is the per-site firing probability;
    ``faults`` restricts the active kinds; ``budgets`` optionally caps the
    total firings per kind (``preempt`` defaults to 1).  A draw for a given
    ``(fault, site)`` pair is a pure function of the seed, so two runs that
    visit the same sites inject the same faults.
    """

    enabled = True

    def __init__(
        self,
        seed: int = 0,
        rate: float = 1.0,
        faults: Optional[Iterable[str]] = None,
        budgets: Optional[Dict[str, Optional[int]]] = None,
        log_path: Optional[str] = None,
    ):
        kinds = tuple(faults) if faults is not None else FAULT_KINDS
        unknown = set(kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(
                f"unknown chaos fault kinds {sorted(unknown)}; "
                f"expected a subset of {FAULT_KINDS}"
            )
        self.seed = int(seed)
        self.rate = float(rate)
        self.faults: Set[str] = set(kinds)
        self.budgets: Dict[str, Optional[int]] = {
            "preempt": 1,
            # one replica death per run by default: the fleet should absorb
            # a single kill; unbounded kills is a different experiment
            "replica_crash": 1,
            # likewise one host loss per run: survivors must prove one
            # clean repartition+resume, not survive a dying pod
            "host_preempt": 1,
            # one kill per control-loop experiment: the swap/scale/refresh
            # machinery must absorb a single mid-flight death and converge
            "swap_crash": 1,
            "scale_crash": 1,
            "refresh_crash": 1,
        }
        if budgets:
            self.budgets.update(budgets)
        self.log_path = log_path
        self.fired: list = []  # (fault, site) in firing order
        self._counts: Dict[str, int] = {}
        self._seen: Set[Tuple[str, str]] = set()
        self._lock = threading.Lock()

    # -- draw machinery ----------------------------------------------------

    def _draw(self, fault: str, site: str) -> float:
        """Uniform [0,1) draw, a pure function of (seed, fault, site)."""
        h = zlib.crc32(f"{self.seed}:{fault}:{site}".encode())
        return (h & 0xFFFFFFFF) / 2**32

    def _fire(self, fault: str, site: str) -> bool:
        if fault not in self.faults:
            return False
        with self._lock:
            key = (fault, site)
            if key in self._seen:
                return False  # at-most-once per site: retries succeed
            budget = self.budgets.get(fault)
            if budget is not None and self._counts.get(fault, 0) >= budget:
                return False
            if self._draw(fault, site) >= self.rate:
                return False
            self._seen.add(key)
            self._counts[fault] = self._counts.get(fault, 0) + 1
            self.fired.append(key)
        self._log(fault, site)
        return True

    def _log(self, fault: str, site: str) -> None:
        logger.warning("chaos: injecting %s at %s", fault, site)
        if not self.log_path:
            return
        rec = {"ts": time.time(), "fault": fault, "site": site,
               "seed": self.seed}
        try:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            logger.exception("chaos: could not append to %s", self.log_path)

    def pick(self, fault: str, site: str, n: int) -> int:
        """Deterministic index in [0, n) — which round/member to poison."""
        h = zlib.crc32(f"{self.seed}:{fault}:{site}:pick".encode())
        return int(h % max(n, 1))

    # -- injection hooks (called from the runtime) -------------------------

    def transient(self, site: str) -> None:
        """Raise a retryable :class:`ChaosTransientError` (at most once per
        site, so the retry layer's second attempt succeeds)."""
        if self._fire("transient", site):
            raise ChaosTransientError(f"chaos: transient fault at {site}")

    def preempt(self, site: str) -> None:
        """Raise a :class:`ChaosPreemption` (globally budgeted; default 1)."""
        if self._fire("preempt", site):
            raise ChaosPreemption(f"chaos: preempted at {site}")

    def poison_array(self, site: str, arr):
        """Return a copy of ``arr`` with one leading-axis slice set to NaN
        (or ``arr`` itself when the site does not fire)."""
        if arr is None or not self._fire("nan_grad", site):
            return arr
        j = self.pick("nan_grad", site, arr.shape[0])
        out = arr.clone()
        out[j] = float("nan")
        return out

    def poison_member_stack(self, site: str, tree):
        """Poison one stacked member: NaN the picked leading-axis index of
        the first floating leaf in ``tree``."""
        if not self._fire("nan_grad", site):
            return tree

        def poison(leaf):
            out = leaf.clone()
            out[self.pick("nan_grad", site, leaf.shape[0])] = float("nan")
            return out

        return _replace_first_float_leaf(tree, poison)

    def poison_tree(self, site: str, tree):
        """NaN a single element of the first floating leaf of ``tree``
        (unstacked per-member models, e.g. Stacking's members)."""
        if not self._fire("nan_grad", site):
            return tree

        def poison(leaf):
            out = leaf.clone()
            out.view(-1)[0] = float("nan")
            return out

        return _replace_first_float_leaf(tree, poison)

    def corrupt_checkpoint(self, site: str, state_path: str) -> None:
        """Truncate a just-written ``state.json`` mid-byte, simulating a
        crash during the (non-atomic on some filesystems) write."""
        if not self._fire("ckpt_corrupt", site):
            return
        try:
            with open(state_path, "r+b") as f:
                f.truncate(max(f.seek(0, 2) // 2, 1))
        except OSError:
            logger.exception("chaos: could not corrupt %s", state_path)

    def host_preempt(self, site: str) -> bool:
        """Whether a host preemption fires at this site (globally
        budgeted; default 1).  Unlike :meth:`preempt` this returns a
        verdict instead of raising: the caller (the distributed sweep)
        must first drain in-flight collectives and resolve the victim
        via :meth:`pick` — and then raises ``ChaosHostPreemption`` on
        the victim, ``HostLostError`` on survivors.  The draw is a pure
        function of ``(seed, fault, site)``, so every host reaches the
        same verdict at the same site without communicating."""
        return self._fire("host_preempt", site)

    def host_stall_s(self, site: str, seconds: float = 0.25) -> float:
        """Seconds one host should drag a distributed sweep step —
        enough to dominate the per-round sweep wall so the pod skew
        report names the straggler deterministically, without tripping
        anything fatal.  Like :meth:`host_preempt` the verdict is
        symmetric (pure function of seed/fault/site); the caller
        resolves WHICH host sleeps via :meth:`pick` and only the victim
        does.  0.0 when the site does not fire."""
        return float(seconds) if self._fire("host_stall", site) else 0.0

    # -- serving-fleet hooks (called from FleetRouter replica workers) -----

    def stall_s(self, site: str, seconds: float = 0.25) -> float:
        """Seconds a replica worker should sleep before serving — long
        enough to trip the router's hedge timer and the breaker's slow
        streak, without killing the replica.  0.0 when the site does not
        fire (the caller skips the sleep entirely)."""
        return float(seconds) if self._fire("replica_stall", site) else 0.0

    def crash(self, site: str) -> None:
        """Raise :class:`ChaosReplicaCrash` (globally budgeted; default 1)."""
        if self._fire("replica_crash", site):
            raise ChaosReplicaCrash(f"chaos: replica crashed at {site}")

    def slow_s(self, site: str, seconds: float = 0.05) -> float:
        """Seconds of added reply latency — a degraded-but-alive replica
        (slow NIC, noisy neighbor) that should push the router toward
        hedging and prefix degradation rather than ejection."""
        return float(seconds) if self._fire("slow_reply", site) else 0.0

    # -- fleet control-loop hooks (swap / scale / refresh) -----------------

    def swap_crash(self, site: str) -> None:
        """Raise :class:`ChaosReplicaCrash` mid-rebind during a rolling
        hot swap (globally budgeted; default 1).  The router must treat it
        exactly like a replica death: eject, replay the drained queue on a
        healthy replica, and finish the swap on the survivors — every
        response still computed by exactly one model version."""
        if self._fire("swap_crash", site):
            raise ChaosReplicaCrash(f"chaos: replica crashed mid-swap at {site}")

    def scale_crash(self, site: str) -> None:
        """Raise :class:`ChaosReplicaCrash` during a scale-up warm-in
        (globally budgeted; default 1).  A replica that dies before
        admission must never have owned a request, so the fleet drops
        nothing — it just ends up one replica narrower than asked."""
        if self._fire("scale_crash", site):
            raise ChaosReplicaCrash(f"chaos: replica crashed at warm-in {site}")

    def refresh_crash(self, site: str) -> None:
        """Raise :class:`ChaosPreemption` mid-round inside a background
        warm-start refresh fit (globally budgeted; default 1).  Not a
        ``RuntimeError`` so no retry layer swallows it: the refresh dies,
        the serving model stays byte-identical, and the next refresh
        attempt succeeds (the site fires at most once)."""
        if self._fire("refresh_crash", site):
            raise ChaosPreemption(f"chaos: refresh fit killed at {site}")


class _NoopController:
    """Injection disabled: every hook is a cheap no-op/identity."""

    enabled = False
    fired: tuple = ()

    def transient(self, site: str) -> None:
        pass

    def preempt(self, site: str) -> None:
        pass

    def poison_array(self, site: str, arr):
        return arr

    def poison_member_stack(self, site: str, tree):
        return tree

    def poison_tree(self, site: str, tree):
        return tree

    def corrupt_checkpoint(self, site: str, state_path: str) -> None:
        pass

    def stall_s(self, site: str, seconds: float = 0.25) -> float:
        return 0.0

    def host_preempt(self, site: str) -> bool:
        return False

    def host_stall_s(self, site: str, seconds: float = 0.25) -> float:
        return 0.0

    def crash(self, site: str) -> None:
        pass

    def slow_s(self, site: str, seconds: float = 0.05) -> float:
        return 0.0

    def swap_crash(self, site: str) -> None:
        pass

    def scale_crash(self, site: str) -> None:
        pass

    def refresh_crash(self, site: str) -> None:
        pass


_NOOP = _NoopController()
_installed: Optional[object] = None
_env_cache: Optional[Tuple[tuple, object]] = None
_cache_lock = threading.Lock()


def install(ctrl) -> None:
    """Override the process controller (tests); ``install(None)`` reverts
    to the environment-configured one."""
    global _installed
    _installed = ctrl


def _from_env():
    raw = os.environ.get("SE_TPU_CHAOS", "").strip()
    if not raw:
        return None
    seed = int(raw) if raw.lstrip("+-").isdigit() else zlib.crc32(raw.encode())
    faults_raw = os.environ.get("SE_TPU_CHAOS_FAULTS", "").strip()
    faults = (
        tuple(p.strip() for p in faults_raw.split(",") if p.strip())
        if faults_raw
        else None
    )
    rate = float(os.environ.get("SE_TPU_CHAOS_RATE", "0.05"))
    log_path = os.environ.get("SE_TPU_CHAOS_LOG") or None
    return seed, faults, rate, log_path


def controller():
    """The active controller: an installed one, else env-configured
    (cached until the relevant env vars change), else a no-op."""
    global _env_cache
    if _installed is not None:
        return _installed
    cfg = _from_env()
    if cfg is None:
        return _NOOP
    with _cache_lock:
        if _env_cache is not None and _env_cache[0] == cfg:
            return _env_cache[1]
        seed, faults, rate, log_path = cfg
        ctrl = ChaosController(
            seed=seed, rate=rate, faults=faults, log_path=log_path
        )
        _env_cache = (cfg, ctrl)
        return ctrl
