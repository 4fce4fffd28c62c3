"""Tier-2: program contracts for the public entry points (PyTorch port of
``analysis/contracts.py``).

Tier 1 reads source; this tier runs it.  It fits and predicts every
ensemble family on a tiny canonical fixture (64x6, 3 classes, depth-3
trees, 3 rounds) with a program-call observer registered at the port's
chokepoint (:func:`~spark_ensemble_tpu_torch.models.base.
observe_program_calls`: a GBM/Boosting round chunk, a Bagging forest fit,
an elastic sweep step, a model's predict, an engine graph, each under the
JAX package's program tag), and holds the budgets the performance work
depends on against the committed ``analysis/contracts.json``:

- **program budgets**: the number of distinct ``(tag, shape signature)``
  pairs each entry point calls.  The port compiles no programs, so a
  budget here counts the shapes its chokepoints run at: a NEW signature
  is exactly what the JAX package would retrace on, and what a CUDA graph
  of a round would have to capture again.  Streaming fits hold
  their count across shard counts (and the distributed sweep across mesh
  widths), the megabatch sweep across candidate counts, the sampled fit
  across sample rates.
- **kernel launches per round**: the hand-written CUDA kernels' calls per
  round of the main path on the fused tier (5 ``hist_packed``, 4
  ``route_packed``, 1 ``leaf_sums`` at depth 5) and on the pallas tier (5
  ``hist_i32``), and the same for a Boosting round and a Bagging fit,
  counted through the wrappers' work hook (``ops/hist_kernels.
  set_work_hook``), which fires for the plain versions on the CPU too; on
  the card the kernels' ``LAUNCHES`` delta must equal the hook's count.
- **host reads per round** of the fused main path outside its K-dim step
  search: torch.profiler's ``aten::_local_scalar_dense`` (a scalar read
  back to the host) per round, on the CPU and the card; on the card also
  ``cudaStreamSynchronize`` per round (``host_syncs``, card only).  The
  step search reads one scalar per Newton iteration and backtrack
  (``ops/linesearch.py``), a count that follows the data, so the
  measurement runs each search in a profiler range (:data:`STEP_SEARCH`)
  and leaves the reads inside it out.
  These take the place of the JAX package's **no host callbacks** check:
  a torch round has no traced program to embed a callback in, and what
  stalls the pipeline is a host read, which this budget counts.
- **nvcc builds inside a fit**: a main-path fit after the kernels are
  built compiles nothing (``telemetry/events.compile_snapshot``; card
  only).
- **serving**: an engine warms exactly ``len(methods) x len(buckets)``
  programs (one CUDA graph each on the card) and captures nothing in
  steady state; a fleet's warmup is shared across replicas and a
  registry swap captures nothing; drift sketching adds no program and
  keeps one dispatch per request.
- **no f64**: under a ``torch.overrides.TorchFunctionMode``, no torch call
  inside a round-loop program returns a float64 or complex128 tensor,
  except at the emulation sites of :data:`F64_EMULATION_SITES`.
- **collective axes**: every ``ops/collective.Axis`` a mesh fit reduces
  over names only axes of the mesh it was fitted on (and those are the
  blessed ``{dcn_data, data, member}``).

Buffer donation has no torch counterpart (an engine's static input is
the request's one device copy by construction), so the JAX package's
**donation consumed** check is recorded in ``skipped``.

Tracing runs under a scrubbed environment (every ``SE_TPU_*`` variable
popped, ``SE_TPU_AUTOTUNE=off``, ``SE_TPU_PIPELINE=0``) so the observed
budgets are a pure function of the code — the property that lets
``contracts.json`` live in git.  A budget the device cannot measure (the
card-only ones on the CPU) is recorded in ``skipped`` and keeps its pin
when the baseline is rewritten from that device.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: mesh axis names blessed by the distributed design
ALLOWED_AXES = frozenset({"dcn_data", "data", "member"})

#: program tags that form the per-round hot loop (the f64 watch is held
#: there)
_ROUND_LOOP_TAGS = ("chunk", "round", "fit", "scan")

#: canonical shape class every family is fitted on: small enough for a
#: CPU test, large enough to exercise binning and bucketing
_N, _D, _K = 64, 6, 3
_DEPTH, _ROUNDS = 3, 3

#: the main path's trees (``bench.py::inner``): its launches per round
_MAIN_DEPTH, _MAIN_BINS = 5, 64

#: the tiers whose kernels a round launches, and the kernels each launches
_TIER_KERNELS = {
    "fused": ("hist_packed", "route_packed", "leaf_sums"),
    "pallas": ("hist_i32",),
}

#: the float64 sites that emulate the reference's arithmetic: (file under
#: the package, function) -> why.  Each also carries a justified
#: ``f64-upcast`` suppression in its source.
F64_EMULATION_SITES = {
    ("utils/random.py", "uniform"): (
        "jax.random.uniform's fused multiply-add: the product exact in "
        "float64, one rounding to float32"
    ),
    ("ops/binning.py", "compute_bins"): (
        "jnp.quantile's fused multiply-add in the threshold "
        "interpolation: one float64 rounding"
    ),
    ("execution.py", "device_patience_step"): (
        "the device patience recurrence's one 4-scalar readback: float64 "
        "carries the f32 loss and the int32 counts exactly"
    ),
}

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PACKAGE_DIR)
_BASELINE_PATH = os.path.join(os.path.dirname(__file__), "contracts.json")

#: seconds a spawned rank of the distributed trace may take
_DIST_TIMEOUT_S = 300


@dataclass
class ContractViolation:
    contract: str  # budget | f64 | axis-name | kernels | serving | ...
    entry_point: str
    message: str

    def to_record(self) -> dict:
        return {
            "event": "contract_violation",
            "contract": self.contract,
            "entry_point": self.entry_point,
            "message": self.message,
        }


@dataclass
class ContractReport:
    """Outcome of one contract trace: per-entry-point budgets plus every
    violation found (empty == the port honors its contracts)."""

    budgets: Dict[str, int] = field(default_factory=dict)
    violations: List[ContractViolation] = field(default_factory=list)
    skipped: Dict[str, str] = field(default_factory=dict)
    #: the host-reads trace's profiler counts by fit rounds, each split at
    #: the step search (``_host_calls``); not part of the baseline
    host_calls: Dict[int, Dict[str, int]] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def baseline(self) -> dict:
        """The committed-baseline shape: versioned, sorted, timestamp-free
        (byte-stable across runs, so git diffs are semantic)."""
        return {
            "version": 1,
            "entry_points": {k: self.budgets[k] for k in sorted(self.budgets)},
        }


class _ProgramRecorder:
    """Observer for :func:`observe_program_calls`: the distinct
    ``(tag, signature)`` programs called, and the calls of each tag."""

    def __init__(self):
        self._lock = threading.Lock()
        self.programs: set = set()
        self.calls: Dict[str, int] = {}

    def __call__(self, tag, sig):
        with self._lock:
            self.programs.add((tag, sig))
            self.calls[tag] = self.calls.get(tag, 0) + 1

    def count(self) -> int:
        return len(self.programs)


class _F64Watch(torch.overrides.TorchFunctionMode):
    """Flags every torch call, inside an open round-loop program on this
    thread, that returns a float64 or complex128 tensor outside
    :data:`F64_EMULATION_SITES`."""

    def __init__(self, entry: str, report: ContractReport):
        super().__init__()
        self.entry = entry
        self.report = report
        self.seen: set = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _wide(out):
            from spark_ensemble_tpu_torch.models.base import open_programs

            loops = [c.tag for c in open_programs()
                     if any(t in c.tag for t in _ROUND_LOOP_TAGS)]
            if loops:
                site = _port_site()
                if site not in F64_EMULATION_SITES and (loops[-1], site) not in self.seen:
                    self.seen.add((loops[-1], site))
                    self.report.violations.append(ContractViolation(
                        "f64", self.entry,
                        f"round-loop program `{loops[-1]}` produces a float64/"
                        f"complex128 tensor at {site[0]}:{site[1]} "
                        f"({getattr(func, '__name__', func)}): f32 dtype "
                        "policy violation",
                    ))
        return out


#: the dtypes the f64 watch flags
_WIDE_DTYPES = (torch.float64, torch.complex128)  # graftlint: ignore[f64-upcast] -- the f64 watch's own dtype test, not an upcast


def _wide(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.dtype in _WIDE_DTYPES
    if isinstance(out, (tuple, list)):
        return any(isinstance(t, torch.Tensor) and t.dtype in _WIDE_DTYPES for t in out)
    return False


def _port_site() -> Tuple[str, str]:
    """(file under the package, function) of the innermost port frame on
    this thread's stack, outside this module."""
    frame = sys._getframe(2)
    here = os.path.abspath(__file__)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PACKAGE_DIR + os.sep) and path != here:
            rel = os.path.relpath(path, _PACKAGE_DIR).replace(os.sep, "/")
            return rel, frame.f_code.co_name
        frame = frame.f_back
    return "?", "?"


class _KernelCounter:
    """The kernel wrappers' work hook: calls per kernel (plain versions on
    the CPU included), chained to any hook already installed."""

    def __init__(self):
        self.calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._prev = None

    def __call__(self, kernel, sig, nbytes, nops):
        with self._lock:
            self.calls[kernel] = self.calls.get(kernel, 0) + 1
        if self._prev is not None:
            self._prev(kernel, sig, nbytes, nops)

    @contextlib.contextmanager
    def installed(self):
        from spark_ensemble_tpu_torch.ops import hist_kernels as hk

        self._prev = hk._WORK_HOOK[0]
        hk.set_work_hook(self)
        try:
            yield self
        finally:
            hk.set_work_hook(self._prev)


def _scrubbed_env():
    """Pin every behavior-bearing env knob to the canonical contract
    configuration for the enclosed trace (restored on exit)."""

    @contextlib.contextmanager
    def _scope():
        saved = {
            k: os.environ.pop(k)
            for k in list(os.environ)
            if k.startswith("SE_TPU_")
        }
        os.environ["SE_TPU_AUTOTUNE"] = "off"
        os.environ["SE_TPU_PIPELINE"] = "0"
        try:
            yield
        finally:
            for k in list(os.environ):
                if k.startswith("SE_TPU_"):
                    del os.environ[k]
            os.environ.update(saved)

    return _scope()


def _canonical_data(classification: bool):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((_N, _D)).astype(np.float32)
    if classification:
        y = (np.arange(_N) % _K).astype(np.int32)
        rng.shuffle(y)
    else:
        y = (X @ rng.standard_normal(_D) + 0.1 * rng.standard_normal(_N)).astype(
            np.float32
        )
    return X, y


def _gbm_regressor(st, **kw):
    return st.GBMRegressor(
        base_learner=st.DecisionTreeRegressor(max_depth=_DEPTH),
        num_base_learners=_ROUNDS, seed=0, **kw,
    )


def _entry_points() -> Dict[str, dict]:
    """Constructors for the canonical contract fixtures: every family,
    classifier + regressor, smallest configs that still run the real
    round drivers (the JAX package's fixtures)."""
    import spark_ensemble_tpu_torch as st

    def tree_r():
        return st.DecisionTreeRegressor(max_depth=_DEPTH)

    def tree_c():
        return st.DecisionTreeClassifier(max_depth=_DEPTH)

    return {
        "gbm_regressor": dict(
            make=lambda: st.GBMRegressor(
                base_learner=tree_r(), num_base_learners=_ROUNDS, seed=0
            ),
            classification=False,
        ),
        "gbm_classifier": dict(
            make=lambda: st.GBMClassifier(
                base_learner=tree_r(), num_base_learners=_ROUNDS, seed=0
            ),
            classification=True,
        ),
        "boosting_regressor": dict(
            make=lambda: st.BoostingRegressor(
                base_learner=tree_r(), num_base_learners=_ROUNDS, seed=0
            ),
            classification=False,
        ),
        "boosting_classifier": dict(
            make=lambda: st.BoostingClassifier(
                base_learner=tree_c(), num_base_learners=_ROUNDS, seed=0
            ),
            classification=True,
        ),
        "bagging_regressor": dict(
            make=lambda: st.BaggingRegressor(
                base_learner=tree_r(), num_base_learners=_ROUNDS, seed=0
            ),
            classification=False,
        ),
        "bagging_classifier": dict(
            make=lambda: st.BaggingClassifier(
                base_learner=tree_c(), num_base_learners=_ROUNDS, seed=0
            ),
            classification=True,
        ),
        "stacking_regressor": dict(
            make=lambda: st.StackingRegressor(
                base_learners=[tree_r(), st.LinearRegression()],
                stacker=st.LinearRegression(),
            ),
            classification=False,
        ),
        "stacking_classifier": dict(
            make=lambda: st.StackingClassifier(
                base_learners=[tree_c(), st.LogisticRegression()],
                stacker=st.LogisticRegression(),
            ),
            classification=True,
        ),
    }


@contextlib.contextmanager
def _recording(entry: str, report: ContractReport):
    """Record the distinct programs called in the scope, with the f64
    watch on."""
    from spark_ensemble_tpu_torch.models.base import observe_program_calls

    rec = _ProgramRecorder()
    with observe_program_calls(rec), _F64Watch(entry, report):
        yield rec


# ---------------------------------------------------------------------------
# the traces
# ---------------------------------------------------------------------------


def _trace_family(name: str, spec: dict, report: ContractReport, device) -> None:
    X, y = _canonical_data(spec["classification"])
    est = spec["make"]()
    with _recording(f"{name}.fit", report) as rec:
        model = est.fit(X, y, device=device)
    report.budgets[f"{name}.fit"] = rec.count()
    methods = ["predict"]
    if spec["classification"]:
        methods.append("predict_proba")
    for method in methods:
        if not hasattr(model, method):
            continue
        with _recording(f"{name}.{method}", report) as rec:
            getattr(model, method)(X)
        report.budgets[f"{name}.{method}"] = rec.count()


def _main_path(st, rounds: int, tier: str):
    """``bench.py::inner``'s GBM over the main path's trees on ``tier``
    (``"fused"``, or ``"pallas"``: the matmul tier's pallas precision)."""
    hist, hp = ("fused", "highest") if tier == "fused" else ("matmul", "pallas")
    return st.GBMClassifier(
        num_base_learners=rounds, loss="logloss", updates="newton",
        learning_rate=0.3, optimized_weights=True, seed=0,
        base_learner=st.DecisionTreeRegressor(
            max_depth=_MAIN_DEPTH, max_bins=_MAIN_BINS, hist=hist,
            hist_precision=hp),
    )


def _kernel_families(st, tier: str):
    """(entry, estimator, classification, rounds the count divides by) of
    every family whose rounds launch the kernels."""
    hist, hp = ("fused", "highest") if tier == "fused" else ("matmul", "pallas")

    def tree(cls=st.DecisionTreeRegressor):
        return cls(max_depth=_MAIN_DEPTH, max_bins=_MAIN_BINS, hist=hist,
                   hist_precision=hp)

    out = [
        (f"kernels.gbm_classifier.{tier}_round", _main_path(st, _ROUNDS, tier), True,
         _ROUNDS),
        # every member of a Bagging fit is one forest fit: one "round"
        (f"kernels.bagging_regressor.{tier}_fit",
         st.BaggingRegressor(base_learner=tree(), num_base_learners=_ROUNDS, seed=0),
         False, 1),
    ]
    if tier == "fused":  # Boosting fits its trees at "high": no pallas tier
        out.append((f"kernels.boosting_regressor.{tier}_round",
                    st.BoostingRegressor(base_learner=tree(), num_base_learners=_ROUNDS,
                                         seed=0),
                    False, _ROUNDS))
    return out


def _trace_kernels(report: ContractReport, device) -> None:
    """Kernel calls per round of the families on the fused and pallas
    tiers, through the wrappers' work hook; on the card the kernels'
    ``LAUNCHES`` delta must equal the hook's count."""
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.ops import hist_kernels as hk

    on_card = torch.device(device).type == "cuda"
    for tier, kernels in _TIER_KERNELS.items():
        for entry, est, classification, per in _kernel_families(st, tier):
            X, y = _canonical_data(classification)
            launches0 = dict(hk.LAUNCHES)
            with _KernelCounter().installed() as counter, \
                    _recording(entry, report):
                est.fit(X, y, device=device)
            stray = sorted(k for k in counter.calls
                           if k in hk.LAUNCHES and k not in kernels)
            if stray:
                report.violations.append(ContractViolation(
                    "kernels", entry,
                    f"the {tier} tier called kernels {stray} besides {list(kernels)}",
                ))
            for k in kernels:
                calls = counter.calls.get(k, 0)
                report.budgets[f"{entry}.{k}"] = calls // per
                if calls % per:
                    report.violations.append(ContractViolation(
                        "kernels", f"{entry}.{k}",
                        f"{calls} calls over {per} rounds: not a fixed count a round",
                    ))
                if on_card:
                    launched = hk.LAUNCHES[k] - launches0[k]
                    if launched != calls:
                        report.violations.append(ContractViolation(
                            "kernels", f"{entry}.{k}",
                            f"the card launched {launched} times, the work hook "
                            f"counted {calls} calls",
                        ))


#: the profiler range the host-read budget runs GBM's step searches in
STEP_SEARCH = "se::step_search"


@contextlib.contextmanager
def _ranged_step_searches():
    """Run GBM's step searches (``brent_minimize``,
    ``projected_newton_box_lanes``) inside a profiler range named
    :data:`STEP_SEARCH` for the scope.  The card's torch records no Python
    frames in a profile, so only a range tells the searches' reads apart;
    the package itself carries none, since a range shows in every profile
    as device time spanning the kernels it encloses."""
    from spark_ensemble_tpu_torch.models import gbm

    def ranged(fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(STEP_SEARCH):
                return fn(*args, **kwargs)

        return inner

    saved = {name: getattr(gbm, name)
             for name in ("brent_minimize", "projected_newton_box_lanes")}
    for name, fn in saved.items():
        setattr(gbm, name, ranged(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(gbm, name, fn)


def _host_calls(fn, on_card: bool) -> Dict[str, int]:
    """torch.profiler's counts of host reads (and on the card, stream
    syncs) while ``fn`` runs, outside the step search and inside it
    (``<key>:step_search``, the events :func:`_ranged_step_searches`'s
    range encloses): a search reads one device scalar per Newton iteration
    and backtrack, so its count follows the data, while the rest of a
    round's is fixed."""
    from torch.profiler import ProfilerActivity, profile

    with _ranged_step_searches(), profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        if on_card:
            torch.cuda.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- ends the counted window inside the profiler, not a timed path
    counts: Dict[str, int] = {}
    for e in prof.events():
        if e.name not in ("aten::_local_scalar_dense", "cudaStreamSynchronize"):
            continue
        key, p = e.name, e.cpu_parent
        while p is not None:
            if p.name == STEP_SEARCH:
                key += ":step_search"
                break
            p = p.cpu_parent
        counts[key] = counts.get(key, 0) + 1
    return counts


def _trace_host_reads(report: ContractReport, device) -> None:
    """Host reads (and on the card, stream syncs) per round of the fused
    main path outside the step search: the difference between a 4-round
    and a 2-round fit, over 2, so the setup's reads cancel."""
    import spark_ensemble_tpu_torch as st

    on_card = torch.device(device).type == "cuda"
    X, y = _canonical_data(True)
    _main_path(st, 1, "fused").fit(X, y, device=device)  # warm: the kernels load
    counts = {}
    for rounds in (2, 4):
        counts[rounds] = _host_calls(
            lambda r=rounds: _main_path(st, r, "fused").fit(X, y, device=device), on_card)
    report.host_calls = counts
    for key, entry in (("aten::_local_scalar_dense", "host_reads.gbm_classifier.fused_round"),
                       ("cudaStreamSynchronize", "host_syncs.gbm_classifier.fused_round")):
        if key == "cudaStreamSynchronize" and not on_card:
            report.skipped[entry] = "stream syncs are counted on the card only"
            continue
        diff = counts[4].get(key, 0) - counts[2].get(key, 0)
        report.budgets[entry] = diff // 2
        if diff % 2 or diff < 0:
            report.violations.append(ContractViolation(
                "host-reads", entry,
                f"{counts[2].get(key, 0)} {key} at 2 rounds, {counts[4].get(key, 0)} "
                "at 4, outside the step search: not a fixed count a round",
            ))


def _trace_builds(report: ContractReport, device) -> None:
    """nvcc builds inside a main-path fit once the kernels are built: 0."""
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.ops import hist_kernels as hk
    from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot

    entry = "builds.gbm_classifier.fused_fit"
    if torch.device(device).type != "cuda":
        report.skipped[entry] = "nvcc builds the kernels on the card only"
        return
    hk.build_kernels()
    X, y = _canonical_data(True)
    before = compile_snapshot()[0]
    _main_path(st, _ROUNDS, "fused").fit(X, y, device=device)
    got = compile_snapshot()[0] - before
    report.budgets[entry] = got
    if got:
        report.violations.append(ContractViolation(
            "builds", entry,
            f"{got} build(s) inside a fit after the kernels were built: a fit "
            "must load the built library, never run nvcc",
        ))


def _trace_serving(report: ContractReport, device) -> None:
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.serving.engine import InferenceEngine
    from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot

    X, y = _canonical_data(False)
    model = _gbm_regressor(st).fit(X, y, device=device)
    engine = InferenceEngine(
        model, methods=("predict",), min_bucket=8, max_batch_size=32, warm=True,
    )
    try:
        expected = len(engine._methods) * len(engine.buckets)
        got = len(engine._compiled)
        report.budgets["serving.warmup"] = got
        if got != expected:
            report.violations.append(ContractViolation(
                "serving", "serving.warmup",
                f"warmup captured {got} programs, expected "
                f"len(methods) x len(buckets) = {expected}",
            ))
        report.skipped["serving.donation"] = (
            "buffer donation has no torch counterpart: the engine's static "
            "input is the request's one device copy"
        )
        # steady state: serving several real batch sizes after warmup
        # captures nothing (the whole point of the buckets)
        before = compile_snapshot()[0]
        for n in (1, 7, 9, 30):
            engine.predict(X[:n])
        after = compile_snapshot()[0]
        if after != before or engine.stats()["compiles_since_warmup"]:
            report.violations.append(ContractViolation(
                "serving", "serving.steady_state",
                f"{after - before} capture(s) during warmed steady-state "
                "serving (must be zero)",
            ))
    finally:
        engine.stop()


def _trace_fleet(report: ContractReport, device) -> None:
    """The fleet's warmup is O(methods x buckets x (1 + prefix tiers)) and
    independent of the replica count (replicas share one program map);
    steady-state serving, prefix tiers included, and a registry swap
    capture nothing."""
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.serving import ModelRegistry, pack
    from spark_ensemble_tpu_torch.serving.fleet import FleetRouter
    from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot

    X, y = _canonical_data(False)
    model = _gbm_regressor(st).fit(X, y, device=device)
    router = FleetRouter(
        model, replicas=2, methods=("predict",), prefix_tiers=(2,),
        min_bucket=8, max_batch_size=32,
    )
    try:
        engine = router._base
        expected = (len(engine._methods) * len(engine.buckets)
                    * (1 + len(engine.prefix_tiers)))
        got = len(engine._compiled)
        report.budgets["fleet.warmup"] = got
        if got != expected:
            report.violations.append(ContractViolation(
                "serving", "fleet.warmup",
                f"fleet warmup captured {got} programs, expected "
                "len(methods) x len(buckets) x (1 + len(prefix_tiers)) "
                f"= {expected} (shared across replicas)",
            ))
        before = compile_snapshot()[0]
        for n in (1, 7, 30):
            router.predict(X[:n])
        for rep in router._replicas:
            rep.engine.predict(X[:5], tier=2)
        after = compile_snapshot()[0]
        if after != before:
            report.violations.append(ContractViolation(
                "serving", "fleet.steady_state",
                f"{after - before} capture(s) during warmed fleet serving "
                "incl. prefix tiers (must be zero)",
            ))
    finally:
        router.stop()

    registry = ModelRegistry(
        capacity=4, methods=("predict",), min_bucket=8, max_batch_size=32,
    )
    registry.register("prod", model, warm=True)
    registry.register("next", pack(model).take(2), warm=True)
    fleet = FleetRouter.from_registry(registry, "prod", replicas=2)
    try:
        fleet.predict(X[:5])
        before = compile_snapshot()[0]
        info = fleet.swap_model("next")
        fleet.predict(X[:5])
        after = compile_snapshot()[0]
        got = max(int(info["swap_compiles"]), after - before)
        report.budgets["fleet.swap_compiles"] = got
        if got != 0:
            report.violations.append(ContractViolation(
                "serving", "fleet.swap_compiles",
                f"rolling hot swap performed {got} capture(s); both versions "
                "are registry-warmed, so a swap must rebind replicas without "
                "capturing",
            ))
    finally:
        fleet.stop()
        registry.close()


def _unfenced(module) -> list:
    """Unsuppressed unfenced-blocking-read findings of ``module``, linted
    by absolute path, so the telemetry package's blanket fence-module
    exemption cannot mask one."""
    from spark_ensemble_tpu_torch.analysis.lint import lint_file

    return [f for f in lint_file(os.path.abspath(module.__file__),
                                 select=["unfenced-blocking-read"])
            if not f.suppressed]


def _trace_autopilot(report: ContractReport) -> None:
    """The autopilot's control loop holds no unfenced blocking read: a
    control loop that blocks on device values can stall the fleet it is
    healing."""
    from spark_ensemble_tpu_torch.serving import autopilot

    findings = _unfenced(autopilot)
    report.budgets["autopilot.lint"] = len(findings)
    for f in findings:
        report.violations.append(ContractViolation(
            "autopilot", "autopilot.lint",
            f"unfenced blocking read in the autopilot loop: {f.path}:{f.line}: "
            f"{f.message}",
        ))


def _trace_streaming(report: ContractReport, device) -> None:
    """A streaming fit calls a fixed set of programs whatever the store's
    shard count: traced at 2 and 4 shards, any growth is a violation."""
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.data import write_shards

    for name, classification in (("gbm_regressor", False), ("gbm_classifier", True)):
        X, y = _canonical_data(classification)
        entry = f"{name}.fit_streaming"
        counts: Dict[int, int] = {}
        for shard_rows in (32, 16):  # _N=64 rows -> 2 shards, then 4
            with tempfile.TemporaryDirectory(prefix="graftlint-shards-") as tmp:
                store = write_shards(X, os.path.join(tmp, "store"), max_bins=64,
                                     shard_rows=shard_rows, device=device)
                est_cls = st.GBMClassifier if classification else st.GBMRegressor
                est = est_cls(base_learner=st.DecisionTreeRegressor(max_depth=_DEPTH),
                              num_base_learners=_ROUNDS, seed=0)
                with _recording(entry, report) as rec:
                    est.fit_streaming(store, y, device=device)
                counts[store.num_shards] = rec.count()
        (s_a, count_a), (s_b, count_b) = sorted(counts.items())
        report.budgets[entry] = count_a
        if count_a != count_b:
            report.violations.append(ContractViolation(
                "streaming", entry,
                f"program count grew with shard count ({s_a} shards: {count_a} "
                f"programs, {s_b} shards: {count_b}): the shard sweep must reuse "
                "one program set per level, not one per shard",
            ))


# -- the distributed streaming fit: spawned gloo ranks ------------------------


def _dist_rank(cfg: dict) -> int:
    """One rank of the distributed trace (``python -m
    spark_ensemble_tpu_torch.analysis.contracts --dist-rank '<json>'``):
    joins a gloo group of ``cfg["world"]`` ranks (on the CPU, or on
    ``cuda:0`` as the card's mesh phases run), fits the canonical
    regressor's streaming fit over a ``member=1`` mesh at two shard counts
    and writes its program counts, the reduction axes it saw and the f64
    watch's findings to ``cfg["out"]``."""
    import torch.distributed as dist

    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.data import ShardStore, write_shards
    from spark_ensemble_tpu_torch.ops import collective as coll
    from spark_ensemble_tpu_torch.parallel import mesh as pmesh

    rank, world = cfg["rank"], cfg["world"]
    on_card = cfg["device"] == "cuda"
    torch.set_num_threads(1)
    if on_card:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda:0" if on_card else "cpu"
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{cfg['port']}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=_DIST_TIMEOUT_S // 2))
    report = ContractReport()
    out = {"counts": {}, "axes": [], "mesh_axes": [], "violations": []}
    with _scrubbed_env():
        X, y = _canonical_data(False)
        mesh = pmesh.data_member_mesh(world, member=1, device=dev)
        out["mesh_axes"] = list(mesh.axis_names)
        axes = set()
        for shard_rows in (32, 16):
            path = os.path.join(cfg["dir"], f"store_{shard_rows}")
            if rank == 0:
                write_shards(X, path, max_bins=64, shard_rows=shard_rows, device="cpu")
            dist.barrier()
            store = ShardStore.open(path)
            est = st.GBMRegressor(base_learner=st.DecisionTreeRegressor(max_depth=_DEPTH),
                                  num_base_learners=_ROUNDS, seed=0)
            with coll.observe_axes(lambda a: axes.add(a.names)), \
                    _recording("gbm_regressor.fit_streaming_dist", report) as rec:
                est.fit_streaming(store, y, mesh=mesh, device=dev)
            out["counts"][str(store.num_shards)] = rec.count()
        out["axes"] = sorted(list(a) for a in axes)
    out["violations"] = [v.to_record() for v in report.violations]
    dist.barrier()
    dist.destroy_process_group()
    with open(cfg["out"], "w") as f:
        json.dump(out, f)
    return 0


def _spawn_ranks(world: int, device: str, tmp: str) -> List[dict]:
    """Run ``world`` ranks of :func:`_dist_rank` -> each rank's results.  A
    rank that fails or outlives the timeout fails the trace: the others
    are killed and the error carries every rank's output tail."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([_REPO_ROOT, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    cfgs = [{"rank": r, "world": world, "port": port, "device": device, "dir": tmp,
             "out": os.path.join(tmp, f"w{world}_r{r}.json")} for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spark_ensemble_tpu_torch.analysis.contracts",
         "--dist-rank", json.dumps(cfg)],
        env=env, cwd=_REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for cfg in cfgs]
    deadline = time.time() + _DIST_TIMEOUT_S
    logs: List[Optional[str]] = [None] * world
    while any(log is None for log in logs):
        for r, p in enumerate(procs):
            if logs[r] is None and p.poll() is not None:
                logs[r] = p.stdout.read()
        if any(p.returncode not in (None, 0) for p in procs) or time.time() > deadline:
            break
        time.sleep(0.1)
    for r, p in enumerate(procs):
        if logs[r] is None:
            p.kill()
            logs[r] = (p.communicate()[0] or "") + "\n[killed]"
    if any(p.returncode != 0 for p in procs):
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n{log[-2000:]}"
                          for r, (p, log) in enumerate(zip(procs, logs)))
        raise RuntimeError(f"distributed contract trace: a rank of {world} failed\n{tails}")
    results = []
    for cfg in cfgs:
        with open(cfg["out"]) as f:
            results.append(json.load(f))
    return results


def _check_ranks(report: ContractReport, entry: str, width: int,
                 ranks: List[dict], counts: Dict[Tuple[int, int], int]) -> None:
    """Fold one mesh width's rank results into ``counts`` (rank 0's program
    count per ``(width, shards)``) and ``report``: a rank calling more
    programs than rank 0, a reduction over an axis that is not the mesh's
    own (or not blessed), and each rank's f64 findings are violations."""
    # rank 0 sweeps a shard at every step; a rank past the manifest's
    # end adds an exact zero block and calls no step program, so it may
    # call fewer, never more
    for s, c in ranks[0]["counts"].items():
        counts[(width, int(s))] = c
    for r, res in enumerate(ranks):
        for s, c in res["counts"].items():
            if c > counts[(width, int(s))]:
                report.violations.append(ContractViolation(
                    "distributed", entry,
                    f"rank {r} called {c} programs at W={width}, {s} shards; "
                    f"rank 0 called {counts[(width, int(s))]}",
                ))
        for names in res["axes"]:
            bad = [a for a in names
                   if a not in res["mesh_axes"] or a not in ALLOWED_AXES]
            if bad:
                report.violations.append(ContractViolation(
                    "axis-name", entry,
                    f"a reduction over axes {names} at W={width}: {bad} not "
                    f"among the mesh's axes {res['mesh_axes']} (blessed: "
                    f"{sorted(ALLOWED_AXES)})",
                ))
        report.violations.extend(ContractViolation(
            v["contract"], v["entry_point"], f"rank {r}, W={width}: {v['message']}")
            for v in res["violations"])


def _trace_streaming_dist(report: ContractReport, device, spawn_ranks: bool) -> None:
    """The distributed streaming fit (``parallel/elastic.py``) calls a
    fixed program set whatever the shard count and the mesh width: traced
    on gloo groups of 2 and 4 ranks x 2 and 4 shards, any variation is a
    ``distributed`` violation; every reduction axis must be one of the
    mesh's own (and blessed) axes."""
    entry = "gbm_regressor.fit_streaming_dist"
    if not spawn_ranks:
        report.skipped[entry] = (
            "the distributed trace runs on spawned gloo groups of 2 and 4 "
            "ranks: pass spawn_ranks=True (tools/graftlint_torch.py "
            "--contracts does)"
        )
        return
    counts: Dict[Tuple[int, int], int] = {}
    dev = torch.device(device).type
    for width in (2, 4):
        with tempfile.TemporaryDirectory(prefix="graftlint-dist-") as tmp:
            ranks = _spawn_ranks(width, dev, tmp)
        _check_ranks(report, entry, width, ranks, counts)
    report.budgets[entry] = counts[(2, 2)]
    if len(set(counts.values())) != 1:
        report.violations.append(ContractViolation(
            "distributed", entry,
            "program count varies with (mesh width, shard count): "
            f"{ {f'{w}x{s}': c for (w, s), c in sorted(counts.items())} }; "
            "the distributed sweep must reuse one program set per level "
            "across ranks and steps",
        ))


def _trace_megabatch(report: ContractReport, device) -> None:
    """A candidate batch calls a fixed program set whatever its size:
    traced at 16 and 32 candidates at one slab width
    (``configs_per_dispatch=16``); growth is a ``megabatch`` violation,
    and so is a swept round called more than once a slab a round (the
    signature holds the slab's lane count, which a sweep of one candidate
    a call keeps as fixed as a batched one)."""
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.autotune.resolve import override
    from spark_ensemble_tpu_torch.models.gbm_sweep import fit_sweep

    entry, lanes = "gbm_regressor.fit_sweep", 16
    X, y = _canonical_data(False)
    base = _gbm_regressor(st)
    counts: Dict[int, int] = {}
    for n_cands in (16, 32):
        ests = [base.copy(learning_rate=0.05 + 0.01 * i, seed=i) for i in range(n_cands)]
        with override(configs_per_dispatch=lanes), _recording(entry, report) as rec:
            fit_sweep(ests, X, y, device=device)
        counts[n_cands] = rec.count()
        calls, want = rec.calls.get("gbm_reg_sweep", 0), _ROUNDS * -(-n_cands // lanes)
        if calls != want:
            report.violations.append(ContractViolation(
                "megabatch", entry,
                f"{calls} swept-round calls at {n_cands} candidates, {want} expected "
                f"({_ROUNDS} rounds x slabs of {lanes} lanes): the sweep must batch "
                "candidates over the lane axis, not call per candidate",
            ))
    (c_a, count_a), (c_b, count_b) = sorted(counts.items())
    report.budgets[entry] = count_a
    if count_a != count_b:
        report.violations.append(ContractViolation(
            "megabatch", entry,
            f"program count grew with candidate count ({c_a} candidates: "
            f"{count_a} programs, {c_b}: {count_b}): the sweep must batch "
            "candidates over the lane axis, not call per candidate",
        ))


def _trace_sampling(report: ContractReport, device) -> None:
    """The sampled fit's program set depends on the compacted row bucket
    only, never on the rates: GOSS (0.2, 0.1) and (0.3, 0.15) land in the
    same 32-row bucket and must call the same programs."""
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.autotune.resolve import override

    entry = "gbm_regressor.fit_sampled"
    X, y = _canonical_data(False)
    base = _gbm_regressor(st, sampling="goss")
    sets: Dict[Tuple[float, float], frozenset] = {}
    for rates in ((0.2, 0.1), (0.3, 0.15)):
        with override(sample_bucket_floor=16), _recording(entry, report) as rec:
            base.copy(top_rate=rates[0], other_rate=rates[1]).fit(X, y, device=device)
        # the config digest in a signature holds the rates; the shapes are
        # what must not move
        sets[rates] = frozenset((tag, _shapes_only(sig)) for tag, sig in rec.programs)
    (r_a, set_a), (r_b, set_b) = sorted(sets.items())
    report.budgets[entry] = len(set_a)
    if set_a != set_b:
        diff = sorted(tag for tag, _ in set_a.symmetric_difference(set_b))
        report.violations.append(ContractViolation(
            "sampling", entry,
            f"program set varies with sample rates ({r_a}: {len(set_a)} programs, "
            f"{r_b}: {len(set_b)}; differing tags {diff[:6]}): only the pow2 row "
            "bucket may shape a program",
        ))


def _shapes_only(sig: tuple) -> tuple:
    """A program signature without its ``("config", digest)`` entries."""
    return tuple(e for e in sig if not (isinstance(e, tuple) and e[:1] == ("config",)))


def _trace_tracing(report: ContractReport) -> None:
    """Spans are host-side only: beginning, nesting, ending and emitting
    them calls no program.  Also checks the records (one per unit of
    work, all on one trace)."""
    from spark_ensemble_tpu_torch.telemetry.trace import Tracer

    sink: List[Dict[str, Any]] = []
    tracer = Tracer(sink.append, thread="contract")
    with _recording("tracing.spans", report) as rec:
        with tracer.begin_span("fit", family="contract") as root:
            with tracer.begin_span("round_chunk", parent=root, chunk_seq=0):
                pass
            tracer.emit_span("shard_load", 0.0, 1e-3, parent=root.context(),
                             thread="se-tpu-shard")
    report.budgets["tracing.spans"] = rec.count()
    if len(sink) != 3 or any(s["trace_id"] != tracer.trace_id for s in sink):
        report.violations.append(ContractViolation(
            "tracing", "tracing.spans",
            f"expected 3 span records on trace {tracer.trace_id}, got "
            f"{[s.get('name') for s in sink]}",
        ))


def _trace_operator(report: ContractReport, device) -> None:
    """A full scrape (OpenMetrics render, ``/programz`` rows, a watchdog
    tick and verdict) over an inventory a real fit filled calls no
    program (``operator.scrape``); the watchdog and exporter hold no
    unfenced blocking read (``operator.lint``)."""
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.telemetry import exporter, programz, watchdog

    X, y = _canonical_data(False)
    inventory = programz.enable()
    inventory.clear()
    try:
        _gbm_regressor(st).fit(X, y, device=device)
        inventory.analyze_pending()
        dog = watchdog.Watchdog(interval_s=3600.0)
        with _recording("operator.scrape", report) as rec:
            text = exporter.render_openmetrics()
            rows = inventory.rows(top=10)
            dog.evaluate_once()
            verdict = dog.verdict()
        report.budgets["operator.scrape"] = rec.count()
        problems = exporter.validate_openmetrics(text)
        if problems:
            report.violations.append(ContractViolation(
                "operator", "operator.scrape",
                f"the /metrics exposition fails the OpenMetrics checker: {problems[:3]}",
            ))
        if not rows or verdict.get("status") not in ("ok", "degraded"):
            report.violations.append(ContractViolation(
                "operator", "operator.scrape",
                f"scrape returned no inventory rows ({len(rows)}) or a malformed "
                f"verdict ({verdict.get('status')!r})",
            ))
    finally:
        programz.disable()
        inventory.clear()
    findings = _unfenced(watchdog) + _unfenced(exporter)
    report.budgets["operator.lint"] = len(findings)
    for f in findings:
        report.violations.append(ContractViolation(
            "operator", "operator.lint",
            f"unfenced blocking read in an operator thread: {f.path}:{f.line}: "
            f"{f.message}",
        ))


def _trace_quality(report: ContractReport, device) -> None:
    """A drift-enabled engine warms as many programs as a drift-off twin
    (``quality.warmup``: the sketch rides the bucket programs); serving
    warmed requests with it stays one dispatch per request, captures
    nothing and equals the twin bit for bit
    (``quality.serve_dispatches_per_request``); ``telemetry/quality.py``
    holds no unfenced blocking read (``quality.lint``)."""
    import spark_ensemble_tpu_torch as st
    from spark_ensemble_tpu_torch.serving.engine import InferenceEngine
    from spark_ensemble_tpu_torch.serving.export import pack
    from spark_ensemble_tpu_torch.telemetry import quality
    from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot

    X, y = _canonical_data(False)
    packed = pack(_gbm_regressor(st).fit(X, y, device=device))
    if packed.quality is None:
        report.violations.append(ContractViolation(
            "quality", "quality.warmup",
            "pack(model) carries no drift reference (PackedModel.quality is "
            "None): a fit must capture the bin occupancy the sketch scores "
            "against",
        ))
        return
    opts = dict(methods=("predict",), min_bucket=8, max_batch_size=32, warm=True)
    off = InferenceEngine(packed, drift=False, **opts)
    on = InferenceEngine(packed, drift=True, **opts)
    try:
        n_off, n_on = len(off._compiled), len(on._compiled)
        report.budgets["quality.warmup"] = n_on
        if n_on != n_off:
            report.violations.append(ContractViolation(
                "quality", "quality.warmup",
                f"drift-on engine warmed {n_on} programs vs {n_off} with drift "
                "off: the sketch must ride the bucket programs, not add to them",
            ))
        sizes = (1, 7, 9, 30)
        calls = [0]

        def counted(run):
            def inner(*a, **k):
                calls[0] += 1
                return run(*a, **k)

            return inner

        for prog in on._compiled.values():
            prog.run = counted(prog.run)
        before = compile_snapshot()[0]
        for n in sizes:
            got, want = on.predict(X[:n]), off.predict(X[:n])
            if not np.array_equal(np.asarray(got), np.asarray(want)):
                report.violations.append(ContractViolation(
                    "quality", "quality.serve_dispatches_per_request",
                    f"drift-on predictions diverge from the drift-off twin at "
                    f"n={n}: the sketch must never touch the prediction",
                ))
                break
        after = compile_snapshot()[0]
        per, rem = divmod(calls[0], len(sizes))
        report.budgets["quality.serve_dispatches_per_request"] = (
            per if not rem else calls[0])
        if rem or after != before:
            report.violations.append(ContractViolation(
                "quality", "quality.serve_dispatches_per_request",
                f"{calls[0]} dispatch(es) and {after - before} capture(s) serving "
                f"{len(sizes)} warmed drift-on requests (must be one dispatch "
                "per request, zero captures)",
            ))
    finally:
        on.stop()
        off.stop()
    findings = _unfenced(quality)
    report.budgets["quality.lint"] = len(findings)
    for f in findings:
        report.violations.append(ContractViolation(
            "quality", "quality.lint",
            f"unfenced blocking read on the quality plane: {f.path}:{f.line}: "
            f"{f.message}",
        ))


def trace_contracts(
    entry_points: Optional[List[str]] = None,
    device="cuda",
    spawn_ranks: bool = False,
) -> ContractReport:
    """Fit/predict every family (plus the streaming, sweep, sampled and
    kernel fits, serving, the fleet and the operator plane) on the
    canonical fixtures under the scrubbed environment, on ``device``, and
    return the budgets and intrinsic violations.  ``entry_points`` names
    families (``gbm_regressor``, ...) or groups (``kernels``,
    ``host_reads``, ``builds``, ``serving``, ``fleet``, ``streaming``,
    ``distributed``, ``megabatch``, ``sampling``, ``tracing``,
    ``operator``, ``autopilot``, ``quality``); None runs all.
    ``spawn_ranks`` runs the distributed trace on spawned gloo ranks
    (else it is skipped).  Budget *drift* is judged separately by
    :func:`check_contracts` against the committed baseline."""
    from spark_ensemble_tpu_torch.models.base import resolve_device

    device = str(resolve_device(device))
    report = ContractReport()
    wanted = set(entry_points) if entry_points else None

    def want(group):
        return wanted is None or group in wanted

    with _scrubbed_env():
        for name, spec in _entry_points().items():
            if want(name):
                _trace_family(name, spec, report, device)
        groups = (
            ("kernels", lambda: _trace_kernels(report, device)),
            ("host_reads", lambda: _trace_host_reads(report, device)),
            ("builds", lambda: _trace_builds(report, device)),
            ("serving", lambda: _trace_serving(report, device)),
            ("fleet", lambda: _trace_fleet(report, device)),
            ("streaming", lambda: _trace_streaming(report, device)),
            ("distributed", lambda: _trace_streaming_dist(report, device, spawn_ranks)),
            ("megabatch", lambda: _trace_megabatch(report, device)),
            ("sampling", lambda: _trace_sampling(report, device)),
            ("tracing", lambda: _trace_tracing(report)),
            ("operator", lambda: _trace_operator(report, device)),
            ("autopilot", lambda: _trace_autopilot(report)),
            ("quality", lambda: _trace_quality(report, device)),
        )
        for group, run in groups:
            if want(group):
                run()
    return report


def load_baseline(path: Optional[str] = None) -> Optional[dict]:
    path = path or _BASELINE_PATH
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def check_contracts(
    baseline: Optional[dict] = None,
    report: Optional[ContractReport] = None,
    entry_points: Optional[List[str]] = None,
    device="cuda",
    spawn_ranks: bool = False,
) -> ContractReport:
    """Trace (unless a ``report`` is supplied) and verify the budgets
    against ``baseline`` (default: the committed ``contracts.json``).
    Budget drift — an entry point calling MORE or FEWER than pinned — is
    appended as ``budget`` violations with the one-command fix in the
    message; a pinned entry the trace skipped or did not run is not."""
    if report is None:
        report = trace_contracts(entry_points, device=device, spawn_ranks=spawn_ranks)
    if baseline is None:
        baseline = load_baseline()
    if baseline is None:
        report.violations.append(ContractViolation(
            "budget", "*",
            "no committed baseline (analysis/contracts.json); generate one "
            "with `python tools/graftlint_torch.py --update-baseline`",
        ))
        return report
    pinned: Dict[str, int] = baseline.get("entry_points", {})
    for entry in sorted(set(pinned) | set(report.budgets)):
        if entry_points and not any(entry.startswith(e) for e in entry_points):
            continue
        want, got = pinned.get(entry), report.budgets.get(entry)
        if want is None:
            report.violations.append(ContractViolation(
                "budget", entry,
                f"entry point not in the committed baseline (measures {got}); "
                "re-pin with `python tools/graftlint_torch.py --update-baseline`",
            ))
        elif got is None:
            continue  # partial trace, or a budget this device cannot measure
        elif got != want:
            report.violations.append(ContractViolation(
                "budget", entry,
                f"budget drift: {got} against {want} pinned; if intentional "
                "re-pin with `python tools/graftlint_torch.py --update-baseline`",
            ))
    return report


def update_baseline(path: Optional[str] = None, device="cuda",
                    spawn_ranks: bool = True) -> dict:
    """Regenerate ``analysis/contracts.json`` from a fresh trace (the
    ``--update-baseline`` flow) and return the written baseline.  An entry
    the trace skipped (a card-only budget traced on the CPU) keeps its
    existing pin."""
    path = path or _BASELINE_PATH
    report = trace_contracts(device=device, spawn_ranks=spawn_ranks)
    old = (load_baseline(path) or {}).get("entry_points", {})
    for entry in report.skipped:
        if entry in old and entry not in report.budgets:
            report.budgets[entry] = old[entry]
    base = report.baseline()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(base, f, indent=2, sort_keys=True)
        f.write("\n")
    return base


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-rank":
        sys.exit(_dist_rank(json.loads(sys.argv[2])))
    sys.exit("usage: python -m spark_ensemble_tpu_torch.analysis.contracts "
             "--dist-rank '<json>'")
