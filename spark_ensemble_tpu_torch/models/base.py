"""Estimator/Model base classes and the BaseLearner functional protocol
(PyTorch port of ``spark_ensemble_tpu/models/base.py``).

A base learner exposes the same functional triple as in the JAX package:

  - ``make_fit_ctx(X, num_classes)``: shared preprocessing computed once per
    ensemble fit (quantile binning for trees);
  - ``fit_from_ctx(ctx, y, w, feature_mask, key=None, axis_name=None)
    -> params``: one member fit over fixed-shape tensors; row sampling
    arrives as ``w``, feature subspaces as ``feature_mask``, and the
    member's PRNG key (``int64[2]``, ``utils/random.py``) as ``key`` for
    the learners that draw (the MLP's initial weights; trees, linear
    models and naive Bayes ignore it).  Under a mesh the tensors hold this
    rank's rows and ``axis_name`` is the mesh's row axis
    (``ops/collective.Axis``): the learner reduces its sufficient
    statistics over it, so every rank computes the same global model (the
    reference's executors combining partition statistics with
    ``treeAggregate``);
  - ``predict_fn(params, X)`` (+ ``predict_raw_fn``/``predict_proba_fn``).

The ensembles hand out the JAX package's keys: Bagging member ``i`` gets
``fold_in(PRNGKey(seed), i)``, Boosting round ``i`` the same, and a GBM
round its bag key, ONE key for all of a classifier's class dims (the JAX
package broadcasts a ``[2]`` key over the members of
``fit_many_from_ctx``).  A standalone ``fit`` draws from
``PRNGKey(seed)``.

Member params are nested dicts, lists and tuples of tensors (a ``Tree``
is a NamedTuple); :func:`tree_map` and :func:`stack_members` handle any of
them, so an ensemble stacks its members with a leading member axis
whatever the learner.  Learners without a fused multi-member fit inherit
a loop over the members (``fit_many_from_ctx``, ``predict_many_fn``).

:func:`shared_fit_context` scopes a memo of fit contexts, keyed by X's
identity and the learner's ``config_key``: inside it, every fit of the
same data and learner config (the tuners' param maps and folds) bins once.
A learner's ``ctx_row_leaves(ctx)`` marks the ctx entries that are
row-indexed (the stand-in for the JAX package's ``ctx_specs``): a mesh fit
cuts those to each rank's rows (``parallel/mesh.shard_ctx_rows``) and
keeps the rest whole.  ``fit(..., mesh=...)`` fits a learner standalone
over a mesh's rows.

Devices: every ``fit`` takes ``device`` (default ``"cuda"``); the fitted
model keeps its tensors there and moves predict inputs to it.  Asking for
CUDA where there is none raises — nothing falls back to the CPU.

Programs: the port compiles no programs, so a "program" is one call of a
chokepoint the JAX package runs as one cached program: a GBM, Boosting or
Bagging round chunk, an elastic sweep step, an ensemble model's predict,
an engine graph.  :func:`program_call` scopes one such call under the JAX
package's tag; while a sink (:func:`set_program_sink`, the operator
plane's program inventory) or an observer (:func:`observe_program_calls`)
is installed, the scope keys the call by ``(tag, shape signature)``,
collects the work the kernel wrappers report while it runs on this thread
(:func:`open_programs`: a nested program's work counts in its own call
and in every enclosing one, as a JAX program inlines what it calls), and
hands the call to the sink when it returns.  A CUDA-graph capture
(:func:`capture_program_work`) collects the work its launches would do
and reports no call, nested ones included.  With neither sink nor
observer installed the scope is a shared no-op.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from spark_ensemble_tpu_torch.params import Param, Params, gt_eq, in_array
# validate_fit_inputs lives in robustness/ (the JAX package's layout);
# this module's name for it stays importable
from spark_ensemble_tpu_torch.robustness.validate import (  # noqa: F401
    validate_fit_inputs,
)
from spark_ensemble_tpu_torch.utils.instrumentation import instrumented_fit
from spark_ensemble_tpu_torch.utils.random import PRNGKey


# ---------------------------------------------------------------------------
# program calls (the operator plane's chokepoints)
# ---------------------------------------------------------------------------

# scoped program-call observers: ``callback(tag, signature)`` per call
_PROGRAM_OBSERVERS: list = []

# the operator plane's sink: ``sink(call) -> record``, one slot, so a
# chokepoint with neither sink nor observer pays one global load
_PROGRAM_SINK: list = [None]

# each thread's open program calls, innermost last: stacking's member
# threads, the autopilot's refresh fit and the fleet's replicas run
# programs side by side
_PROGRAM_TLS = threading.local()


def set_program_sink(sink) -> None:
    """Install (or, with ``None``, remove) the process-wide program-call
    sink: ``sink(call)`` with a finished :class:`ProgramCall`, returning
    the inventory record it went into; a sink with ``begin_call(call)`` is
    also told of each call as it starts.  One slot only: the operator
    plane owns it (``telemetry/programz.py``)."""
    _PROGRAM_SINK[0] = sink


def observe_program_calls(callback):
    """Context manager registering ``callback(tag, signature)`` for every
    program call in the enclosed scope; callbacks must be thread-safe."""

    @contextlib.contextmanager
    def _scope():
        _PROGRAM_OBSERVERS.append(callback)
        try:
            yield
        finally:
            _PROGRAM_OBSERVERS.remove(callback)

    return _scope()


def program_signature(args) -> tuple:
    """Shape signature of a call's arguments: ``(shape, dtype)`` of each
    tensor or array, ``("config", digest)`` of an estimator's
    ``config_key`` (the config a JAX program key holds), ``(type, repr)``
    of anything else."""
    sig = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            sig.append((tuple(shape), str(getattr(a, "dtype", ""))))
        elif isinstance(a, Params):
            digest = hashlib.sha1(repr(a.config_key()).encode()).hexdigest()
            sig.append(("config", digest[:12]))
        else:
            sig.append((type(a).__name__, repr(a)[:48]))
    return tuple(sig)


class ProgramCall:
    """One program call: its tag and signature, the kernel work reported
    while it ran (``work[kernel] = [launches, bytes, ops]``), its host
    wall, and the inventory record the sink put it in."""

    __slots__ = ("tag", "signature", "work", "call_s", "record", "peak0",
                 "report", "_t0")

    def __init__(self, tag: str, signature: tuple, work=None, report=True):
        self.tag = tag
        self.report = report
        self.signature = signature
        self.work = {k: list(v) for k, v in (work or {}).items()}
        self.call_s = 0.0
        self.record = None
        self.peak0 = None  # the allocator's peak before a deep-analyzed call

    def add_work(self, kernel: str, nbytes: int, nops: int) -> None:
        w = self.work.setdefault(kernel, [0, 0, 0])
        w[0] += 1
        w[1] += nbytes
        w[2] += nops

    def totals(self) -> tuple:
        """``(launches, bytes, ops)`` over every kernel of the call."""
        return tuple(sum(w[i] for w in self.work.values()) for i in range(3))

    def __enter__(self) -> "ProgramCall":
        stack = getattr(_PROGRAM_TLS, "stack", None)
        if stack is None:
            stack = _PROGRAM_TLS.stack = []
        stack.append(self)
        begin = getattr(_PROGRAM_SINK[0], "begin_call", None)
        if begin is not None:
            begin(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.call_s = time.perf_counter() - self._t0
        _PROGRAM_TLS.stack.pop()
        if exc_type is not None or not self.report:
            return
        for cb in list(_PROGRAM_OBSERVERS):
            cb(self.tag, self.signature)
        sink = _PROGRAM_SINK[0]
        if sink is not None:
            self.record = sink(self)


class _NoProgram:
    """The shared scope when nothing watches programs: yields None."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_PROGRAM = _NoProgram()


def program_call(tag: str, *args, work=None):
    """Scope of one call of the program ``tag`` over ``args`` (tensors or
    static values: its signature).  ``work`` seeds the call's kernel work:
    a CUDA-graph replay runs no wrapper, so the engine passes the work its
    capture recorded.  A no-op, yielding None, unless a sink or an
    observer is installed."""
    if _PROGRAM_SINK[0] is None and not _PROGRAM_OBSERVERS:
        return _NO_PROGRAM
    stack = getattr(_PROGRAM_TLS, "stack", None)
    if stack and not stack[-1].report:
        return _NO_PROGRAM  # inside a capture: nothing runs
    return ProgramCall(tag, program_signature(args), work)


def capture_program_work(tag: str):
    """Scope of a CUDA-graph capture: collects the work the launches it
    records report, and reports no call (a replay reports one, seeded
    with this work).  A no-op, yielding None, unless a sink or an observer
    is installed."""
    if _PROGRAM_SINK[0] is None and not _PROGRAM_OBSERVERS:
        return _NO_PROGRAM
    return ProgramCall(tag, (), report=False)


def open_programs() -> List[ProgramCall]:
    """This thread's open program calls, outermost first: each takes the
    kernel work reported while it is open."""
    return getattr(_PROGRAM_TLS, "stack", None) or []


def predict_program(name: str):
    """Decorator scoping a model's predict entry point as the program
    ``predict:<name>`` (the JAX package's ``_predict_program`` tags)."""

    def wrap(fn):
        tag = f"predict:{name}"

        @functools.wraps(fn)
        def scoped(self, X, *args, **kwargs):
            with program_call(tag, X):
                return fn(self, X, *args, **kwargs)

        return scoped

    return wrap


def resolved_scan_chunk(est, n_rows=None) -> int:
    """Rounds per chunk of an iterative estimator's round loop: a hand-set
    ``scan_chunk`` always wins; left at its default, a measured winner for
    this device and shape class (the ``scan_chunk`` tunable) replaces the
    default literal."""
    chunk = max(int(est.scan_chunk), 1)
    if "scan_chunk" in est._param_values:
        return chunk
    from spark_ensemble_tpu_torch.autotune.resolve import resolve as _tuned

    return max(int(_tuned("scan_chunk", chunk, n=n_rows)), 1)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent.  On CUDA, float32 matmuls are pinned to true fp32 (TF32 off):
    the ``"highest"`` precision contract of the histogram tiers."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        # "highest" is true fp32: TF32 keeps ~10 mantissa bits and would
        # move split choices against the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def as_f32(x, device=None) -> torch.Tensor:
    """``x`` (numpy, list or tensor) as a float32 tensor on ``device``
    (the tensor's own device when None)."""
    if isinstance(x, torch.Tensor):
        t = x.to(dtype=torch.float32)
        return t if device is None else t.to(device)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def mesh_fit_kwargs(estimator, mesh) -> dict:
    """``{"mesh": mesh}`` when the estimator's fit takes a mesh, else
    ``{}``: composite fits forward a mesh without caring which stages are
    mesh-aware."""
    if mesh is None:
        return {}
    import inspect

    if "mesh" in inspect.signature(estimator.fit).parameters:
        return {"mesh": mesh}
    return {}


def mesh_device(mesh, device) -> torch.device:
    """The device of a mesh fit: the mesh's own (``cuda:{local rank}`` for
    a CUDA mesh).  A ``device`` of another type, or another card, raises:
    nothing moves to the CPU behind the caller's back."""
    dev = resolve_device(mesh.device)
    want = torch.device(device)
    if want.type != dev.type or (want.index is not None and want != dev):
        raise ValueError(
            f"device={device!r} disagrees with the mesh's device {dev}; a "
            "mesh fit runs on its mesh's devices"
        )
    return dev


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensors of one or more params trees of the same
    structure (dicts, lists, tuples and NamedTuples of tensors; ``None``
    stays ``None``)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree, in ``tree_map`` order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def stack_members(members: List):
    """Per-member params trees -> one tree with a leading member axis."""
    return tree_map(lambda *xs: torch.stack(xs), *members)


def member_params(params, i: int):
    """Member ``i`` of params stacked along a leading member axis."""
    return tree_map(lambda a: a[i], params)


def num_stacked(params) -> int:
    """The leading member-axis length of stacked params."""
    return tree_leaves(params)[0].shape[0]


def _member_key(keys, m: int):
    """Member ``m``'s key: ``keys [M, 2]`` per member, or one ``[2]`` key
    broadcast to every member (the JAX package's ``fit_many_from_ctx``)."""
    if keys is None or keys.dim() == 1:
        return keys
    return keys[m]


def _member_mask(feature_masks, m: int):
    if feature_masks is None or feature_masks.dim() == 1:
        return feature_masks
    return feature_masks[m]


# ---------------------------------------------------------------------------
# shared fit-context scope (the tuners' binning reuse)
# ---------------------------------------------------------------------------

_FIT_CTX_SCOPE = threading.local()


def shared_fit_context():
    """Context manager activating a fit-ctx memo for the enclosed fits
    (nests by stacking: the inner scope wins, the outer is restored)."""

    @contextlib.contextmanager
    def _scope():
        prev = getattr(_FIT_CTX_SCOPE, "cache", None)
        _FIT_CTX_SCOPE.cache = {}
        try:
            yield
        finally:
            _FIT_CTX_SCOPE.cache = prev

    return _scope()


def make_shared_fit_ctx(learner, X, num_classes: Optional[int] = None):
    """``learner.make_fit_ctx(X, num_classes)`` memoized under the active
    :func:`shared_fit_context` scope (one binning pass per distinct data
    and learner config), or computed directly when no scope is active.
    Keyed by ``id(X)`` with its shape, dtype and device and the learner's
    ``config_key()``; the entry pins ``X``, so a recycled ``id`` cannot
    alias another matrix within a scope.  The work is the ``fit.bin`` span
    (``telemetry/trace.py``)."""
    # lazy import: the telemetry package imports this module
    from spark_ensemble_tpu_torch.telemetry.trace import span

    with span("fit.bin"):
        cache = getattr(_FIT_CTX_SCOPE, "cache", None)
        if cache is None:
            return learner.make_fit_ctx(X, num_classes)
        key = (id(X), tuple(X.shape), str(X.dtype), str(X.device),
               learner.config_key(), num_classes)
        hit = cache.get(key)
        if hit is None:
            hit = (X, learner.make_fit_ctx(X, num_classes))
            cache[key] = hit
        return hit[1]


def resolve_weights(y: torch.Tensor, sample_weight) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones_like(y, dtype=torch.float32)
    return as_f32(sample_weight, y.device)


def infer_num_classes(y, num_classes: Optional[int] = None) -> int:
    """Class count from labels, with the reference's label validation:
    labels must be finite non-negative integers; an explicit
    ``num_classes`` overrides inference and labels must lie in [0, K)."""
    ya = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    if ya.size == 0:
        raise ValueError("cannot infer num_classes from empty labels")
    if not np.all(np.isfinite(ya)):
        raise ValueError("classification labels must be finite")
    if np.any(ya != np.round(ya)) or np.any(ya < 0):
        bad = ya[(ya != np.round(ya)) | (ya < 0)][0]
        raise ValueError(
            f"classification labels must be non-negative integers; got {bad!r}"
        )
    k = int(ya.max()) + 1
    if num_classes is not None:
        num_classes = int(num_classes)
        if num_classes < 2:
            raise ValueError(f"num_classes must be >= 2; got {num_classes}")
        if k > num_classes:
            raise ValueError(
                f"labels contain class {k - 1} but num_classes={num_classes}; "
                f"labels must lie in [0, num_classes)"
            )
        return num_classes
    return max(k, 2)


class Model(Params):
    """A fitted model: estimator config + learned params on ``device``."""

    def __init__(self, params: Any = None, num_features: int = 0,
                 device=None, **kwargs):
        super().__init__(**kwargs)
        self.params = params
        self.num_features = num_features
        self.device = torch.device(device) if device is not None else None

    def _input(self, X) -> torch.Tensor:
        return as_f32(X, self.device)

    def predict(self, X) -> torch.Tensor:
        raise NotImplementedError

    @property
    def feature_importances_(self) -> np.ndarray:
        """Gain-based feature importances, normalized to sum 1 (Spark
        ``TreeEnsembleModel.featureImportances``): each member tree's gains
        are normalized to sum 1 first, members average with equal weight,
        and the average is renormalized.  Members with no realized split
        are skipped; an all-leaf model returns zeros."""
        gains = np.asarray(self._feature_gains_raw(), np.float64)
        gains = gains.reshape(-1, gains.shape[-1])
        sums = gains.sum(axis=1, keepdims=True)
        active = sums[:, 0] > 0
        if not active.any():
            return np.zeros(gains.shape[-1])
        imp = (gains[active] / sums[active]).mean(axis=0)
        return imp / imp.sum()

    def _feature_gains_raw(self):
        """Raw gains: ensemble models reach through their stacked members
        with the base learner's ``feature_gains_fn``; a standalone learner
        model is its own learner."""
        if isinstance(self.params, dict) and "members" in self.params:
            members = self.params["members"]
            if members is None:  # zero kept rounds or members
                return np.zeros((self.num_features,))
            gains = self._base().feature_gains_fn(members, self.num_features)
            return gains.detach().cpu().numpy()
        gains_fn = getattr(self, "feature_gains_fn", None)
        if gains_fn is None:
            raise AttributeError(
                f"{type(self).__name__} has no feature gains (gain-based "
                "importances exist for tree base learners only)"
            )
        return gains_fn(self.params, self.num_features).detach().cpu().numpy()

    def member(self, i: int) -> "Model":
        """Member ``i`` as a standalone fitted model, sliced out of the
        stacked members (a subspace-trained member predicts correctly
        without its mask: its splits never use masked features)."""
        if not (isinstance(self.params, dict) and "members" in self.params):
            raise AttributeError(f"{type(self).__name__} has no stacked members")
        members = self.params["members"]
        if members is None:
            raise IndexError("model kept zero members")
        n_members = num_stacked(members)
        if not 0 <= i < n_members:
            raise IndexError(f"member index {i} out of range [0, {n_members})")
        base = self._base()
        return base.model_from_params(
            member_params(members, i),
            self.num_features,
            getattr(self, "num_classes", None) if base.is_classifier else None,
            self.device,
        )

    @property
    def feature_metadata(self):
        """Feature names of this model's input columns
        (`Utils.getFeaturesMetadata`, `Utils.scala:42-61`); anonymous
        ``f{i}`` names when the ``feature_names`` param was not set."""
        from spark_ensemble_tpu_torch.utils.features import FeatureMetadata

        return FeatureMetadata.resolve(
            getattr(self, "feature_names", None), self.num_features
        )

    def member_feature_names(self, i: int):
        """Feature names of member ``i``'s subspace, re-indexed through its
        mask as the reference re-indexes column metadata after
        ``slice()``."""
        masks = self.params.get("masks") if isinstance(self.params, dict) else None
        if masks is None:
            raise AttributeError(
                f"{type(self).__name__} has no per-member feature subspaces"
            )
        return self.feature_metadata.select(
            masks[i].detach().cpu().numpy().astype(bool)
        ).names

    def pack(self):
        """This model compacted for serving: a :class:`~spark_ensemble_tpu_torch.
        serving.export.PackedModel` (``serving/export.py::pack``) on the
        model's device, with bit-identical predictions."""
        from spark_ensemble_tpu_torch.serving.export import pack

        return pack(self)

    def _persisted_params(self):
        """The learned params a save writes: all of them, unless a model
        keeps a diagnostic the JAX package's format has no key for."""
        return self.params

    def save(self, path: str):
        """Save to the directory ``path`` (``utils/persist.py``; the JAX
        package's format, so either package loads it)."""
        from spark_ensemble_tpu_torch.utils import persist

        persist.save(self, path)


class RegressionModel(Model):
    def score(self, X, y, sample_weight=None) -> float:
        """R^2 on (X, y): ``RegressionEvaluator(metric="r2")``."""
        from spark_ensemble_tpu_torch.evaluation import RegressionEvaluator

        return RegressionEvaluator(metric="r2").evaluate(self, X, y, sample_weight)


class ClassificationModel(Model):
    """Adds raw scores / probabilities (reference: ProbabilisticClassifier)."""

    def __init__(self, num_classes: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes

    def predict_raw(self, X) -> torch.Tensor:
        raise NotImplementedError

    def predict_proba(self, X) -> torch.Tensor:
        raise NotImplementedError

    def predict(self, X) -> torch.Tensor:
        return torch.argmax(self.predict_proba(X), dim=-1).to(torch.float32)

    def score(self, X, y, sample_weight=None) -> float:
        """Accuracy on (X, y):
        ``MulticlassClassificationEvaluator(metric="accuracy")``."""
        from spark_ensemble_tpu_torch.evaluation import (
            MulticlassClassificationEvaluator,
        )

        return MulticlassClassificationEvaluator(metric="accuracy").evaluate(
            self, X, y, sample_weight
        )


def _with_guard_events(guard, model):
    """``model`` carrying its fit's guard record as ``guard_events_`` (the
    round index and action of every detection, also on the telemetry
    stream as ``guard_nonfinite`` events)."""
    model.guard_events_ = guard.events
    return model


class CheckpointableParams(Params):
    """Checkpoint and resume plumbing shared by the iterative estimators
    (GBM, Boosting): one copy of the resume-identity exclusions, the
    members layout marker, the checkpointer factory and the warm-resume
    hooks ``fit_resume`` installs."""

    # params that do not change the round math: left out of the resume
    # fingerprint, so budget, cadence and policy changes keep checkpoints
    # resumable
    _RESUME_EXCLUDED = (
        "num_base_learners",
        "checkpoint_interval",
        "checkpoint_dir",
        "profile_dir",
        "telemetry_path",
        "feature_names",
        "scan_chunk",
        "on_nonfinite",
        "max_retries",
        "allow_nan",
    )

    # written into every checkpoint state, so the members layout is explicit
    MEMBERS_LAYOUT = "stacked"

    def _resume_identity(self):
        from spark_ensemble_tpu_torch.utils.persist import params_to_json_dict

        p = params_to_json_dict(self)
        for k in self._RESUME_EXCLUDED:
            p.pop(k, None)
        return p

    @staticmethod
    def _resume_chunks(st, weights_key: str = "weights"):
        """Checkpointed members and weights -> round-stacked chunk lists
        (one chunk holding every committed round)."""
        layout = st.get("members_layout")
        if layout != CheckpointableParams.MEMBERS_LAYOUT:
            raise ValueError(
                f"unrecognized checkpoint members_layout {layout!r}; "
                f"expected {CheckpointableParams.MEMBERS_LAYOUT!r}"
            )
        return [st["members"]], [st[weights_key].to(torch.float32)]

    def _checkpointer(self, device, *shape_parts, telem=None, axis=None):
        """The fit's checkpointer, reporting to the fit's telemetry
        ``telem``.  The fingerprint's shape parts are the port's own
        (tagged ``"torch"``), so a checkpoint the JAX package wrote starts
        a fresh fit (logged) instead of a half-way resume.  Under a mesh
        (``axis``, every rank of it) each rank writes its own
        ``checkpoint_dir``: ranks given one directory, or some ranks a
        directory and others none, raise ``ValueError`` on every rank
        (``utils/checkpoint.check_rank_directories``)."""
        from spark_ensemble_tpu_torch.utils.checkpoint import (
            TrainingCheckpointer,
            check_rank_directories,
            run_fingerprint,
        )

        if axis is not None:
            check_rank_directories(self.checkpoint_dir, axis)
        return TrainingCheckpointer(
            self.checkpoint_dir,
            self.checkpoint_interval,
            fingerprint=run_fingerprint(
                type(self).__name__, self._resume_identity(), "torch",
                *[int(s) for s in shape_parts],
            ),
            retry_policy=self._retry_policy(),
            device=device,
            telem=telem,
        )

    # -- warm-start resume (fit_resume) -----------------------------------
    #
    # The first k rounds of a stagewise fit are the state a checkpoint at
    # round k-1 would hold.  fit_resume synthesizes that state and installs
    # it here; the next fit() consumes it exactly like a loaded checkpoint.
    # A real on-disk checkpoint always wins.

    def _set_warm_resume(self, last_round, st):
        self._warm_resume_state = (int(last_round), dict(st))
        # marks this estimator as a refresh fit: the round loops expose the
        # chaos ``refresh_crash`` sites only then, so a foreground fit can
        # never trip a refresh-targeted fault
        self._refresh_active = True

    def _take_warm_resume(self):
        state = getattr(self, "_warm_resume_state", None)
        self._warm_resume_state = None
        return state

    @property
    def _is_refresh_fit(self):
        return bool(getattr(self, "_refresh_active", False))

    def _load_resume(self, ckpt, telem, axis=None):
        """The state a fit resumes from, or None: the newest loadable
        checkpoint, else a ``fit_resume`` warm start.  A
        resume emits ``resume_from_checkpoint`` (the round it resumes at
        and which copy it came from) on the fit's telemetry.  Under a mesh
        (``axis``) every rank must resume at the same round: ranks whose
        checkpoints disagree all start fresh (``utils/checkpoint.
        agree_resume``)."""
        from spark_ensemble_tpu_torch.utils.checkpoint import agree_resume

        resumed = ckpt.load_latest()
        warm = False
        if resumed is None:
            resumed = self._take_warm_resume()
            warm = resumed is not None
        resumed = agree_resume(resumed, axis, telem)
        if resumed is not None:
            detail = ckpt.last_load_detail or {}
            telem.emit(
                "resume_from_checkpoint",
                round=resumed[0] + 1,
                source="warm_start" if warm else detail.get("source", "latest"),
                fallback=bool(detail.get("fallback", False)),
            )
        return resumed


class Estimator(Params):
    """Base estimator: ``fit(X, y, sample_weight, device=...) -> Model``."""

    is_classifier = False
    supports_weight = True

    profile_dir = Param(
        None,
        doc="when set, every fit() captures a torch.profiler trace of CPU "
        "and CUDA activity into this directory as a Chrome trace "
        "(utils/profiling.py summarizes it)",
    )
    telemetry_path = Param(
        None,
        doc="when set, every fit() appends its structured telemetry event "
        "stream (round timings, losses, per-phase costs, kernel-build "
        "counts, device memory stats) to this JSONL file; the "
        "SE_TPU_TELEMETRY environment variable is the no-code-change "
        "equivalent (docs/telemetry.md).  Not part of the checkpoint-resume "
        "identity, and a fit's model is bit-identical with it on or off",
    )
    feature_names = Param(
        None, doc="optional column names for X; carried onto fitted models"
    )
    on_nonfinite = Param(
        "raise",
        in_array(["off", "raise", "skip_round", "halve_step", "stop_early"]),
        doc="numeric-guard policy when a round produces non-finite outputs "
        "(NaN member params, non-finite losses or step sizes): 'raise' "
        "fails fast with NonFiniteError, 'skip_round' drops the poisoned "
        "round's contribution and keeps training, 'halve_step' re-runs the "
        "round at a halved step until finite (families without a scalable "
        "step degrade to skip), 'stop_early' truncates the ensemble to the "
        "last good round, 'off' disables the check.  Detection is one fused "
        "reduction per round chunk, read with the chunk's validation losses",
    )
    max_retries = Param(
        2,
        gt_eq(0),
        doc="retries (exponential backoff with deterministic jitter) of a "
        "round chunk, member fit or checkpoint write that fails with a "
        "RuntimeError/OSError; a retry re-launches the same kernels from the "
        "same carry.  0 disables retry",
    )
    allow_nan = Param(
        False,
        doc="skip the fail-fast NaN/Inf validation of X/y at fit() entry",
    )

    def fit(self, X, y, sample_weight=None, device="cuda") -> Model:
        raise NotImplementedError

    def save(self, path: str):
        """Save this estimator's config to the directory ``path``."""
        from spark_ensemble_tpu_torch.utils import persist

        persist.save(self, path)

    def _retry_policy(self):
        """The retry policy of this estimator's ``max_retries``."""
        from spark_ensemble_tpu_torch.robustness.retry import RetryPolicy

        return RetryPolicy(max_retries=int(self.max_retries))

    def _numeric_guard(self, telem=None):
        """A per-fit :class:`NumericGuard` of this ``on_nonfinite`` policy,
        reporting to the fit's telemetry stream."""
        from spark_ensemble_tpu_torch.robustness.guards import NumericGuard

        return NumericGuard(str(self.on_nonfinite).lower(),
                            family=type(self).__name__, telem=telem)

    def _validate_fit_inputs(self, X, y=None):
        validate_fit_inputs(
            X, y, allow_nan=bool(self.allow_nan), family=type(self).__name__
        )


class BaseLearner(Estimator):
    """An estimator trainable through the functional member protocol."""

    def make_fit_ctx(self, X: torch.Tensor, num_classes: Optional[int] = None):
        """Shared preprocessing (binning, feature stats)."""
        return X

    def ctx_row_leaves(self, ctx):
        """The ctx's row-indexed entries (a tree of bools shaped like the
        ctx): the default ctx is the feature matrix itself."""
        return None if ctx is None else True

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None, axis_name=None):
        """One member fit -> params; under a mesh, over this rank's rows
        with the statistics reduced over ``axis_name``."""
        raise NotImplementedError

    def fit_many_from_ctx(self, ctx, ys, ws, feature_masks, keys=None,
                          axis_name=None):
        """Fit M members (``ys``/``ws`` [n, M]; ``feature_masks`` [M, d],
        [d] or None; ``keys`` [M, 2], one [2] key for every member, or
        None) -> stacked params with a leading member axis.  Default: one
        ``fit_from_ctx`` per member, stacked; tree learners fuse the
        members into one forest fit (``ops.tree.fit_forest``) and the MLP
        batches them along a member axis."""
        members = [
            self.fit_from_ctx(ctx, ys[:, m].contiguous(), ws[:, m].contiguous(),
                              _member_mask(feature_masks, m),
                              key=_member_key(keys, m), axis_name=axis_name)
            for m in range(ys.shape[1])
        ]
        return stack_members(members)

    def fit_and_direction(self, ctx, y, w, feature_mask, X, key=None,
                          axis_name=None):
        """Member fit PLUS its predictions on the same rows -> (params,
        pred[n]).  Default: fit then predict."""
        params = self.fit_from_ctx(ctx, y, w, feature_mask, key=key,
                                   axis_name=axis_name)
        return params, self.predict_fn(params, X)

    def fit_and_proba(self, ctx, y, w, feature_mask, X, key=None,
                      axis_name=None):
        """Classifier member fit PLUS its class probabilities on the same
        rows (SAMME.R's input) -> (params, proba[n, k])."""
        params = self.fit_from_ctx(ctx, y, w, feature_mask, key=key,
                                   axis_name=axis_name)
        return params, self.predict_proba_fn(params, X)

    def fit_many_and_directions(self, ctx, ys, ws, feature_masks, X, keys=None,
                                axis_name=None):
        """Fused-member analogue of ``fit_and_direction`` -> (stacked
        params, preds[n, M])."""
        params = self.fit_many_from_ctx(ctx, ys, ws, feature_masks, keys=keys,
                                        axis_name=axis_name)
        return params, self.predict_many_fn(params, X).T

    def ctx_gather_rows(self, ctx, idx: torch.Tensor):
        """The fit ctx's rows ``idx[m]`` in a compacted ctx (GBM's gradient
        row sampling): downstream fits then process ``m`` rows.  The
        default ctx is the feature matrix itself; learners whose ctx mixes
        row-indexed and shared entries override (trees gather the bins and
        keep the thresholds)."""
        return ctx[idx]

    def fit_gathered_and_direction(self, ctx_s, y_s, w_s, feature_mask, X,
                                   key=None, axis_name=None):
        """Member fit on a compacted ctx (``ctx_gather_rows``) PLUS the
        fitted member's predictions on ALL rows ``X`` -> (params, pred[n])."""
        params = self.fit_from_ctx(ctx_s, y_s, w_s, feature_mask, key=key,
                                   axis_name=axis_name)
        return params, self.predict_fn(params, X)

    def fit_gathered_many_and_directions(self, ctx_s, ys_s, ws_s,
                                         feature_masks, X, keys=None,
                                         axis_name=None):
        """Fused-member analogue of ``fit_gathered_and_direction`` ->
        (stacked params, preds[n, M])."""
        params = self.fit_many_from_ctx(ctx_s, ys_s, ws_s, feature_masks,
                                        keys=keys, axis_name=axis_name)
        return params, self.predict_many_fn(params, X).T

    def predict_fn(self, params, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def predict_many_fn(self, params, X: torch.Tensor) -> torch.Tensor:
        """Stacked-member predict -> [M, n].  Default: ``predict_fn`` per
        member; tree learners route every member at once."""
        return torch.stack([self.predict_fn(member_params(params, m), X)
                            for m in range(num_stacked(params))])

    def predict_proba_many_fn(self, params, X: torch.Tensor) -> torch.Tensor:
        """Stacked-member probabilities -> [M, n, k]."""
        return torch.stack([self.predict_proba_fn(member_params(params, m), X)
                            for m in range(num_stacked(params))])

    def predict_raw_fn(self, params, X):
        raise NotImplementedError

    def predict_proba_fn(self, params, X):
        raise NotImplementedError

    def feature_gains_fn(self, params, d: int):
        """Per-feature split-gain sums; only learners with an impurity-gain
        notion (trees) have them."""
        raise AttributeError(
            f"{type(self).__name__} has no feature gains (gain-based "
            "importances exist for tree base learners only)"
        )

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None) -> Model:
        raise NotImplementedError

    @instrumented_fit
    def fit(self, X, y, sample_weight=None, num_classes=None, mesh=None,
            device="cuda") -> Model:
        """Fit this learner standalone on ``device``, from the key
        ``PRNGKey(seed)`` (0 for a learner without a ``seed``).  With
        ``mesh`` (``parallel/mesh.py``; every rank calls with the same
        arrays) each rank fits over its block of the rows, zero-weight
        padding included, reducing its statistics over the mesh's row
        axis, and every rank returns the same model."""
        dev = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        # lazy import: the telemetry package imports this module
        from spark_ensemble_tpu_torch.telemetry.trace import span

        with span("fit.validate"):
            X = as_f32(X, dev)
            y = as_f32(y, dev)
            self._validate_fit_inputs(X, y)
            w = resolve_weights(y, sample_weight)
            num_classes = (
                infer_num_classes(y, num_classes) if self.is_classifier else None
            )
        ctx = make_shared_fit_ctx(self, X, num_classes)
        key = PRNGKey(getattr(self, "seed", 0) or 0, dev)
        if mesh is None:
            params = self.fit_from_ctx(ctx, y, w, None, key=key)
        else:
            from spark_ensemble_tpu_torch.parallel.mesh import (
                shard_ctx_rows,
                shard_rows,
            )

            n = y.shape[0]
            params = self.fit_from_ctx(
                shard_ctx_rows(mesh, self, ctx, n), shard_rows(mesh, y, n),
                shard_rows(mesh, w, n), None, key=key, axis_name=mesh.row_axis,
            )
        return self.model_from_params(params, X.shape[1], num_classes, dev)
