"""The port's public surface held method by method against the JAX package.

For every class in ``spark_ensemble_tpu.__all__``: every public attribute
of the JAX class exists on the port's class of the same name, and every
named parameter (not ``*args``/``**kwargs``) of each public callable and of
the constructor exists in the port's signature; the parameters the JAX
package takes by position come first, in its order.  Every function in
``__all__`` is held the same way, and so is the fitted-tree type ``Tree``
(not in ``__all__``, but what ``model.params`` holds).  A fitted model's
instance attributes are held on a few small fits.  Parameters the port
adds (``device``, ``spawn_ranks``, ...) are allowed.

What the port leaves out on purpose is listed in ``DEPARTURES`` with its
reason; every entry must still name something the port lacks, so a
departure that gets ported has to leave the list."""

import inspect

import numpy as np
import pytest

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.ops.tree import Tree as JaxTree
from spark_ensemble_tpu_torch.ops.tree import Tree as PortTree

_CTX_ORDER = ("the port takes the full rows X before the optional key(s), "
              "which learners that draw nothing leave out; by keyword both "
              "packages accept the same call")

#: ``Class.attr`` (or ``*.attr`` for every class) -> why the port lacks it;
#: ``Class.method(param)`` -> why the port's method lacks that parameter;
#: ``Class.method:order`` -> why the positional order differs
DEPARTURES = {
    "*.ctx_specs": "shard_map PartitionSpecs of the fit ctx (jax.sharding); the "
                   "port's mesh fit hands each rank its own rows of the ctx "
                   "(parallel/mesh.py) and has no partition specs",
    "*.fit_and_direction:order": _CTX_ORDER,
    "*.fit_many_and_directions:order": _CTX_ORDER,
    "*.fit_gathered_and_direction:order": _CTX_ORDER,
    "*.fit_gathered_many_and_directions:order": _CTX_ORDER,
    "*.fit_and_proba:order": _CTX_ORDER,
    "*.fit_from_ctx:order": (
        "the trees take return_leaf before axis_name (and the sweep's lanes); "
        "the ensembles pass both by keyword"),
    "*.fit_many_from_ctx:order": "as fit_from_ctx",
    "ProgramInventory.last_program_record": (
        "the round ledger joins a chunk's round_end row to the program call "
        "object itself (programz.xla_cost_fields(call=...)), not to a "
        "thread-local last record"),
    "ProgramInventory.record_call(tag, sig, fn, args, kwargs, call_s, build_s)": (
        "the sink takes one finished models/base.ProgramCall; the port "
        "compiles no program, so there is no fn, aval tree or build time "
        "to record"),
    "ProgramInventory.record_call:order": "as its parameters",
    "ProgramRecord.build_s": "the port builds no XLA program: nothing to time",
    "ProgramRecord.__init__(fn, args, kwargs, build_s)": (
        "a record holds shapes and summed launch work, never the program or "
        "its arguments (no XLA analysis to rerun), and no build time"),
    "ProgramRecord.__init__:order": "as its parameters",
    "DistributedSweep.sweep_forest(vals_p, mask, B, prec, min_gain)": (
        "the port's sweep mirrors ops/tree.stream_forest's keywords "
        "(vals_all, feature_mask, max_bins, min_info_gain, triangular, "
        "round_bf16), not the JAX package's streaming._sweep_forest"),
    "DistributedSweep.sweep_forest:order": "as its parameters",
    "slice_count(devices)": (
        "a list of JAX devices, whose slice_index it reads; the port counts "
        "the distinct hosts of the torch.distributed group"),
    "slice_count:order": "as its parameters",
}

_ALL = sorted(se.__all__)
_CLASSES = [n for n in _ALL if inspect.isclass(getattr(se, n))]
_FUNCTIONS = [n for n in _ALL
              if not inspect.isclass(getattr(se, n)) and inspect.isroutine(getattr(se, n))]
_USED = set()


def _departs(owner: str, what: str) -> bool:
    """Whether ``what`` of ``owner`` (a class name, or "" for a function)
    is a listed departure; the entry is marked as consulted."""
    for key in ((f"{owner}.{what}", f"*.{what}") if owner else (what,)):
        if key in DEPARTURES:
            _USED.add(key)
            return True
    return False


def _public(cls) -> set:
    return {a for a in dir(cls) if not a.startswith("_")}


def _signature(fn):
    try:
        return inspect.signature(fn)
    except (TypeError, ValueError):
        return None


def _named(sig) -> list:
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
            and p.name not in ("self", "cls")]


def _positional(sig) -> list:
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.name not in ("self", "cls")]


def _signature_gaps(owner: str, name: str, jfn, tfn) -> list:
    """What ``tfn`` lacks of ``jfn``'s signature, departures taken out."""
    jsig = _signature(jfn)
    if jsig is None:
        return []
    tsig = _signature(tfn)
    label = f"{owner}.{name}" if owner else name
    if tsig is None:
        return [f"{label}: no signature"]
    gaps = []
    missing = [p for p in _named(jsig) if p not in _named(tsig)]
    if missing and not _departs(owner, f"{name}({', '.join(missing)})"):
        gaps.append(f"{label} lacks {missing}")
    jpos, tpos = _positional(jsig), _positional(tsig)
    if tpos[:len(jpos)] != jpos and not _departs(owner, f"{name}:order"):
        gaps.append(f"{label} positional {tpos} against {jpos}")
    return gaps


def _callables(cls) -> list:
    out = ["__init__"]
    for a in sorted(_public(cls)):
        if callable(getattr(cls, a, None)):
            out.append(a)
    return out


def test_every_public_name_is_held():
    """Every name of ``__all__`` is a class or function held below, or the
    tunable space (its names held below)."""
    assert set(_CLASSES) | set(_FUNCTIONS) | {"TUNABLES"} == set(se.__all__)


@pytest.mark.parametrize("name", _CLASSES)
def test_class_attributes(name):
    jcls, tcls = getattr(se, name), getattr(st, name)
    assert inspect.isclass(tcls)
    missing = sorted(a for a in _public(jcls) - _public(tcls)
                     if not _departs(name, a))
    assert missing == [], f"{name} lacks {missing}"


@pytest.mark.parametrize("name", _CLASSES)
def test_class_method_parameters(name):
    jcls, tcls = getattr(se, name), getattr(st, name)
    gaps = []
    for a in _callables(jcls):
        if not hasattr(tcls, a):
            continue  # test_class_attributes reports it
        gaps += _signature_gaps(name, a, getattr(jcls, a), getattr(tcls, a))
    assert gaps == []


@pytest.mark.parametrize("name", _FUNCTIONS)
def test_function_parameters(name):
    assert _signature_gaps("", name, getattr(se, name), getattr(st, name)) == []


def test_every_jax_tunable_is_ported():
    assert set(se.TUNABLES.names()) <= set(st.TUNABLES.names())


def test_tree_surface():
    assert PortTree._fields == JaxTree._fields
    assert _public(JaxTree) - _public(PortTree) == set()
    for a in ("depth", "num_outputs"):
        assert isinstance(inspect.getattr_static(PortTree, a), property)


def _fitted(pkg, name):
    rng = np.random.RandomState(3)
    X = (rng.randint(-32, 32, size=(128, 4)) / 16.0).astype(np.float32)
    y_cls = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    y_reg = (2.0 * X[:, 0] - X[:, 2]).astype(np.float32)
    tree = lambda cls: getattr(pkg, cls)(max_depth=2, max_bins=16)  # noqa: E731
    est = {
        "GBMClassifier": lambda: pkg.GBMClassifier(
            num_base_learners=2, base_learner=tree("DecisionTreeRegressor")),
        "BaggingRegressor": lambda: pkg.BaggingRegressor(
            num_base_learners=2, base_learner=tree("DecisionTreeRegressor")),
        "BoostingClassifier": lambda: pkg.BoostingClassifier(
            num_base_learners=2, base_learner=tree("DecisionTreeClassifier")),
        "DecisionTreeRegressor": lambda: tree("DecisionTreeRegressor"),
    }[name]()
    y = y_cls if "Classifier" in name else y_reg
    return est.fit(X, y, device="cpu") if pkg is st else est.fit(X, y)


@pytest.mark.parametrize("name", ["GBMClassifier", "BaggingRegressor",
                                  "BoostingClassifier", "DecisionTreeRegressor"])
def test_fitted_model_attributes(name):
    jm, tm = _fitted(se, name), _fitted(st, name)
    assert type(tm).__name__ == type(jm).__name__
    missing = sorted(a for a in _public(jm) - _public(tm)
                     if not _departs(type(jm).__name__, a))
    assert missing == []
    if isinstance(jm.params, dict):
        assert set(jm.params) <= set(tm.params)


def test_departures_are_current():
    """Every departure still names something the port lacks (run last in
    this file: it reads which entries the cases above consulted)."""
    for name in _CLASSES:
        test_class_attributes(name)
        test_class_method_parameters(name)
    for name in _FUNCTIONS:
        test_function_parameters(name)
    assert set(DEPARTURES) - _USED == set()
    assert not any(k.startswith("GBMClassificationModel.member") for k in DEPARTURES)
