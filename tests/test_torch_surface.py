"""The port's public surface against the JAX package's.

Every name in ``spark_ensemble_tpu.__all__`` is exported by
``spark_ensemble_tpu_torch`` or belongs to a module still waiting in
ROADMAP.md's queue 1 (``QUEUED`` below; each later slice shrinks it).
Every port model has ``.pack()`` and every port ``Params`` has
``.params_to_json_dict()``, as the JAX package's do, each equal to the
function it delegates to.
"""

import json

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.models.base import Model, tree_leaves
from spark_ensemble_tpu_torch.params import Params
from spark_ensemble_tpu_torch.serving.export import pack
from spark_ensemble_tpu_torch.utils.persist import params_to_json_dict

#: JAX modules of ROADMAP queue 1 still to port, with their item numbers
QUEUED = {
    "spark_ensemble_tpu.analysis.lint": 28,
    "spark_ensemble_tpu.analysis.contracts": 28,
}

#: this slice's names
SLICE = ("ElasticCoordinator", "HostLostError", "DistributedSweep", "survivor_mesh",
         "ModelRegistry", "FleetRouter", "FleetResponse", "FleetOverloadError",
         "Autopilot", "Watchdog", "ShadowScorer",
         "ProgramInventory", "ProgramRecord", "HbmSampler", "global_inventory",
         "OperatorPlane", "OperatorServer", "render_openmetrics",
         "start_operator_plane", "validate_openmetrics", "skew_report",
         "stitch_files",
         "TUNABLES", "TuningCache", "autotune_fit", "enable_compilation_cache",
         "run_search")


def _home(name):
    obj = getattr(se, name)
    return getattr(obj, "__module__", None)


@pytest.mark.parametrize("name", sorted(se.__all__))
def test_jax_name_is_exported_or_queued(name):
    if name in st.__all__:
        assert hasattr(st, name)
    else:
        assert _home(name) in QUEUED, f"{name} ({_home(name)}) is neither exported nor queued"


def test_every_exported_name_resolves():
    assert [n for n in st.__all__ if not hasattr(st, n)] == []
    assert set(SLICE) <= set(st.__all__)


def test_queued_modules_are_not_ported_yet():
    """A queued module that lands must leave ``QUEUED`` (and its names
    enter ``__all__``)."""
    queued_names = [n for n in se.__all__ if _home(n) in QUEUED]
    assert queued_names and not set(queued_names) & set(st.__all__)


def test_subpackages_export_the_chaos_faults_and_annotations():
    from spark_ensemble_tpu_torch import robustness, telemetry

    assert robustness.ChaosHostPreemption is st.robustness.chaos.ChaosHostPreemption
    assert robustness.ChaosReplicaCrash is st.robustness.chaos.ChaosReplicaCrash
    assert {"ChaosHostPreemption", "ChaosReplicaCrash"} <= set(robustness.__all__)
    assert telemetry.trace_annotations_enabled is st.telemetry.trace.trace_annotations_enabled
    assert "trace_annotations_enabled" in telemetry.__all__


def _data(n=96, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _estimators():
    tree = st.DecisionTreeRegressor(max_depth=2, max_bins=16)
    return {
        "gbm_reg": (st.GBMRegressor(base_learner=tree, num_base_learners=3), "reg"),
        "gbm_cls": (st.GBMClassifier(base_learner=tree, num_base_learners=2), "cls"),
        "bagging": (st.BaggingRegressor(base_learner=tree, num_base_learners=2), "reg"),
        "boosting": (st.BoostingRegressor(base_learner=tree, num_base_learners=2), "reg"),
        "tree": (st.DecisionTreeRegressor(max_depth=2, max_bins=16), "reg"),
        "linear": (st.LinearRegression(), "reg"),
        "logistic": (st.LogisticRegression(), "cls"),
        "nb": (st.GaussianNaiveBayes(), "cls"),
        "dummy": (st.DummyRegressor(), "reg"),
    }


@pytest.mark.parametrize("name", sorted(_estimators()))
def test_model_pack_equals_the_function(name):
    X, y = _data()
    est, kind = _estimators()[name]
    if kind == "cls":
        y = (y > np.median(y)).astype(np.float32)
    model = est.fit(X, y, device="cpu")
    assert isinstance(model, Model)
    a, b = model.pack(), pack(model)
    assert a.array_names == b.array_names and a.class_name == b.class_name
    for k in a.array_names:
        assert torch.equal(torch.as_tensor(a._arrays[k]), torch.as_tensor(b._arrays[k]))
    np.testing.assert_array_equal(a.predict(X).numpy(), model.predict(X).numpy())


def _params_instances():
    tree = st.DecisionTreeRegressor(max_depth=2)
    return [
        tree,
        st.GBMClassifier(base_learner=tree, num_base_learners=3, learning_rate=0.25),
        st.BaggingRegressor(num_base_learners=4),
        st.StackingClassifier(base_learners=[tree, st.GaussianNaiveBayes()]),
        st.CrossValidator(estimator=st.LinearRegression(), num_folds=3),
        st.StandardScaler(),
        st.MLPRegressor(),
    ]


@pytest.mark.parametrize("i", range(len(_params_instances())))
def test_params_to_json_dict_method_equals_the_function(i):
    obj = _params_instances()[i]
    assert isinstance(obj, Params)
    out = obj.params_to_json_dict()
    assert out == params_to_json_dict(obj)
    json.dumps(out)  # JSON-able


def test_params_to_json_dict_keys_equal_the_jax_package():
    """The same config in both packages gives the same JSON params."""
    j = se.GBMRegressor(num_base_learners=7, learning_rate=0.25, loss="huber")
    t = st.GBMRegressor(num_base_learners=7, learning_rate=0.25, loss="huber")
    assert t.params_to_json_dict() == j.params_to_json_dict()


def test_fitted_model_params_to_json_dict():
    X, y = _data()
    model = st.GBMRegressor(num_base_learners=2).fit(X, y, device="cpu")
    assert model.params_to_json_dict() == params_to_json_dict(model)
    assert tree_leaves(model.params)  # the learned params stay out of it
    assert "params" not in model.params_to_json_dict()
