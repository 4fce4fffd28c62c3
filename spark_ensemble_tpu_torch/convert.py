"""Carry fitted JAX-package models into the port.

The system's "weights" are fitted models.  A fitted model of the JAX
package is fully described by its params dict (``model.get_params()``)
and a few arrays, which the caller extracts as numpy arrays (this package
never imports the JAX package):

- the trees' ``split_feature``, ``split_bin``, ``split_threshold``,
  ``leaf_value`` and ``split_gain``, stacked with leading member axes
  (GBM classifier ``[rounds, dim, ...]``; GBM regressor, Bagging and
  Boosting ``[members, ...]``; a single tree none);
- ``weights``: GBM step sizes (classifier ``[rounds, dim]``, regressor
  ``[rounds]``) or Boosting estimator weights ``[members]``;
- ``masks``: Bagging's per-member feature subspaces ``bool[members, d]``;
- ``init_raw`` (GBM classifier ``[dim]``) or ``init`` (GBM regressor: the
  init model's constant prediction, whatever its strategy: mean, median or
  quantile); a GBM's loss and its ``alpha`` travel in the params dict;
- the linear models' ``coef``, ``intercept`` and ``mask``; GaussianNB's
  ``mean``, ``var``, ``log_prior`` and ``mask``;
- linear-leaf trees (``LinearTreeRegressor``, and GBM at
  ``leaf_model="linear"``): the tree fields of ``params["tree"]`` plus
  ``beta``, ``x_mu``, ``x_sd`` and ``mask``, with the same leading axes.

A Stacking model's members and stacker are converted one by one with the
functions here; ``stacking_*_from_models`` assembles them.  The functions
rebuild the port's model on ``device``; estimator-valued params (base
learners, stackers) become the port's estimators of the same name.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_ensemble_tpu_torch.models.bagging import (
    BaggingClassificationModel,
    BaggingRegressionModel,
)
from spark_ensemble_tpu_torch.models.base import resolve_device
from spark_ensemble_tpu_torch.models.boosting import (
    BoostingClassificationModel,
    BoostingRegressionModel,
)
from spark_ensemble_tpu_torch.models.dummy import DummyRegressor
from spark_ensemble_tpu_torch.models.bagging import BaggingClassifier, BaggingRegressor
from spark_ensemble_tpu_torch.models.base import Estimator
from spark_ensemble_tpu_torch.models.boosting import BoostingClassifier, BoostingRegressor
from spark_ensemble_tpu_torch.models.dummy import DummyClassifier
from spark_ensemble_tpu_torch.models.gbm import (
    GBMClassificationModel,
    GBMClassifier,
    GBMRegressionModel,
    GBMRegressor,
)
from spark_ensemble_tpu_torch.models.linear_tree import (
    LinearTreeRegressionModel,
    LinearTreeRegressor,
)
from spark_ensemble_tpu_torch.models.linear import (
    LinearRegression,
    LinearRegressionModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_ensemble_tpu_torch.models.naive_bayes import (
    GaussianNaiveBayes,
    GaussianNaiveBayesModel,
)
from spark_ensemble_tpu_torch.models.stacking import (
    StackingClassificationModel,
    StackingClassifier,
    StackingRegressionModel,
    StackingRegressor,
)
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)
from spark_ensemble_tpu_torch.ops.tree import Tree

TREE_FIELDS = Tree._fields
# the port's estimators by the JAX package's class names
_ESTIMATORS = {c.__name__: c for c in (
    DecisionTreeClassifier, DecisionTreeRegressor, DummyRegressor,
    DummyClassifier, LinearRegression, LogisticRegression, GaussianNaiveBayes,
    LinearTreeRegressor,
    GBMClassifier, GBMRegressor, BaggingClassifier, BaggingRegressor,
    BoostingClassifier, BoostingRegressor, StackingClassifier,
    StackingRegressor,
)}
_ESTIMATOR_PARAMS = ("base_learner", "base_learners", "stacker")


def _port_estimator(est):
    """A JAX-package estimator as the port's estimator of the same name,
    its estimator-valued params converted too."""
    if est is None or isinstance(est, Estimator):
        return est
    cls = _ESTIMATORS.get(type(est).__name__)
    if cls is None:
        raise NotImplementedError(
            f"{type(est).__name__} is not ported yet (ROADMAP queue 1, "
            "items 13-14)"
        )
    return cls(**_port_params(est.get_params()))


def _port_params(params: dict, default_tree=DecisionTreeRegressor) -> dict:
    """A JAX model's ``get_params()`` with its estimator-valued params
    rebuilt as the port's estimators of the same names (a params dict as a
    base learner becomes ``default_tree``)."""
    out = dict(params)
    for key in _ESTIMATOR_PARAMS:
        if key not in out:
            continue
        value = out[key]
        if isinstance(value, dict):
            out[key] = default_tree(**value)
        elif isinstance(value, (list, tuple)):
            out[key] = [_port_estimator(v) for v in value]
        else:
            out[key] = _port_estimator(value)
    return out


def _tensors(arrays: dict, keys, device) -> dict:
    return {k: torch.as_tensor(np.array(arrays[k], np.float32), device=device)
            for k in keys}


def _trees(arrays: dict, device) -> Tree:
    return Tree(*(
        torch.as_tensor(np.array(arrays[f]), device=device) for f in TREE_FIELDS
    ))


_LINEAR_LEAF_KEYS = ("beta", "x_mu", "x_sd", "mask")


def _members(arrays: dict, device):
    """Member trees, or linear-leaf members (the trees plus their leaf
    models) when the arrays carry ``beta``."""
    trees = _trees(arrays, device)
    if "beta" not in arrays:
        return trees
    return {"tree": trees, **_tensors(arrays, _LINEAR_LEAF_KEYS, device)}


def gbm_classifier_from_arrays(params: dict, arrays: dict, *, num_features: int,
                               num_classes: int, device="cuda"):
    """Port model of a fitted JAX ``GBMClassificationModel``."""
    dev = resolve_device(device)
    weights = torch.as_tensor(np.array(arrays["weights"], np.float32), device=dev)
    rounds, dim = weights.shape
    return GBMClassificationModel(
        params={
            "members": _members(arrays, dev) if rounds > 0 else None,
            "weights": weights,
            "init_raw": torch.as_tensor(
                np.array(arrays["init_raw"], np.float32), device=dev
            ),
            "val_hist": None,
        },
        num_features=num_features,
        num_classes=num_classes,
        num_members=rounds,
        dim=dim,
        device=dev,
        **_port_params(params),
    )


def gbm_regressor_from_arrays(params: dict, arrays: dict, *, num_features: int,
                              device="cuda"):
    """Port model of a fitted JAX ``GBMRegressionModel`` whose init model is
    a constant (``init_strategy`` 'constant' or 'zero')."""
    dev = resolve_device(device)
    weights = torch.as_tensor(np.array(arrays["weights"], np.float32), device=dev)
    init_params = {
        "value": torch.as_tensor(np.float32(arrays["init"]), device=dev)
    }
    init_model = DummyRegressor(strategy="constant").model_from_params(
        init_params, num_features, device=dev
    )
    rounds = weights.shape[0]
    return GBMRegressionModel(
        params={
            "members": _members(arrays, dev) if rounds > 0 else None,
            "weights": weights,
            "init": init_params,
            "val_hist": None,
        },
        num_features=num_features,
        init_model=init_model,
        num_members=rounds,
        device=dev,
        **_port_params(params),
    )


def linear_tree_regressor_from_arrays(params: dict, arrays: dict, *,
                                      num_features: int, device="cuda"):
    """Port model of a fitted JAX ``LinearTreeRegressionModel``."""
    dev = resolve_device(device)
    return LinearTreeRegressionModel(
        params=_members(arrays, dev), num_features=num_features, device=dev,
        **params,
    )


def decision_tree_classifier_from_arrays(params: dict, arrays: dict, *,
                                         num_features: int, num_classes: int,
                                         device="cuda"):
    """Port model of a fitted JAX ``DecisionTreeClassificationModel``."""
    dev = resolve_device(device)
    return DecisionTreeClassificationModel(
        params=_trees(arrays, dev), num_features=num_features,
        num_classes=num_classes, device=dev, **params,
    )


def bagging_classifier_from_arrays(params: dict, arrays: dict, *,
                                   num_features: int, num_classes: int,
                                   device="cuda"):
    """Port model of a fitted JAX ``BaggingClassificationModel`` (member
    trees plus ``masks``)."""
    dev = resolve_device(device)
    masks = torch.as_tensor(np.array(arrays["masks"], bool), device=dev)
    return BaggingClassificationModel(
        params={"members": _trees(arrays, dev), "masks": masks},
        num_features=num_features, num_classes=num_classes,
        num_members=masks.shape[0], device=dev,
        **_port_params(params, DecisionTreeClassifier),
    )


def bagging_regressor_from_arrays(params: dict, arrays: dict, *,
                                  num_features: int, device="cuda"):
    """Port model of a fitted JAX ``BaggingRegressionModel``."""
    dev = resolve_device(device)
    masks = torch.as_tensor(np.array(arrays["masks"], bool), device=dev)
    return BaggingRegressionModel(
        params={"members": _trees(arrays, dev), "masks": masks},
        num_features=num_features, num_members=masks.shape[0], device=dev,
        **_port_params(params),
    )


def _boosting_params(arrays, dev):
    weights = torch.as_tensor(np.array(arrays["weights"], np.float32), device=dev)
    members = _trees(arrays, dev) if weights.shape[0] > 0 else None
    return {"members": members, "weights": weights}, weights.shape[0]


def boosting_classifier_from_arrays(params: dict, arrays: dict, *,
                                    num_features: int, num_classes: int,
                                    device="cuda"):
    """Port model of a fitted JAX ``BoostingClassificationModel`` (member
    trees plus estimator ``weights``)."""
    dev = resolve_device(device)
    model_params, m = _boosting_params(arrays, dev)
    return BoostingClassificationModel(
        params=model_params, num_features=num_features,
        num_classes=num_classes, num_members=m, device=dev,
        **_port_params(params, DecisionTreeClassifier),
    )


def boosting_regressor_from_arrays(params: dict, arrays: dict, *,
                                   num_features: int, device="cuda"):
    """Port model of a fitted JAX ``BoostingRegressionModel``."""
    dev = resolve_device(device)
    model_params, m = _boosting_params(arrays, dev)
    return BoostingRegressionModel(
        params=model_params, num_features=num_features, num_members=m,
        device=dev, **_port_params(params),
    )


def linear_regression_from_arrays(params: dict, arrays: dict, *,
                                  num_features: int, device="cuda"):
    """Port model of a fitted JAX ``LinearRegressionModel``."""
    dev = resolve_device(device)
    return LinearRegressionModel(
        params=_tensors(arrays, ("coef", "intercept", "mask"), dev),
        num_features=num_features, device=dev, **params,
    )


def logistic_regression_from_arrays(params: dict, arrays: dict, *,
                                    num_features: int, num_classes: int,
                                    device="cuda"):
    """Port model of a fitted JAX ``LogisticRegressionModel``."""
    dev = resolve_device(device)
    return LogisticRegressionModel(
        params=_tensors(arrays, ("coef", "intercept", "mask"), dev),
        num_features=num_features, num_classes=num_classes, device=dev,
        **params,
    )


def gaussian_nb_from_arrays(params: dict, arrays: dict, *, num_features: int,
                            num_classes: int, device="cuda"):
    """Port model of a fitted JAX ``GaussianNaiveBayesModel``."""
    dev = resolve_device(device)
    return GaussianNaiveBayesModel(
        params=_tensors(arrays, ("mean", "var", "log_prior", "mask"), dev),
        num_features=num_features, num_classes=num_classes, device=dev,
        **params,
    )


def stacking_regressor_from_models(params: dict, base_models, stack_model, *,
                                   num_features: int, device="cuda"):
    """Port model of a fitted JAX ``StackingRegressionModel`` from its
    members and stacker, each already converted to the port."""
    dev = resolve_device(device)
    return StackingRegressionModel(
        base_models=list(base_models), stack_model=stack_model,
        num_features=num_features, device=dev, **_port_params(params),
    )


def stacking_classifier_from_models(params: dict, base_models, stack_model, *,
                                    num_features: int, num_classes: int,
                                    device="cuda"):
    """Port model of a fitted JAX ``StackingClassificationModel`` from its
    members and stacker, each already converted to the port."""
    dev = resolve_device(device)
    return StackingClassificationModel(
        base_models=list(base_models), stack_model=stack_model,
        num_features=num_features, num_classes=num_classes, device=dev,
        **_port_params(params),
    )
