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
  init model's constant prediction).

The functions here rebuild the port's model on ``device``.
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
from spark_ensemble_tpu_torch.models.gbm import (
    GBMClassificationModel,
    GBMRegressionModel,
)
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)
from spark_ensemble_tpu_torch.ops.tree import Tree

TREE_FIELDS = Tree._fields
_TREES = {c.__name__: c for c in (DecisionTreeClassifier, DecisionTreeRegressor)}


def _port_params(params: dict, default_tree=DecisionTreeRegressor) -> dict:
    """The JAX model's ``get_params()`` with its base learner (a JAX-package
    tree, or its params dict) rebuilt as the port's tree learner of the
    same name (``default_tree`` for a dict)."""
    out = dict(params)
    base = out.get("base_learner")
    if base is not None and not isinstance(base, tuple(_TREES.values())):
        if isinstance(base, dict):
            out["base_learner"] = default_tree(**base)
        else:
            out["base_learner"] = _TREES[type(base).__name__](**base.get_params())
    return out


def _trees(arrays: dict, device) -> Tree:
    return Tree(*(
        torch.as_tensor(np.array(arrays[f]), device=device) for f in TREE_FIELDS
    ))


def gbm_classifier_from_arrays(params: dict, arrays: dict, *, num_features: int,
                               num_classes: int, device="cuda"):
    """Port model of a fitted JAX ``GBMClassificationModel``."""
    dev = resolve_device(device)
    weights = torch.as_tensor(np.array(arrays["weights"], np.float32), device=dev)
    rounds, dim = weights.shape
    return GBMClassificationModel(
        params={
            "members": _trees(arrays, dev) if rounds > 0 else None,
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
            "members": _trees(arrays, dev) if rounds > 0 else None,
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
