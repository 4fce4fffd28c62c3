"""Carry a fitted JAX-package GBM model into the port.

The system's "weights" are fitted models.  A fitted ``GBMClassifier`` or
``GBMRegressor`` of the JAX package is fully described by its params dict
(``model.get_params()``) and a few arrays:

- the stacked trees' ``split_feature``, ``split_bin``, ``split_threshold``,
  ``leaf_value`` and ``split_gain`` (classifier ``[rounds, dim, ...]``,
  regressor ``[rounds, ...]``);
- ``weights`` (classifier ``[rounds, dim]``, regressor ``[rounds]``);
- ``init_raw`` (classifier ``[dim]``) or ``init`` (regressor: the init
  model's constant prediction).

The caller extracts them as numpy arrays (this package never imports the
JAX package); the functions here rebuild the port's model on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_ensemble_tpu_torch.models.base import resolve_device
from spark_ensemble_tpu_torch.models.dummy import DummyRegressor
from spark_ensemble_tpu_torch.models.gbm import (
    GBMClassificationModel,
    GBMRegressionModel,
)
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor
from spark_ensemble_tpu_torch.ops.tree import Tree

TREE_FIELDS = Tree._fields


def _port_params(params: dict) -> dict:
    """The JAX model's ``get_params()`` with its base learner (a JAX-package
    estimator, or its params dict) rebuilt as the port's tree learner."""
    out = dict(params)
    base = out.get("base_learner")
    if base is not None and not isinstance(base, DecisionTreeRegressor):
        base_params = base if isinstance(base, dict) else base.get_params()
        out["base_learner"] = DecisionTreeRegressor(**base_params)
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
