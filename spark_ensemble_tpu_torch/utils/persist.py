"""Model and estimator persistence: JSON metadata plus npz arrays
(PyTorch port of ``utils/persist.py``, in the same on-disk format).

A directory holds ``metadata.json`` (the class name, ``format_version``,
the JSON params with estimator-valued params left out, and for a model
its learned params as an encoded tree, its ``extra`` attributes and its
children) and ``arrays.npz`` (the learned arrays).  Estimator-valued
params go to nested directories (``learner/``, ``base_learners-$i/``),
child models to ``model-$attr/`` and ``model-$attr-$i/``.  Loading looks
the class up by name in the port's modules, as Spark's
``DefaultParamsReader`` resolves ``className``.

The format is the JAX package's, key for key: a directory saved by either
package loads in the other.  Arrays are written as numpy arrays of their
own dtypes (i32 split tables, f32 values, bool masks) and come back as
tensors on the ``device`` that :func:`load` is given.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

FORMAT_VERSION = 1


def _class_registry():
    from spark_ensemble_tpu_torch import evaluation, pipeline, tuning
    from spark_ensemble_tpu_torch.models import (
        bagging,
        boosting,
        dummy,
        gbm,
        linear,
        linear_tree,
        mlp,
        naive_bayes,
        stacking,
        tree,
    )
    from spark_ensemble_tpu_torch.ops.tree import Tree

    registry: Dict[str, type] = {}
    for mod in (bagging, boosting, dummy, gbm, linear, linear_tree, mlp,
                naive_bayes, stacking, tree, evaluation, pipeline, tuning):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type):
                registry[name] = obj
    registry["Tree"] = Tree
    return registry


# ---------------------------------------------------------------------------
# tree <-> (json structure, arrays) encoding
# ---------------------------------------------------------------------------

def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _encode(obj: Any, arrays: Dict[str, np.ndarray], prefix: str):
    if obj is None:
        return None
    if isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "_fields"):  # NamedTuple (ops.tree.Tree)
        return {
            "__namedtuple__": type(obj).__name__,
            "fields": {
                f: _encode(getattr(obj, f), arrays, f"{prefix}.{f}")
                for f in obj._fields
            },
        }
    if isinstance(obj, dict):
        return {
            "__dict__": {
                k: _encode(v, arrays, f"{prefix}.{k}") for k, v in obj.items()
            }
        }
    if isinstance(obj, (list, tuple)):
        return {
            "__list__": [
                _encode(v, arrays, f"{prefix}.{i}") for i, v in enumerate(obj)
            ],
            "__tuple__": isinstance(obj, tuple),
        }
    arrays[prefix] = _to_numpy(obj)
    return {"__array__": prefix}


def _decode(spec: Any, arrays, registry, device=None):
    if spec is None or isinstance(spec, (bool, int, float, str)):
        return spec
    if "__array__" in spec:
        return torch.as_tensor(arrays[spec["__array__"]], device=device)
    if "__namedtuple__" in spec:
        cls = registry[spec["__namedtuple__"]]
        fields = {k: _decode(v, arrays, registry, device)
                  for k, v in spec["fields"].items()}
        if any(f not in fields for f in cls._fields):
            # format evolution: classes declare defaults for fields added
            # after artifacts were saved (Tree._persist_defaults)
            defaults_hook = getattr(cls, "_persist_defaults", None)
            if defaults_hook is not None:
                fields = defaults_hook(fields)
            still = [f for f in cls._fields if f not in fields]
            if still:
                raise ValueError(
                    f"saved {spec['__namedtuple__']} is missing fields "
                    f"{still!r} and declares no defaults for them"
                )
        return cls(**fields)
    if "__dict__" in spec:
        return {k: _decode(v, arrays, registry, device)
                for k, v in spec["__dict__"].items()}
    if "__list__" in spec:
        items = [_decode(v, arrays, registry, device) for v in spec["__list__"]]
        return tuple(items) if spec.get("__tuple__") else items
    raise ValueError(f"cannot decode {spec!r}")


def params_to_json_dict(obj) -> Dict[str, Any]:
    """The JSON params of ``obj``: estimator-valued params left out, JSON
    containers kept, anything else (a grid over estimators) dropped."""

    def jsonable(v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return True
        if isinstance(v, (list, tuple)):
            return all(jsonable(x) for x in v)
        if isinstance(v, dict):
            return all(isinstance(k, str) and jsonable(x) for k, x in v.items())
        return False

    out = {}
    for name, p in obj._param_defs().items():
        if p.is_estimator:
            continue
        value = getattr(obj, name)
        if value is None or isinstance(value, (bool, int, float, str)):
            out[name] = value
        elif isinstance(value, (list, tuple)) and jsonable(value):
            out[name] = list(value)
    return out


# ---------------------------------------------------------------------------
# estimator configs (nested directories, like learner/ in the reference)
# ---------------------------------------------------------------------------

def _save_estimator_params(obj, path: str) -> Dict[str, Any]:
    """The JSON params; writes the nested estimator directories."""
    meta_params = params_to_json_dict(obj)
    for name, p in obj._param_defs().items():
        if not p.is_estimator:
            continue
        value = getattr(obj, name)
        if value is None:
            continue
        if isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                save(v, os.path.join(path, f"{name}-{i}"))
            meta_params[f"__{name}_count__"] = len(value)
        else:
            save(value, os.path.join(path, name))
    return meta_params


def _load_estimator_params(meta, path: str, cls, device) -> Dict[str, Any]:
    params = dict(meta["params"])
    for name, p in cls._param_defs().items():
        if not p.is_estimator:
            continue
        count_key = f"__{name}_count__"
        if count_key in params:
            count = params.pop(count_key)
            params[name] = [
                _load(os.path.join(path, f"{name}-{i}"), device)
                for i in range(count)
            ]
        elif os.path.isdir(os.path.join(path, name)):
            params[name] = _load(os.path.join(path, name), device)
    return params


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

_CHILD_ATTRS = ("init_model", "stack_model", "best_model")
_LIST_CHILD_ATTRS = ("base_models", "stage_models")
_EXTRA_ATTRS = (
    "num_features",
    "num_classes",
    "num_members",
    "dim",
    "avg_metrics",
    "fold_metrics",
    "validation_metrics",
    "best_index",
)


def save(obj, path: str) -> None:
    """Save an Estimator or a Model to the directory ``path``."""
    from spark_ensemble_tpu_torch.models.base import Model

    os.makedirs(path, exist_ok=True)
    meta: Dict[str, Any] = {
        "class": type(obj).__name__,
        "format_version": FORMAT_VERSION,
        "params": _save_estimator_params(obj, path),
    }
    if isinstance(obj, Model):
        arrays: Dict[str, np.ndarray] = {}
        meta["learned"] = _encode(obj._persisted_params(), arrays, "p")
        meta["extra"] = {
            attr: getattr(obj, attr) for attr in _EXTRA_ATTRS if hasattr(obj, attr)
        }
        for attr in _CHILD_ATTRS:
            child = getattr(obj, attr, None)
            if child is not None:
                save(child, os.path.join(path, f"model-{attr}"))
                meta.setdefault("children", []).append(attr)
        for attr in _LIST_CHILD_ATTRS:
            children = getattr(obj, attr, None)
            if children:
                for i, child in enumerate(children):
                    save(child, os.path.join(path, f"model-{attr}-{i}"))
                meta.setdefault("list_children", {})[attr] = len(children)
        if arrays:
            np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2, default=float)


def _load(path: str, device):
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    registry = _class_registry()
    cls = registry[meta["class"]]
    kwargs = _load_estimator_params(meta, path, cls, device)
    if "learned" in meta:
        arrays = {}
        npz = os.path.join(path, "arrays.npz")
        if os.path.exists(npz):
            with np.load(npz) as f:
                arrays = dict(f)
        kwargs["params"] = _decode(meta["learned"], arrays, registry, device)
        kwargs.update(meta.get("extra", {}))
        for attr in meta.get("children", []):
            kwargs[attr] = _load(os.path.join(path, f"model-{attr}"), device)
        for attr, count in meta.get("list_children", {}).items():
            kwargs[attr] = [
                _load(os.path.join(path, f"model-{attr}-{i}"), device)
                for i in range(count)
            ]
        kwargs["device"] = device
    return cls(**kwargs)


def load(path: str, device="cuda"):
    """Load an Estimator or a Model saved by :func:`save` (of either
    package); a model's arrays land on ``device``."""
    from spark_ensemble_tpu_torch.models.base import resolve_device

    return _load(path, resolve_device(device))
