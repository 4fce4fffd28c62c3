"""Packed model export: flat named tensors + static metadata (PyTorch port
of ``serving/export.py``, in the same artifact format).

``pack(model)`` compacts a fitted ensemble -- Bagging, Boosting, GBM,
Stacking, with nested base-learner, init and stacker child models -- into
a :class:`PackedModel`: one flat ``{name: tensor}`` dict of the model's
learned arrays plus a JSON-able static spec (classes, config params,
params-tree structure).  The packed form is what serving ships: every
array is addressable by name (manifests, byte accounting, host offload),
nothing in it closes over live model objects, and the spec is versioned.

Bit-identity is the contract: ``PackedModel`` predicts by REBUILDING the
live model from the very same tensors (lazily, cached), so packed
inference runs the model's own code on the same operands.  Save and load
keep the guarantee because ``.npz`` round-trips float bits losslessly.
The on-disk artifact is the JAX package's (``packed.json`` with the same
``kind``, ``arrays.npz``, and a ``manifest.json`` with a sha256 and byte
size per file, written to a temp dir and renamed into place), so an
artifact written by either package loads in the other.

The ``quality`` sidecar (fit-time bin thresholds and occupancy, the drift
reference) rides along: ``pack`` writes it from the model's ``drift_ref_``
(which every GBM fit of either package captures), ``take`` keeps it, and
an artifact that carries one is read and written back.  ``pack`` emits a
``model_packed`` telemetry event.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from spark_ensemble_tpu_torch.utils.checkpoint import _file_sha256
from spark_ensemble_tpu_torch.utils.persist import (
    _CHILD_ATTRS,
    _EXTRA_ATTRS,
    _LIST_CHILD_ATTRS,
    _class_registry,
    _decode,
    _to_numpy,
    params_to_json_dict,
)

__all__ = [
    "PACKED_FORMAT_VERSION",
    "PackedModel",
    "fit_resume",
    "pack",
    "load_packed",
]

PACKED_FORMAT_VERSION = 1
_ARTIFACT_KIND = "spark_ensemble_tpu.packed"


# ---------------------------------------------------------------------------
# model <-> (static node spec, flat arrays) encoding
# ---------------------------------------------------------------------------
#
# The structural markers of utils/persist (__namedtuple__/__dict__/
# __list__/__array__), so persist._decode reassembles the learned params
# tree; leaves stay tensors (nothing round-trips through host memory just
# to pack).


def _flatten(obj: Any, arrays: Dict[str, Any], prefix: str):
    if obj is None:
        return None
    if isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "_fields"):  # NamedTuple (ops.tree.Tree)
        return {
            "__namedtuple__": type(obj).__name__,
            "fields": {
                f: _flatten(getattr(obj, f), arrays, f"{prefix}.{f}")
                for f in obj._fields
            },
        }
    if isinstance(obj, dict):
        return {
            "__dict__": {
                k: _flatten(v, arrays, f"{prefix}.{k}") for k, v in obj.items()
            }
        }
    if isinstance(obj, (list, tuple)):
        return {
            "__list__": [
                _flatten(v, arrays, f"{prefix}.{i}") for i, v in enumerate(obj)
            ],
            "__tuple__": isinstance(obj, tuple),
        }
    arrays[prefix] = obj if isinstance(obj, torch.Tensor) else np.asarray(obj)
    return {"__array__": prefix}


def _encode_estimator(est) -> Optional[Dict[str, Any]]:
    """Estimator config as a pure-JSON node: class name, scalar params, and
    nested estimator-valued params (base_learner, stacker, ...)."""
    if est is None:
        return None
    node: Dict[str, Any] = {
        "class": type(est).__name__,
        "params": params_to_json_dict(est),
    }
    estimators: Dict[str, Any] = {}
    for name, p in est._param_defs().items():
        if not p.is_estimator:
            continue
        value = getattr(est, name)
        if value is None:
            continue
        if isinstance(value, (list, tuple)):
            estimators[name] = {"list": [_encode_estimator(v) for v in value]}
        else:
            estimators[name] = {"one": _encode_estimator(value)}
    if estimators:
        node["estimators"] = estimators
    return node


def _estimator_kwargs(node, registry) -> Dict[str, Any]:
    """A node's JSON params with its nested estimators rebuilt."""
    kwargs = dict(node["params"])
    for name, spec in node.get("estimators", {}).items():
        if "list" in spec:
            kwargs[name] = [_decode_estimator(v, registry) for v in spec["list"]]
        else:
            kwargs[name] = _decode_estimator(spec["one"], registry)
    return kwargs


def _decode_estimator(node, registry):
    if node is None:
        return None
    return registry[node["class"]](**_estimator_kwargs(node, registry))


def _extra_attrs(model) -> Dict[str, Any]:
    extra: Dict[str, Any] = {}
    for attr in _EXTRA_ATTRS:
        if hasattr(model, attr):
            v = getattr(model, attr)
            if isinstance(v, np.ndarray):
                v = v.tolist()
            extra[attr] = v
    return extra


def _encode_model(model, arrays: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    node = _encode_estimator(model)
    # the params a save writes (a model's port-only diagnostics left out),
    # so the artifact is the JAX package's
    node["learned"] = _flatten(model._persisted_params(), arrays, f"{prefix}.p")
    node["extra"] = _extra_attrs(model)
    children = {}
    for attr in _CHILD_ATTRS:
        child = getattr(model, attr, None)
        if child is not None:
            children[attr] = _encode_model(child, arrays, f"{prefix}.{attr}")
    if children:
        node["children"] = children
    list_children = {}
    for attr in _LIST_CHILD_ATTRS:
        kids = getattr(model, attr, None)
        if kids:
            list_children[attr] = [
                _encode_model(c, arrays, f"{prefix}.{attr}{i}")
                for i, c in enumerate(kids)
            ]
    if list_children:
        node["list_children"] = list_children
    return node


def rebuild_model(node: Dict[str, Any], arrays: Dict[str, Any], registry=None,
                  device=None):
    """Live fitted model on ``device`` from a packed (node, arrays) pair;
    tensors already there are used as they are (no copy)."""
    if registry is None:
        registry = _class_registry()
    kwargs = _estimator_kwargs(node, registry)
    kwargs["params"] = _decode(node["learned"], arrays, registry, device)
    kwargs.update(node.get("extra", {}))
    for attr, child in node.get("children", {}).items():
        kwargs[attr] = rebuild_model(child, arrays, registry, device)
    for attr, kids in node.get("list_children", {}).items():
        kwargs[attr] = [rebuild_model(c, arrays, registry, device) for c in kids]
    kwargs["device"] = device
    return registry[node["class"]](**kwargs)


# ---------------------------------------------------------------------------
# PackedModel
# ---------------------------------------------------------------------------


class PackedModel:
    """A fitted ensemble compacted for serving: flat named tensors + static
    metadata, with predictions bit-identical to the live model's.

    ``predict``/``predict_proba``/``predict_raw`` delegate to a lazily
    rebuilt live model over the SAME tensors on ``device``.
    ``save``/``load_packed`` write and read the versioned artifact
    directory.  ``offload()`` moves every array to host memory and drops
    the live view; the next prediction uploads them again."""

    def __init__(self, node: Dict[str, Any], arrays: Dict[str, Any], device="cuda"):
        self._node = node
        self._arrays = dict(arrays)
        self.device = torch.device(device)
        self._model = None
        self._lock = threading.Lock()

    # -- identity ----------------------------------------------------------

    @property
    def node(self) -> Dict[str, Any]:
        """Static metadata (JSON-able): classes, config, params-tree spec."""
        return self._node

    @property
    def class_name(self) -> str:
        return self._node["class"]

    @property
    def num_features(self) -> int:
        return int(self._node.get("extra", {}).get("num_features", 0))

    @property
    def num_classes(self) -> Optional[int]:
        k = self._node.get("extra", {}).get("num_classes")
        return None if k is None else int(k)

    @property
    def is_classifier(self) -> bool:
        return self.num_classes is not None

    @property
    def num_members(self) -> Optional[int]:
        """Ensemble size (GBM rounds / boosting members) when the packed
        family records one; ``None`` for non-ensemble models."""
        m = self._node.get("extra", {}).get("num_members")
        return None if m is None else int(m)

    @property
    def quality(self) -> Optional[Dict[str, Any]]:
        """The drift-reference sidecar (host numpy): ``{"thresholds":
        f32[d, B-1], "occupancy": i32[d, B], "rows": n}``, or ``None`` when
        the artifact carries none.  ``rebuild_model`` never reads it, so it
        cannot perturb predictions."""
        q = self._node.get("quality")
        if not q:
            return None
        return {
            "thresholds": _to_numpy(self._arrays[q["thresholds"]]).astype(np.float32),
            "occupancy": _to_numpy(self._arrays[q["occupancy"]]).astype(np.int32),
            "rows": int(q.get("rows", 0)),
        }

    # -- arrays ------------------------------------------------------------

    @property
    def array_names(self):
        return sorted(self._arrays)

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self._arrays.values()))

    def _on_device(self) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self._arrays.items()}

    def device_arrays(self) -> Dict[str, torch.Tensor]:
        """The packed arrays as tensors on ``device`` (no copy when already
        there)."""
        return self._on_device()

    def on_device(self) -> bool:
        return any(isinstance(a, torch.Tensor) and a.device == self.device
                   and a.device.type != "cpu" for a in self._arrays.values())

    def ensure_device(self) -> "PackedModel":
        with self._lock:
            self._arrays = self._on_device()
        return self

    def offload(self) -> "PackedModel":
        """Move every packed array to host memory and drop the cached live
        model (it holds device tensors); predictions still work afterwards,
        the arrays uploading again on next use."""
        with self._lock:
            self._arrays = {k: torch.as_tensor(v).cpu() for k, v in self._arrays.items()}
            self._model = None
        return self

    # -- serving -----------------------------------------------------------

    def model(self):
        """The live fitted model rebuilt over the packed arrays (cached):
        same tensors + same model code = bit-identical predictions."""
        with self._lock:
            if self._model is None:
                # upload in place: after offload() the arrays land back on
                # the device here, and the rebuilt model shares them
                self._arrays = self._on_device()
                self._model = rebuild_model(self._node, dict(self._arrays),
                                            device=self.device)
            return self._model

    def predict(self, X) -> torch.Tensor:
        return self.model().predict(X)

    def predict_proba(self, X) -> torch.Tensor:
        return self.model().predict_proba(X)

    def predict_raw(self, X) -> torch.Tensor:
        return self.model().predict_raw(X)

    # -- ensemble-prefix slicing -------------------------------------------

    def take(self, k: int) -> "PackedModel":
        """Pack the first-``k``-member prefix of this ensemble: for GBM and
        Boosting, ``model.take(k)``, whose predictions equal a k-round fit's.
        Raises ``TypeError`` for families with no stagewise prefix
        (Bagging, Stacking, single models)."""
        model = self.model()
        if not hasattr(model, "take"):
            raise TypeError(
                f"{self.class_name} has no ensemble-prefix structure; "
                "take(k) applies to GBM and boosting families only"
            )
        n = self.num_members
        if n is not None and not (1 <= int(k) <= n):
            raise ValueError(
                f"take(k={k}) out of range for an ensemble of {n} members"
            )
        prefix = pack(model.take(int(k)))
        # the live model's take() drops fit-time sidecars: re-attach the
        # drift reference
        q = self._node.get("quality")
        if q:
            prefix._node["quality"] = dict(q)
            prefix._arrays[q["thresholds"]] = self._arrays[q["thresholds"]]
            prefix._arrays[q["occupancy"]] = self._arrays[q["occupancy"]]
        return prefix

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the versioned artifact directory: ``packed.json`` (static
        spec), ``arrays.npz`` (lossless), and ``manifest.json`` with a
        sha256 and byte size per file, in a temp dir renamed into place (a
        torn write never looks like an artifact)."""
        from spark_ensemble_tpu_torch import __version__

        parent = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=parent, prefix=".packed-tmp-")
        try:
            meta = {
                "kind": _ARTIFACT_KIND,
                "format_version": PACKED_FORMAT_VERSION,
                "package_version": __version__,
                "model": self._node,
            }
            with open(os.path.join(tmp, "packed.json"), "w") as f:
                json.dump(meta, f, indent=2, default=float)
            np.savez(
                os.path.join(tmp, "arrays.npz"),
                **{k: _to_numpy(v) for k, v in self._arrays.items()},
            )
            manifest: Dict[str, Any] = {
                "format_version": PACKED_FORMAT_VERSION,
                "files": {},
            }
            for name in ("packed.json", "arrays.npz"):
                p = os.path.join(tmp, name)
                manifest["files"][name] = {
                    "sha256": _file_sha256(p),
                    "bytes": os.path.getsize(p),
                }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2)
            final = os.path.abspath(path)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def __repr__(self):
        return (
            f"PackedModel({self.class_name}, arrays={len(self._arrays)}, "
            f"bytes={self.nbytes}, device={self.device})"
        )


def fit_resume(packed, X, y, n_new_rounds, sample_weight=None) -> PackedModel:
    """Warm-start refresh fit: continue a packed stagewise ensemble for
    ``n_new_rounds`` more rounds on its ORIGINAL training data and repack.
    The result is bit-identical to one ``num_members + n_new_rounds``-round
    fit (the models' ``fit_resume``).  Accepts a :class:`PackedModel` or a
    fitted model; raises ``TypeError`` for families with no stagewise round
    structure (Bagging, Stacking, single models)."""
    model = packed.model() if isinstance(packed, PackedModel) else packed
    if not hasattr(model, "fit_resume"):
        raise TypeError(
            f"{type(model).__name__} has no stagewise round structure; "
            "fit_resume applies to GBM and boosting families only"
        )
    resumed = model.fit_resume(X, y, int(n_new_rounds), sample_weight=sample_weight)
    return pack(resumed)


def pack(model) -> PackedModel:
    """Compact a fitted model into a :class:`PackedModel` on the model's
    device (see the module docstring); emits a ``model_packed`` telemetry
    event."""
    from spark_ensemble_tpu_torch.models.base import Model
    from spark_ensemble_tpu_torch.telemetry.events import (
        emit_event,
        serving_stream_id,
    )

    if not isinstance(model, Model):
        raise TypeError(
            f"pack() expects a fitted Model; got {type(model).__name__} "
            "(fit the estimator first)"
        )
    arrays: Dict[str, Any] = {}
    node = _encode_model(model, arrays, "m")
    # the drift reference rides along as ordinary packed arrays under a
    # node key rebuild_model never reads
    ref = getattr(model, "drift_ref_", None)
    if isinstance(ref, dict) and "thresholds" in ref and "occupancy" in ref:
        arrays["q.thresholds"] = _to_numpy(ref["thresholds"]).astype(np.float32)
        arrays["q.occupancy"] = _to_numpy(ref["occupancy"]).astype(np.int32)
        node["quality"] = {
            "thresholds": "q.thresholds",
            "occupancy": "q.occupancy",
            "rows": int(ref.get("rows", 0)),
        }
    device = model.device if model.device is not None else torch.device("cpu")
    packed = PackedModel(node, arrays, device=device)
    emit_event(
        "model_packed",
        fit_id=serving_stream_id("pack"),
        family=packed.class_name,
        arrays=len(arrays),
        bytes=packed.nbytes,
        num_features=packed.num_features,
    )
    return packed


def load_packed(path: str, device="cuda") -> PackedModel:
    """Load a :meth:`PackedModel.save` artifact (of either package) to
    serve on ``device``, verifying the manifest (sha256 + size per file)
    and the format version before touching any payload: corruption and
    version skew fail here, not as NaNs in predictions."""
    from spark_ensemble_tpu_torch.models.base import resolve_device

    dev = resolve_device(device)
    mf_path = os.path.join(path, "manifest.json")
    if not os.path.exists(mf_path):
        raise FileNotFoundError(
            f"{path!r} is not a packed-model artifact (no manifest.json)"
        )
    with open(mf_path) as f:
        manifest = json.load(f)
    for name, entry in manifest.get("files", {}).items():
        p = os.path.join(path, name)
        if not os.path.exists(p):
            raise ValueError(f"packed artifact {path!r} is missing {name}")
        if os.path.getsize(p) != entry["bytes"] or _file_sha256(p) != entry["sha256"]:
            raise ValueError(
                f"packed artifact {path!r}: {name} fails its manifest "
                "checksum (truncated or corrupt write)"
            )
    with open(os.path.join(path, "packed.json")) as f:
        meta = json.load(f)
    if meta.get("kind") != _ARTIFACT_KIND:
        raise ValueError(
            f"{path!r} is not a packed-model artifact (kind={meta.get('kind')!r})"
        )
    version = int(meta.get("format_version", -1))
    if version != PACKED_FORMAT_VERSION:
        raise ValueError(
            f"packed artifact {path!r} has format_version={version}; this "
            f"build reads version {PACKED_FORMAT_VERSION}"
        )
    npz = os.path.join(path, "arrays.npz")
    arrays = {}
    if os.path.exists(npz):
        with np.load(npz) as z:
            arrays = dict(z)
    return PackedModel(meta["model"], arrays, device=dev)
