"""Serving (PyTorch port of ``serving/``): packed export and the inference
engine.

:mod:`~spark_ensemble_tpu_torch.serving.export` -- ``pack(model)``
compacts any fitted ensemble into a :class:`PackedModel` (flat named
tensors + static JSON metadata) with a versioned sha256-manifested
artifact that either package loads, bit-identical predictions, and
``take(k)`` ensemble-prefix slices.
:mod:`~spark_ensemble_tpu_torch.serving.engine` --
:class:`InferenceEngine` serves a packed model through power-of-two row
buckets, one CUDA graph per (method, bucket, tier), with micro-batching
and on-device drift sketches.  The registry, fleet and autopilot come
next (ROADMAP, Slice E).
"""

from spark_ensemble_tpu_torch.serving.engine import InferenceEngine
from spark_ensemble_tpu_torch.serving.export import (
    PACKED_FORMAT_VERSION,
    PackedModel,
    fit_resume,
    load_packed,
    pack,
)

__all__ = [
    "PACKED_FORMAT_VERSION",
    "InferenceEngine",
    "PackedModel",
    "fit_resume",
    "load_packed",
    "pack",
]
