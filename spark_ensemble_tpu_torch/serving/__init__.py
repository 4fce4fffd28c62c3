"""Serving (PyTorch port of ``serving/``): packed export so far.

:mod:`~spark_ensemble_tpu_torch.serving.export` -- ``pack(model)``
compacts any fitted ensemble into a :class:`PackedModel` (flat named
tensors + static JSON metadata) with a versioned sha256-manifested
artifact that either package loads, bit-identical predictions, and
``take(k)`` ensemble-prefix slices.  The inference engine, registry,
fleet and autopilot come after the port's telemetry (ROADMAP, Slice E).
"""

from spark_ensemble_tpu_torch.serving.export import (
    PACKED_FORMAT_VERSION,
    PackedModel,
    fit_resume,
    load_packed,
    pack,
)

__all__ = [
    "PACKED_FORMAT_VERSION",
    "PackedModel",
    "fit_resume",
    "load_packed",
    "pack",
]
