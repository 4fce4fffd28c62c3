"""Serving (PyTorch port of ``serving/``): packed export, the inference
engine, the model registry, the replicated fleet and the autopilot.

:mod:`~spark_ensemble_tpu_torch.serving.export` -- ``pack(model)``
compacts any fitted ensemble into a :class:`PackedModel` (flat named
tensors + static JSON metadata) with a versioned sha256-manifested
artifact that either package loads, bit-identical predictions, and
``take(k)`` ensemble-prefix slices.
:mod:`~spark_ensemble_tpu_torch.serving.engine` --
:class:`InferenceEngine` serves a packed model through power-of-two row
buckets, one CUDA graph per (method, bucket, tier), with micro-batching
and on-device drift sketches.
:mod:`~spark_ensemble_tpu_torch.serving.registry` -- :class:`ModelRegistry`,
a thread-safe multi-model registry with LRU eviction of device memory and
pin-until-reply leases.
:mod:`~spark_ensemble_tpu_torch.serving.fleet` -- :class:`FleetRouter`, N
replicated engines behind health-checked routing, hedged retries,
circuit breakers, prefix degradation, torn-free hot swaps and elastic
width.
:mod:`~spark_ensemble_tpu_torch.serving.autopilot` -- :class:`Autopilot`
turns watchdog verdicts into fleet actions: scaling, warm-start refresh
fits (``fit_resume``) and rollback.
"""

from spark_ensemble_tpu_torch.serving.autopilot import Autopilot
from spark_ensemble_tpu_torch.serving.engine import InferenceEngine
from spark_ensemble_tpu_torch.serving.export import (
    PACKED_FORMAT_VERSION,
    PackedModel,
    fit_resume,
    load_packed,
    pack,
)
from spark_ensemble_tpu_torch.serving.fleet import (
    REPLICA_STATES,
    FleetDeadlineError,
    FleetOverloadError,
    FleetResponse,
    FleetRouter,
)
from spark_ensemble_tpu_torch.serving.registry import ModelRegistry

__all__ = [
    "PACKED_FORMAT_VERSION",
    "Autopilot",
    "FleetDeadlineError",
    "FleetOverloadError",
    "FleetResponse",
    "FleetRouter",
    "InferenceEngine",
    "ModelRegistry",
    "PackedModel",
    "REPLICA_STATES",
    "fit_resume",
    "load_packed",
    "pack",
]
