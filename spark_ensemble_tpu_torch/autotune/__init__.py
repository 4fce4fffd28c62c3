"""Tunables (PyTorch port of ``autotune/``): the resolution layer only,
:mod:`~spark_ensemble_tpu_torch.autotune.resolve`.  The tunable space,
the measured search and the on-disk cache wait for ROADMAP's Slice F."""

from spark_ensemble_tpu_torch.autotune.resolve import (
    MODE_ENV,
    TUNABLES,
    autotune_mode,
    override,
    reset,
    resolve,
    search,
)

__all__ = [
    "MODE_ENV",
    "TUNABLES",
    "autotune_mode",
    "override",
    "reset",
    "resolve",
    "search",
]
