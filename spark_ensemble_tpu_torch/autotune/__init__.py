"""Autotuning (PyTorch port of ``autotune/``): measured values for the hot
path's constants, and the kernels' build cache.

- :mod:`~spark_ensemble_tpu_torch.autotune.space`: the typed tunable space
  (``TUNABLES``, the JAX package's 18 names) whose defaults are the port's
  literals at each site;
- :mod:`~spark_ensemble_tpu_torch.autotune.search`: a deterministic search
  (``run_search`` / ``autotune_fit`` / ``tools/autotune_torch.py``) timing
  real fenced fits and the CUDA kernels under candidate plans;
- :mod:`~spark_ensemble_tpu_torch.autotune.cache`: a versioned on-disk
  winner cache keyed by ``(platform, device_kind, shape_class)``, sha256
  manifest and atomic publish (``SE_TPU_AUTOTUNE_CACHE``), in the JAX
  package's format;
- :mod:`~spark_ensemble_tpu_torch.autotune.resolve`: lookup at fit time,
  ``SE_TPU_AUTOTUNE=off|cache|search``, hand-set estimator params always
  winning, bit-identical behavior when off or unpopulated
  (``resolve.search`` runs the search on demand: the package's attribute
  ``search`` is the submodule, as ``resolve`` is the function);
- :mod:`~spark_ensemble_tpu_torch.autotune.compilation_cache`: the nvcc
  build directory (``SE_TPU_COMPILE_CACHE``), so that a second process
  loads the kernels without building them.
"""

from spark_ensemble_tpu_torch.autotune.cache import (
    CACHE_ENV,
    CACHE_VERSION,
    TuningCache,
    cache_dir,
)
from spark_ensemble_tpu_torch.autotune.compilation_cache import (
    COMPILE_CACHE_ENV,
    compilation_cache_dir,
    enable_compilation_cache,
    ensure_compilation_cache,
)
from spark_ensemble_tpu_torch.autotune.resolve import (
    MODE_ENV,
    autotune_mode,
    fingerprint,
    override,
    reset,
    resolve,
    resolved_snapshot,
)
from spark_ensemble_tpu_torch.autotune.search import (
    autotune_fit,
    clear_program_caches,
    run_search,
)
from spark_ensemble_tpu_torch.autotune.space import (
    TUNABLES,
    Tunable,
    TunableSpace,
    shape_class,
)

__all__ = [
    "CACHE_ENV",
    "CACHE_VERSION",
    "COMPILE_CACHE_ENV",
    "MODE_ENV",
    "TUNABLES",
    "Tunable",
    "TunableSpace",
    "TuningCache",
    "autotune_fit",
    "autotune_mode",
    "cache_dir",
    "clear_program_caches",
    "compilation_cache_dir",
    "enable_compilation_cache",
    "ensure_compilation_cache",
    "fingerprint",
    "override",
    "reset",
    "resolve",
    "resolved_snapshot",
    "run_search",
    "shape_class",
]
