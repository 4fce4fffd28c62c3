"""The kernels' build cache (PyTorch port of
``autotune/compilation_cache.py``).

The JAX package points XLA's persistent compilation cache at a directory,
so that a second process loads compiled programs instead of compiling
them.  The port compiles nothing but its CUDA kernels: ``nvcc`` builds
``csrc/hist.cu`` into ``libse_hist_<sha256 of the source>.so`` at first
use (``ops/hist_kernels.build_kernels``).  Its counterpart of the cache is
therefore the directory that library lands in: ``build/kernels`` under the
checkout, or the directory enabled here (``SE_TPU_COMPILE_CACHE=<dir>``, or
:func:`enable_compilation_cache`).  A process that finds the library of
the current source there loads it without ``nvcc`` (its fit's
``compile_count`` stays 0), and an edit to the source builds a new name.

Activation is transparent, as in the JAX package: ``build_kernels`` calls
:func:`ensure_compilation_cache`, a no-op unless the env var is set.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

logger = logging.getLogger("spark_ensemble_tpu_torch")

COMPILE_CACHE_ENV = "SE_TPU_COMPILE_CACHE"

_LOCK = threading.Lock()
_ENABLED_DIR: Optional[str] = None


def enable_compilation_cache(path: str) -> bool:
    """Build and load the kernels' libraries in ``path`` (created if
    missing) from now on.  Idempotent: the first enabled directory stays,
    as in the JAX package.  Returns True when active."""
    global _ENABLED_DIR
    with _LOCK:
        if _ENABLED_DIR is not None:
            return True
        try:
            os.makedirs(path, exist_ok=True)
        except OSError:
            logger.warning(
                "could not enable the kernel build cache at %s", path,
                exc_info=True,
            )
            return False
        _ENABLED_DIR = os.path.abspath(path)
        logger.info("kernel build cache enabled at %s", _ENABLED_DIR)
        return True


def ensure_compilation_cache() -> bool:
    """Enable the cache from ``SE_TPU_COMPILE_CACHE`` if set; a cheap no-op
    otherwise.  Called by every kernel build."""
    if _ENABLED_DIR is not None:
        return True
    path = os.environ.get(COMPILE_CACHE_ENV, "").strip()
    if not path:
        return False
    return enable_compilation_cache(path)


def compilation_cache_dir() -> Optional[str]:
    """The enabled build directory, or ``None`` (``build/kernels``)."""
    return _ENABLED_DIR
