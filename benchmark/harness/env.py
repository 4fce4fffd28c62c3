"""The run's environment, set before torch or the port is imported.

Every build and kernel cache sits at a fixed path inside the checkout
(``build/benchmark/...``, which ``.gitignore`` lists), so only the first
run of a cell in a checkout builds.  The autotuner is off: the port runs
its shipped plans and reads no tuning cache from ``HOME``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from benchmark.harness.spec import ROOT

#: top-level module names that may not be loaded in a run: JAX, its
#: libraries, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "spark_ensemble_tpu")


def prepare(root: Path = ROOT) -> None:
    cache = root / "build" / "benchmark"
    dirs = {
        "SE_TPU_COMPILE_CACHE": cache / "kernels",
        "TORCH_EXTENSIONS_DIR": cache / "torch_extensions",
        "TRITON_CACHE_DIR": cache / "triton",
    }
    for var, path in dirs.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["SE_TPU_AUTOTUNE"] = "off"
    os.environ["USE_FLAX"] = "0"
    # the program's own telemetry and fault injection stay off
    for var in ("SE_TPU_TELEMETRY", "SE_TPU_TELEMETRY_PHASES", "SE_TPU_FLIGHT_DIR",
                "SE_TPU_CHAOS", "SE_TPU_PIPELINE"):
        os.environ.pop(var, None)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN_MODULES`, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)
