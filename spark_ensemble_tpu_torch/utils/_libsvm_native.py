"""ctypes binding for the native libsvm parser (PyTorch port of
``utils/_libsvm_native.py``, over the port's own ``csrc/libsvm_parser.cpp``).

This is host code, not a device kernel: ``g++`` builds the source at first
use into ``libsvm_parser_<sha256 of the source>.so`` in the port's build
directory (the kernels' build cache when one is enabled,
``autotune/compilation_cache.py``, else ``build/native`` under the
checkout), so an edit to the source builds a new name and a library of the
same source, built by any process, loads without a compiler.  Callers fall
back to the numpy parser on any failure (``utils/datasets.parse_libsvm``
logs it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from spark_ensemble_tpu_torch.autotune.compilation_cache import (
    compilation_cache_dir,
    ensure_compilation_cache,
)

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "libsvm_parser.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the parser's library is built and found."""
    ensure_compilation_cache()
    enabled = compilation_cache_dir()
    out_dir = Path(enabled) if enabled else _BUILD_DIR
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return out_dir / f"libsvm_parser_{digest}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_CXX_FLAGS, "-o", tmp, str(_SOURCE)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed on {_SOURCE}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _build_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build()))
        lib.libsvm_scan.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.libsvm_scan.restype = ctypes.c_int
        lib.libsvm_fill.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_long,
        ]
        lib.libsvm_fill.restype = ctypes.c_int
        _LIB = lib
        return lib


def parse_libsvm_native(
    path: str, n_features: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    lib = _build_lib()
    n_rows = ctypes.c_long()
    max_idx = ctypes.c_long()
    if lib.libsvm_scan(path.encode(), ctypes.byref(n_rows), ctypes.byref(max_idx)):
        raise IOError(f"native scan failed for {path}")
    n = n_rows.value
    d = n_features if n_features is not None else max_idx.value
    X = np.zeros((n, d), dtype=np.float32)
    y = np.zeros((n,), dtype=np.float32)
    rc = lib.libsvm_fill(
        path.encode(),
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        d,
    )
    if rc:
        raise IOError(f"native fill failed for {path} (rc={rc})")
    return X, y
