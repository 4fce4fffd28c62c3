"""Versioned on-disk cache of measured tuning winners (PyTorch port of
``autotune/cache.py``).

Layout (same crash-consistency discipline as ``utils/checkpoint.py``: a
sha256 manifest written inside a temp directory, then published by
atomic rename with the displaced generation retained):

    <cache_dir>/latest/tuned.json      {"version", "entries": {...}}
    <cache_dir>/latest/manifest.json   {"version", "files": {name: {sha256, bytes}}}
    <cache_dir>/.cache-old/            previous good generation

Entries key winners by ``platform/device_kind/shape_class`` — e.g.
``"cuda/NVIDIA H100 80GB HBM3/n14"`` or ``"cpu/cpu/n14"`` — so a cache
file carried across machines only ever applies to the hardware it was
measured on.  The port's platform is ``"cuda"``, which no JAX backend
name (``"gpu"``, ``"tpu"``) collides with.  Layout, checksums and version
rule are the JAX package's, so a file written by one package loads in the
other.  A corrupt or truncated
``latest`` (manifest checksum mismatch, undecodable JSON) falls back to
``.cache-old`` and then to an empty cache: tuning state can never make
the package fail to import or fit.

The cache directory defaults to
``~/.cache/spark_ensemble_tpu_torch/autotune`` (not the JAX package's, so a
JAX cache on the same machine is never read as the port's) and is
overridden by ``SE_TPU_AUTOTUNE_CACHE``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

from spark_ensemble_tpu_torch.autotune.space import TUNABLES

logger = logging.getLogger("spark_ensemble_tpu_torch")

CACHE_ENV = "SE_TPU_AUTOTUNE_CACHE"

# bumped when the entry schema changes incompatibly; a version-mismatched
# cache is ignored (defaults apply), never partially decoded
CACHE_VERSION = 1

_TUNED_FILE = "tuned.json"
_MANIFEST_FILE = "manifest.json"
_LATEST = "latest"
_OLD = ".cache-old"


def cache_dir() -> str:
    """The active cache directory (``SE_TPU_AUTOTUNE_CACHE`` or the
    user-level default)."""
    env = os.environ.get(CACHE_ENV, "").strip()
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "spark_ensemble_tpu_torch", "autotune"
    )


def _file_sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def entry_key(platform: str, device_kind: str, shape_cls: str) -> str:
    # device_kind strings ("NVIDIA H100 80GB HBM3") contain spaces; the key is
    # a plain string, not a path — only "/" needs normalizing
    return "/".join(
        str(p).replace("/", "_") for p in (platform, device_kind, shape_cls)
    )


class TuningCache:
    """In-memory view of the on-disk winners, with load/save/lookup."""

    def __init__(self, entries: Optional[Dict[str, Dict[str, Any]]] = None):
        self.entries: Dict[str, Dict[str, Any]] = dict(entries or {})

    # -- lookup -------------------------------------------------------------
    def lookup(
        self, platform: str, device_kind: str, shape_cls: str
    ) -> Dict[str, Any]:
        """Merged tuned params for a resolution site: the platform-wide
        ``"*"`` entry overlaid by the exact shape-class entry.  Unknown
        names and invalid values are dropped (forward compat)."""
        merged: Dict[str, Any] = {}
        for cls in ("*", shape_cls):
            entry = self.entries.get(entry_key(platform, device_kind, cls))
            if entry:
                merged.update(entry.get("params", {}))
        return TUNABLES.validate_params(merged)

    def has_entry(
        self, platform: str, device_kind: str, shape_cls: str
    ) -> bool:
        return bool(self.lookup(platform, device_kind, shape_cls))

    def put(
        self,
        platform: str,
        device_kind: str,
        shape_cls: str,
        params: Dict[str, Any],
        meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        key = entry_key(platform, device_kind, shape_cls)
        entry = self.entries.setdefault(key, {"params": {}})
        entry["params"].update(TUNABLES.validate_params(params))
        if meta:
            entry.setdefault("meta", {}).update(meta)

    # -- disk ---------------------------------------------------------------
    @classmethod
    def load(cls, directory: Optional[str] = None) -> "TuningCache":
        """Load ``latest`` (manifest-verified), falling back to the
        retained ``.cache-old`` and then to empty."""
        directory = directory or cache_dir()
        for source in (_LATEST, _OLD):
            loaded = cls._load_dir(os.path.join(directory, source))
            if loaded is not None:
                if source == _OLD:
                    logger.warning(
                        "autotune cache 'latest' unreadable; using the "
                        "retained previous generation (%s)", directory,
                    )
                return loaded
        return cls()

    @classmethod
    def _load_dir(cls, path: str) -> Optional["TuningCache"]:
        tuned_path = os.path.join(path, _TUNED_FILE)
        manifest_path = os.path.join(path, _MANIFEST_FILE)
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
            if manifest.get("version") != CACHE_VERSION:
                logger.warning(
                    "autotune cache version %r != %d; ignoring %s",
                    manifest.get("version"), CACHE_VERSION, path,
                )
                return None
            want = manifest.get("files", {}).get(_TUNED_FILE, {})
            if _file_sha256(tuned_path) != want.get("sha256"):
                logger.warning(
                    "autotune cache checksum mismatch; ignoring %s", path
                )
                return None
            with open(tuned_path) as f:
                data = json.load(f)
            if data.get("version") != CACHE_VERSION:
                return None
            entries = data.get("entries", {})
            if not isinstance(entries, dict):
                return None
            return cls(entries)
        except (OSError, json.JSONDecodeError, ValueError):
            return None

    def save(self, directory: Optional[str] = None) -> str:
        """Atomically publish this cache as the new ``latest``; the
        displaced generation is retained as ``.cache-old``.  Returns the
        published directory."""
        directory = directory or cache_dir()
        os.makedirs(directory, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=directory, prefix=".cache-tmp-")
        try:
            tuned_path = os.path.join(tmp, _TUNED_FILE)
            with open(tuned_path, "w") as f:
                json.dump(
                    {"version": CACHE_VERSION, "entries": self.entries},
                    f, indent=2, sort_keys=True,
                )
            manifest = {
                "version": CACHE_VERSION,
                "files": {
                    _TUNED_FILE: {
                        "sha256": _file_sha256(tuned_path),
                        "bytes": os.path.getsize(tuned_path),
                    }
                },
            }
            with open(os.path.join(tmp, _MANIFEST_FILE), "w") as f:
                json.dump(manifest, f, indent=2)
            final = os.path.join(directory, _LATEST)
            stale = os.path.join(directory, _OLD)
            if os.path.exists(final):
                if os.path.exists(stale):
                    shutil.rmtree(stale)
                os.rename(final, stale)
            os.rename(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return os.path.join(directory, _LATEST)


def manifest_signature(directory: Optional[str] = None):
    """Cheap change-detection token for the published cache: (mtime_ns,
    size) of ``latest/manifest.json``, or ``None`` when absent.  The
    resolution layer re-loads only when this changes, so per-call resolve
    cost is one ``stat``."""
    path = os.path.join(directory or cache_dir(), _LATEST, _MANIFEST_FILE)
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None
