"""On-disk bit-packed bin shards: the out-of-core training format
(PyTorch port of ``data/shards.py``, in the same on-disk format).

``write_shards`` bins a dataset once (the same ``compute_bins`` /
``bin_features`` pair every resident fit uses, on the caller's device) and
stores the bit-packed bin matrix (``ops/binning.pack_bins``) as row
shards, each a ``shard-%05d.npz`` holding the ``u32[rows, W]`` packed
words.  The directory is sealed by a ``manifest.json`` carrying the format
version, the dataset geometry and a sha256 and byte size per file, beside
``thresholds.npz``: the same keys as the JAX package's, so a store written
by either package opens in the other.  A truncated write or a stale or
corrupted shard is an error at ``ShardStore.open``, never silent wrong
math.

The port keeps packed words as int32 bit patterns (``ops/binning.py``);
on disk they are the JAX package's uint32 words, viewed, not converted.

The default shard height equals the stream tier's chunk rows
(``ops/tree._STREAM_CHUNK_ROWS``): a shard sweep (``data/streaming.py``)
then accumulates histograms in exactly the per-chunk order of a resident
``hist="stream"`` fit, which is what makes the two fits bit-identical.

Only the bin matrix lives out of core: it is the round loop's dominant
operand (``n*d`` cells re-read every tree level).  Labels, weights and
carried predictions are ``O(n)`` vectors and stay resident.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from spark_ensemble_tpu_torch.autotune.resolve import resolve as _tuned
from spark_ensemble_tpu_torch.models.base import as_f32, resolve_device
from spark_ensemble_tpu_torch.ops.binning import (
    bin_features,
    compute_bins,
    pack_bins,
)
from spark_ensemble_tpu_torch.utils.checkpoint import _file_sha256

#: on-disk format version; bumped on any layout change so an old store is
#: rejected instead of misread (the JAX package's number)
SHARD_FORMAT = 1

#: default rows per shard: the "shard_rows" tunable's default, equal to
#: ops/tree._STREAM_CHUNK_ROWS (bit-identity with the resident stream tier
#: needs shard height == stream chunk height)
DEFAULT_SHARD_ROWS = 32768

_MANIFEST = "manifest.json"
_THRESHOLDS = "thresholds.npz"


def _member_layout(path: str, member: str = "packed.npy"):
    """Where an uncompressed npz member lies in its file -> ``(start,
    size, crc32, header_len, shape)`` of the member's bytes (its .npy
    header, then the C-order little-endian u32 data), or None when the
    member is compressed or holds another layout."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(member)
        if info.compress_type != zipfile.ZIP_STORED:
            return None
        with zf.open(info) as f:
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            header_len = f.tell()
    if fortran or dtype != np.dtype("<u4") or len(shape) != 2:
        return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)  # the local file header: name and extra lengths
    start = (info.header_offset + 30 + int.from_bytes(local[26:28], "little")
             + int.from_bytes(local[28:30], "little"))
    return start, info.file_size, info.CRC, header_len, shape


def _read_packed(path: str, layouts: Dict[int, Any], i: int) -> np.ndarray:
    """Shard ``i``'s ``u32[rows, W]`` words, as ``np.load`` gives them.

    The prefetch worker reads shards while the consumer thread launches
    the fit's work, and ``np.load``'s zip parsing takes the interpreter
    lock hundreds of times a file.  So the member's place in the file is
    parsed once (``_member_layout``) and each later read is one
    ``readinto`` and one ``crc32``, both of which release the lock; the
    zip CRC is checked as ``np.load`` checks it.  A member this reader
    does not know takes ``np.load``."""
    if i not in layouts:
        layouts[i] = _member_layout(path)
    layout = layouts[i]
    if layout is None:
        with np.load(path) as z:
            return np.asarray(z["packed"], np.uint32)
    start, size, crc, header_len, shape = layout
    buf = np.empty(size, np.uint8)  # no zero fill under the lock
    with open(path, "rb", buffering=0) as f:
        f.seek(start)
        got = f.readinto(buf)
    if got != size or zlib.crc32(buf) != crc:
        raise ValueError(f"shard file {path} fails its zip CRC (changed since open)")
    return buf[header_len:].view(np.uint32).reshape(shape)


def _sha_entry(path: str) -> Dict[str, Any]:
    return {"sha256": _file_sha256(path), "bytes": os.path.getsize(path)}


def write_shards(
    X,
    directory: str,
    *,
    max_bins: int = 64,
    shard_rows: Optional[int] = None,
    bits: int = 0,
    overwrite: bool = False,
    device="cuda",
) -> "ShardStore":
    """Bin + pack ``X`` into a sealed shard directory -> opened store.

    One pass on ``device``: quantile thresholds over the full matrix
    (identical to the resident fit's ``compute_bins``), then per shard
    ``bin_features`` + ``pack_bins`` (row-wise, so per-shard packing equals
    slicing a whole-matrix packing).  Written to a temp dir and atomically
    renamed into place; a crash mid-write leaves no half-readable store."""
    dev = resolve_device(device)
    X = as_f32(X, dev)
    if X.dim() != 2:
        raise ValueError(f"X must be 2-d, got shape {tuple(X.shape)}")
    n, d = X.shape
    if shard_rows is None:
        shard_rows = min(int(_tuned("shard_rows", DEFAULT_SHARD_ROWS, n=n)), n)
    shard_rows = max(1, int(shard_rows))
    num_shards = -(-n // shard_rows)

    directory = os.path.abspath(directory)
    if os.path.exists(os.path.join(directory, _MANIFEST)) and not overwrite:
        raise FileExistsError(
            f"shard store already exists at {directory} "
            "(pass overwrite=True to replace it)"
        )
    parent = os.path.dirname(directory) or "."
    os.makedirs(parent, exist_ok=True)

    bins = compute_bins(X, max_bins)
    thresholds = bins.thresholds.cpu().numpy().astype(np.float32)

    tmp = tempfile.mkdtemp(dir=parent, prefix=".shards-tmp-")
    try:
        shards: List[Dict[str, Any]] = []
        bits_resolved = words_per_row = None
        for s in range(num_shards):
            lo = s * shard_rows
            hi = min(n, lo + shard_rows)
            cb = pack_bins(bin_features(X[lo:hi], bins), max_bins, bits=bits)
            if bits_resolved is None:
                bits_resolved = int(cb.bits)
                words_per_row = int(cb.packed.shape[1])
            fname = f"shard-{s:05d}.npz"
            fpath = os.path.join(tmp, fname)
            # the int32 bit patterns as the uint32 words both packages read
            np.savez(fpath, packed=cb.packed.cpu().numpy().view(np.uint32))
            shards.append(
                {"index": s, "file": fname, "rows": hi - lo, **_sha_entry(fpath)}
            )
        tpath = os.path.join(tmp, _THRESHOLDS)
        np.savez(tpath, thresholds=thresholds)
        manifest = {
            "format": SHARD_FORMAT,
            "n": n,
            "d": d,
            "max_bins": int(max_bins),
            "bits": bits_resolved,
            "words_per_row": words_per_row,
            "shard_rows": int(shard_rows),
            "thresholds": {"file": _THRESHOLDS, **_sha_entry(tpath)},
            "shards": shards,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(directory):
            # overwrite: swap the old store out of the way first so the
            # final rename stays a single atomic transition
            old = tempfile.mkdtemp(dir=parent, prefix=".shards-old-")
            os.rename(directory, os.path.join(old, "store"))
            shutil.rmtree(old, ignore_errors=True)
        os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return ShardStore.open(directory)


class ShardStore:
    """Read handle on a sealed shard directory (see ``write_shards``).

    ``open`` verifies the manifest's format version and every listed file's
    size + sha256 before any math runs: a shard store is trusted the way a
    checkpoint is trusted, by hash, not by mtime."""

    def __init__(self, directory: str, manifest: Dict[str, Any],
                 thresholds: np.ndarray,
                 verified_shards: Optional[frozenset] = None):
        self.directory = directory
        self._manifest = manifest
        self._thresholds = thresholds
        #: None = every shard verified (full open); otherwise the subset
        #: whose bytes this handle checked; reads outside it are refused
        self._verified_shards = verified_shards
        #: per shard, where its words lie in the file (``_member_layout``)
        self._layouts: Dict[int, Any] = {}

    # -- geometry ------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self._manifest["n"])

    @property
    def d(self) -> int:
        return int(self._manifest["d"])

    @property
    def max_bins(self) -> int:
        return int(self._manifest["max_bins"])

    @property
    def bits(self) -> int:
        return int(self._manifest["bits"])

    @property
    def words_per_row(self) -> int:
        return int(self._manifest["words_per_row"])

    @property
    def shard_rows(self) -> int:
        return int(self._manifest["shard_rows"])

    @property
    def num_shards(self) -> int:
        return len(self._manifest["shards"])

    @property
    def thresholds(self) -> np.ndarray:
        """f32[d, max_bins-1] split thresholds, identical to the resident
        fit's (same ``compute_bins`` over the same X)."""
        return self._thresholds

    @property
    def packed_nbytes(self) -> int:
        """Total bytes of the shard files: the operand the out-of-core
        budget is measured against."""
        return sum(int(s["bytes"]) for s in self._manifest["shards"])

    def shard_meta(self, i: int) -> Dict[str, Any]:
        return self._manifest["shards"][i]

    @property
    def verified_shards(self) -> Optional[frozenset]:
        """Shard indices whose bytes were hash-verified at ``open``;
        ``None`` means all of them (a full open)."""
        return self._verified_shards

    # -- IO ------------------------------------------------------------
    @classmethod
    def open(
        cls,
        directory: str,
        verify: bool = True,
        shards: Optional[Sequence[int]] = None,
    ) -> "ShardStore":
        """Open a sealed store, optionally verifying only ``shards``.

        With ``shards=`` only the named entries plus the thresholds file pay
        the existence, size and sha256 checks.  The manifest is still
        checked in full: per-entry row counts must tile ``n`` exactly and
        indices must be dense.  Reads outside the verified subset raise.
        The size check runs even with ``verify=False``."""
        directory = os.path.abspath(directory)
        mpath = os.path.join(directory, _MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(f"no shard manifest at {mpath}")
        with open(mpath) as f:
            manifest = json.load(f)
        fmt = manifest.get("format")
        if fmt != SHARD_FORMAT:
            raise ValueError(
                f"shard store format {fmt} unsupported "
                f"(expected {SHARD_FORMAT}); re-run write_shards"
            )
        all_shards = manifest["shards"]
        num_shards = len(all_shards)
        rows_total = 0
        for pos, ent in enumerate(all_shards):
            if int(ent["index"]) != pos:
                raise ValueError(
                    f"shard manifest entry {pos} has index {ent['index']} "
                    "— manifest is not dense; refusing to partition it"
                )
            if not 1 <= int(ent["rows"]) <= int(manifest["shard_rows"]):
                raise ValueError(
                    f"shard {pos} claims {ent['rows']} rows, outside "
                    f"[1, {manifest['shard_rows']}]"
                )
            rows_total += int(ent["rows"])
        if rows_total != int(manifest["n"]):
            raise ValueError(
                f"shard rows sum to {rows_total} but manifest n is "
                f"{manifest['n']} — global row count disagrees"
            )
        verified: Optional[frozenset] = None
        if shards is None:
            entries = list(all_shards) + [manifest["thresholds"]]
        else:
            subset = [int(i) for i in shards]
            if len(set(subset)) != len(subset):
                raise ValueError(f"duplicate shard indices in subset: {subset}")
            bad = [i for i in subset if not 0 <= i < num_shards]
            if bad:
                raise ValueError(
                    f"shard subset {bad} out of range for a "
                    f"{num_shards}-shard manifest"
                )
            entries = [all_shards[i] for i in subset] + [manifest["thresholds"]]
            verified = frozenset(subset)
        for ent in entries:
            fpath = os.path.join(directory, ent["file"])
            if not os.path.exists(fpath):
                raise FileNotFoundError(f"shard store missing {fpath}")
            size = os.path.getsize(fpath)
            if size != int(ent["bytes"]):
                raise ValueError(
                    f"shard store file {ent['file']} is {size} bytes, "
                    f"manifest says {ent['bytes']} — truncated or stale"
                )
            if verify and _file_sha256(fpath) != ent["sha256"]:
                raise ValueError(
                    f"shard store file {ent['file']} failed its sha256 "
                    "check — corrupted or tampered"
                )
        with np.load(os.path.join(directory, manifest["thresholds"]["file"])) as z:
            thresholds = np.asarray(z["thresholds"], np.float32)
        return cls(directory, manifest, thresholds, verified_shards=verified)

    def load_shard(self, i: int) -> np.ndarray:
        """Shard ``i``'s packed words, zero-padded to ``shard_rows``
        (u32[shard_rows, W]).  Zero words unpack to bin-0 rows; the
        streaming fit slices a shard to its own ``rows`` before any math."""
        if self._verified_shards is not None and i not in self._verified_shards:
            raise ValueError(
                f"shard {i} is outside this handle's verified subset "
                f"(opened with shards={sorted(self._verified_shards)}); "
                "re-open with the full manifest or a wider subset"
            )
        ent = self._manifest["shards"][i]
        packed = _read_packed(os.path.join(self.directory, ent["file"]),
                              self._layouts, i)
        rows = packed.shape[0]
        if rows < self.shard_rows:
            packed = np.pad(packed, ((0, self.shard_rows - rows), (0, 0)))
        return packed
