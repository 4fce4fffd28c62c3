"""Training-state checkpoint and resume for the iterative estimators
(PyTorch port of ``utils/checkpoint.py``, in the same on-disk format).

The reference's ``PeriodicRDDCheckpointer`` only truncates RDD lineage;
training is not resumable there.  ``checkpoint_interval`` here buys a real
training-state checkpoint: the round index, the members so far, their
weights, the carried predictions or boosting weights and the patience
counters, written atomically every N rounds, from which ``fit`` resumes
after a preemption.

Crash consistency: every save writes a ``manifest.json`` (sha256 and byte
size per file) inside the checkpoint directory before the atomic swap,
and the previous good checkpoint is kept as ``.ckpt-old`` (reclaimed by
``delete()`` at fit end).  ``load_latest`` verifies the manifest and falls
back ``latest`` -> ``.ckpt-old`` -> fresh start instead of crashing on a
torn ``state.json``; writes go through the retry layer.

Saves are asynchronous: ``save`` copies every CUDA tensor of the state
into a pinned host buffer with ``non_blocking=True`` on the current
stream, records a CUDA event, and hands the buffers to a writer thread
that waits on that event before it reads them.  The round loop goes on
launching while the copy and the write land, and the writer thread
touches no CUDA tensor.  CPU tensors are cloned at ``save``, so a later
in-place update of the carry cannot reach a pending write.  Each write is a
``checkpoint_save`` span of the fit's trace, begun on the writer thread and
parented to the fit's root span through the trace context captured on the
fit thread.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from spark_ensemble_tpu_torch.telemetry.trace import NULL_SPAN
from spark_ensemble_tpu_torch.utils.persist import (
    _class_registry,
    _decode,
    _encode,
)

logger = logging.getLogger("spark_ensemble_tpu_torch")

# Bumped whenever the persisted member schema changes in a way a resume
# cannot mix with; a mismatch makes the fit start fresh.  The same number
# as the JAX package's: the state layout is shared, and the fingerprint
# (run_fingerprint's shape parts) keeps the two packages' runs apart.
_CHECKPOINT_FORMAT = 3  # 3: GBM state carries val_hist (round-aligned)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def run_fingerprint(*parts) -> str:
    """Stable digest of estimator config and data shape, stored with each
    checkpoint so a stale checkpoint from another run or config is never
    silently resumed."""
    blob = json.dumps((_CHECKPOINT_FORMAT,) + parts, sort_keys=True,
                      default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def check_rank_directories(directory: Optional[str], axis) -> None:
    """Under a mesh every rank writes its own checkpoint: one collective
    over ``axis`` (every rank of the mesh) gathers each rank's resolved
    ``checkpoint_dir``.  Ranks that share a directory would write the same
    files, and ranks without one would skip the gathers the others make at
    a save: both raise ``ValueError`` on every rank alike, before any
    round runs.  The paths are compared as strings, so one path on two
    hosts' own disks counts as shared too: name each rank's directory
    after its rank."""
    import torch.distributed as dist

    mine = None if not directory else os.path.realpath(str(directory))
    dirs = [None] * axis.size
    dist.all_gather_object(dirs, mine, group=axis.group)
    if any(d is None for d in dirs) and any(d is not None for d in dirs):
        raise ValueError(
            "checkpoint_dir under a mesh: set it on every rank or on none "
            f"(ranks {list(axis.ranks)} have {dirs})"
        )
    shared = sorted({d for d in dirs if d is not None and dirs.count(d) > 1})
    if shared:
        raise ValueError(
            "checkpoint_dir under a mesh: each rank writes its own "
            f"directory, but ranks share {shared}; give every rank its own "
            "(e.g. a per-rank subdirectory)"
        )


def agree_resume(resumed, axis, telem=None):
    """The resume every rank of a mesh takes: ``resumed`` when every rank
    of ``axis`` loaded the same round, else None on every rank (a fresh
    fit, logged and emitted as ``resume_disagreement``).  Ranks that
    resumed at different rounds would pair different rounds' collectives.
    Identity without a mesh (``axis`` None)."""
    if axis is None:
        return resumed
    import torch.distributed as dist

    mine = -1 if resumed is None else int(resumed[0])
    rounds = [None] * axis.size
    dist.all_gather_object(rounds, mine, group=axis.group)
    if len(set(rounds)) == 1:
        return resumed
    logger.warning("mesh ranks loaded checkpoints of different rounds %s; "
                   "every rank starts fresh", rounds)
    if telem is not None:
        telem.emit("resume_disagreement", rounds=[int(r) for r in rounds])
    return None


def _to_host(state):
    """``state`` with every tensor copied off the carry: CUDA tensors into
    pinned host buffers (``non_blocking``), CPU tensors cloned.  Returns
    the host tree and whether any copy is still in flight."""
    pending = [False]

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                buf = torch.empty(node.shape, dtype=node.dtype, pin_memory=True)
                buf.copy_(node.detach(), non_blocking=True)
                pending[0] = True
                return buf
            return node.detach().clone()
        return node

    return walk(state), pending[0]


class TrainingCheckpointer:
    """Atomic periodic checkpoints of a training-state tree (dicts, lists,
    scalars, tensors: the codec of model persistence).

    At most one save is in flight (a new save, ``load_latest`` and
    ``delete`` join the previous one first and re-raise its failure), so
    the order of 'latest' and the error reporting match a synchronous
    save.  Loaded tensors land on ``device``."""

    def __init__(
        self,
        directory: Optional[str],
        interval: int = 10,
        fingerprint: Optional[str] = None,
        async_save: bool = True,
        retry_policy=None,
        device=None,
        telem=None,
    ):
        self.directory = directory
        self.interval = max(int(interval), 1)
        self.fingerprint = fingerprint
        self.async_save = bool(async_save)
        self.retry_policy = retry_policy
        self.device = device
        # the fit's FitTelemetry: checkpoint_save spans and retry events
        self.telem = telem
        # set by load_latest: {"round", "source", "fallback"} describing
        # which on-disk copy a resume actually came from
        self.last_load_detail: Optional[Dict[str, Any]] = None
        self._executor = None
        self._pending = None

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def should_save(self, round_idx: int) -> bool:
        """The save-cadence rule: a save fires after round ``round_idx``
        iff checkpointing is on and ``round_idx + 1`` is a multiple of the
        interval.  Callers gate on this before building the state."""
        return self.enabled and (round_idx + 1) % self.interval == 0

    def rounds_until_save(self, i: int) -> int:
        """Rounds from (0-based) round ``i`` to the next save boundary
        inclusive; chunked round loops clamp their chunk to it, so chunk
        ends land on save rounds at any resume offset."""
        return self.interval - (i % self.interval)

    def maybe_save(self, round_idx: int, state: Dict[str, Any]) -> None:
        if self.should_save(round_idx):
            self.save(round_idx, state)

    def wait(self) -> None:
        """Join the in-flight save, re-raising its failure."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()  # graftlint: ignore[unfenced-blocking-read] -- async-save join at the save boundary, not the dispatch window; kept bare so the save thread's failure re-raises here

    def abandon(self) -> None:
        """A fit is leaving on an exception: join the in-flight save (its
        own failure is logged, the fit's exception is what propagates) and
        stop the writer thread, so no write races the next fit's resume."""
        try:
            self.wait()
        except Exception:  # noqa: BLE001
            logger.warning("a background checkpoint write failed",
                           exc_info=True)
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def save(self, round_idx: int, state: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        self.wait()  # one save in flight at a time
        host, copying = _to_host(state)
        event = None
        if copying:
            event = torch.cuda.Event()
            event.record()
        if not self.async_save:
            if event is not None:
                # graftlint: ignore[unfenced-blocking-read] -- synchronous save (async_save=False): the save boundary waits for its own device-to-host copies by design
                event.synchronize()
            self._save_sync(round_idx, host)
            return
        # the trace context is captured ON THE FIT THREAD: the writer
        # thread parents its checkpoint_save span to this fit's root span
        # through the two propagated ids (telemetry/trace.py)
        ctx = None if self.telem is None else self.telem.trace_context()
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer"
            )
        self._pending = self._executor.submit(
            self._save_after, event, round_idx, host, ctx
        )

    def _save_after(self, event, round_idx: int, state, parent) -> None:
        if event is not None:
            # the device-to-host copies have landed
            event.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- on the writer thread, off the fit's thread
        self._save_sync(round_idx, state, parent)

    def _save_sync(self, round_idx: int, state: Dict[str, Any],
                   parent=None) -> None:
        from spark_ensemble_tpu_torch.robustness.chaos import controller
        from spark_ensemble_tpu_torch.robustness.retry import retry_call

        sp = NULL_SPAN if self.telem is None else self.telem.begin_span(
            "checkpoint_save", parent=parent,
            thread="ckpt-writer" if parent is not None else None,
            round=round_idx,
        )
        try:
            retry_call(
                lambda: self._write(round_idx, state),
                policy=self.retry_policy,
                op="checkpoint.save",
                telem=self.telem,
            )
            # chaos: a crash mid-write after the swap, the torn state that
            # load_latest's manifest check must recover from
            controller().corrupt_checkpoint(
                f"ckpt:{self.directory}:{round_idx}",
                os.path.join(self.directory, "latest", "state.json"),
            )
        finally:
            sp.end()

    def _write(self, round_idx: int, state: Dict[str, Any]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        spec = _encode(state, arrays, "s")
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".ckpt-tmp-")
        try:
            with open(os.path.join(tmp, "state.json"), "w") as f:
                json.dump(
                    {
                        "round": round_idx,
                        "spec": spec,
                        "fingerprint": self.fingerprint,
                    },
                    f,
                    default=float,
                )
            if arrays:
                np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            manifest = {"round": round_idx, "files": {}}
            for name in ("state.json", "arrays.npz"):
                p = os.path.join(tmp, name)
                if os.path.exists(p):
                    manifest["files"][name] = {
                        "sha256": _file_sha256(p),
                        "bytes": os.path.getsize(p),
                    }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.directory, "latest")
            stale = os.path.join(self.directory, ".ckpt-old")
            if os.path.exists(final):
                # retain the displaced 'latest' as the crash-consistent
                # fallback; only the older generation is reclaimed
                if os.path.exists(stale):
                    shutil.rmtree(stale)
                os.rename(final, stale)
            os.rename(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def load_latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Newest loadable checkpoint, or ``None``: tries ``latest`` then
        falls back to the retained ``.ckpt-old`` when 'latest' is
        truncated/corrupt (manifest checksum mismatch, undecodable
        state.json) — a crash between the two rename()s of a save, or a
        torn write on a non-atomic filesystem, must cost one checkpoint
        interval, not the whole run."""
        if not self.enabled:
            return None
        self.wait()
        self.last_load_detail = None
        for source in ("latest", ".ckpt-old"):
            loaded = self._load_dir(os.path.join(self.directory, source))
            if loaded is None:
                continue
            fallback = source != "latest"
            if fallback:
                logger.warning(
                    "checkpoint 'latest' in %s is unusable; resuming from "
                    "the retained .ckpt-old copy (round %d)",
                    self.directory, loaded[0],
                )
            self.last_load_detail = {
                "round": loaded[0], "source": source, "fallback": fallback,
            }
            return loaded
        return None

    def _load_dir(self, path: str) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Decode one checkpoint directory; ``None`` on any corruption
        (logged) or fingerprint mismatch instead of raising."""
        state_path = os.path.join(path, "state.json")
        if not os.path.exists(state_path):
            return None
        try:
            manifest_path = os.path.join(path, "manifest.json")
            if os.path.exists(manifest_path):
                with open(manifest_path) as f:
                    manifest = json.load(f)
                for name, meta in manifest.get("files", {}).items():
                    p = os.path.join(path, name)
                    if (
                        not os.path.exists(p)
                        or os.path.getsize(p) != meta["bytes"]
                        or _file_sha256(p) != meta["sha256"]
                    ):
                        logger.warning(
                            "checkpoint %s failed its manifest check "
                            "(%s corrupt/truncated); ignoring it",
                            path, name,
                        )
                        return None
            with open(state_path) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != self.fingerprint:
                logger.warning(
                    "checkpoint in %s was written by a different run/config "
                    "(fingerprint %s != %s); ignoring it",
                    path, meta.get("fingerprint"), self.fingerprint,
                )
                return None
            arrays = {}
            npz = os.path.join(path, "arrays.npz")
            if os.path.exists(npz):
                with np.load(npz) as f:
                    arrays = dict(f)
            state = _decode(meta["spec"], arrays, _class_registry(), self.device)
            return int(meta["round"]), state
        except Exception:  # noqa: BLE001 - any corruption -> fall back
            logger.warning(
                "checkpoint in %s is corrupt/unreadable; ignoring it",
                path, exc_info=True,
            )
            return None

    def delete(self) -> None:
        """Training finished: remove the checkpoint entries this class
        wrote (the reference deletes its RDD checkpoints after training).
        Only 'latest' and '.ckpt-*' entries go; the directory itself is
        removed only when that leaves it empty."""
        self.abandon()
        if not (self.enabled and os.path.isdir(self.directory)):
            return
        for entry in os.listdir(self.directory):
            if entry == "latest" or entry.startswith(".ckpt-"):
                shutil.rmtree(os.path.join(self.directory, entry),
                              ignore_errors=True)
        try:
            os.rmdir(self.directory)  # succeeds only if now empty
        except OSError:
            pass
