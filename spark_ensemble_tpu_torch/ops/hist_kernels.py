"""Level-histogram kernels for the H100 and their plain PyTorch versions
(port of ``spark_ensemble_tpu/ops/pallas_hist.py``).

Two TPU kernels are replaced, both by ``csrc/hist.cu`` (CUDA C++ for
``sm_90a``, built with ``nvcc`` at first use and bound with ``ctypes``):

- ``_hist_kernel`` (``ops/pallas_hist.py:100``, the pallas tier) ->
  :func:`hist_level_pallas`: the level histogram over ``i32`` bins with the
  statistics split into bf16 hi + lo.
- ``_fused_kernel`` (``ops/pallas_hist.py:258``, the fused tier) ->
  :func:`fused_round_level`: a route launch (:func:`route_packed`, tiled by
  :func:`route_plan`), then the level histogram over packed words with a
  3-term bf16 split (:func:`hist_level_packed`); in leaf mode one launch
  that routes and takes the exact f32 leaf sums, as the TPU kernel's leaf
  mode does (kernel ``leaf_sums``, tiled by :func:`leaf_plan`; without split
  tables it only sums, :func:`leaf_sums`).  The routed leaf pass reads
  each (row, member)'s one packed word, never whole rows, so it takes rows
  of any width.

Both level histograms launch one kernel, ``level_hist`` (i32 bins are
32-bit words), tiled by :func:`level_plan`.  Its plan reads two autotuned
knobs per tier (``autotune/space.py``): the rows staged per step
(``pallas_block_rows`` / ``fused_block_rows``, bit-neutral) and the bytes
of a CTA's histogram tile (``pallas_vmem_budget`` / ``fused_vmem_budget``).
A forest fit resolves them once (:func:`level_knobs`) and passes them to
each launch (a wrapper called without them takes the shipped ones); the
plan caches key on them.

Every wrapper checks device, dtype, shape and contiguity, and raises on
anything the kernel does not take.  On CPU tensors it runs the plain
version; on CUDA tensors it launches the kernel on the stream current at
the call (so host threads may launch side by side) or raises — it never
falls back.  Each launch adds one to ``LAUNCHES[<kernel>]``, under a lock;
the library loads once per process, under another.  The kernel source notes what bounds each kernel and
what its design does about it.

Work: :func:`kernel_work` is each kernel's byte and operation count at its
shapes (inputs read once, outputs written once; one add per statistic
cell a row touches), the one formula ``chip_smoke.py``'s bounds and the
program inventory (``telemetry/programz.py``) read.  When a work hook is
installed (:func:`set_work_hook`, the inventory's), every wrapper reports
``(kernel, shape signature, bytes, ops)`` to it after its kernel launched
on the card, or after its plain version ran on the CPU (on the card a
level histogram's signature also holds its plan's ``clusters``, which the
work ignores); ``LAUNCHES`` keeps counting card launches only,
``LEVEL_SPLITS`` those level-histogram launches among them that split a
tile's rows over more than one cluster, ``LEVEL_COMPACT`` those whose node
tiles walked row lists (``LevelPlan.compact``; such a launch is three
kernels on the stream: the lists' two, :func:`level_rows`, then the
histogram's), and ``LEAF_GATHERS`` the leaf launches that route, each
gathering one packed word a (row, member).
With no hook a wrapper pays one global load.

Precision: the kernel and its plain version split each row's statistic
into exactly the same bf16 terms and sum them in f32; only the order of
the sum differs.  Leaf sums are plain f32.

Lanes: a megabatch sweep (``models/gbm_sweep.py``) folds S candidates of K
members each into one launch of M = S * K members.  With ``lanes=S`` the
histogram and leaf wrappers sum every member's rows in the order a launch
of the K members alone takes (:func:`lane_level_plan`,
:func:`lane_leaf_plan`): member ``s * K + j`` of the wide launch equals
member ``j`` of its lane's own launch bit for bit, so a swept candidate
fits exactly as it would alone.  The route is integer-exact at any plan.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import logging
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from spark_ensemble_tpu_torch.autotune.compilation_cache import (
    compilation_cache_dir,
    ensure_compilation_cache,
)
from spark_ensemble_tpu_torch.autotune.resolve import resolve as _tuned
from spark_ensemble_tpu_torch.ops.binning import unpack_bins

logger = logging.getLogger("spark_ensemble_tpu_torch")

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hist.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# launches on the card, by kernel; the CPU plain versions never count
LAUNCHES = {"hist_i32": 0, "route_packed": 0, "hist_packed": 0, "leaf_sums": 0}
# the level histograms' launches among them whose plan split a tile's rows
# over more than one cluster (``LevelPlan.clusters``)
LEVEL_SPLITS = {"hist_i32": 0, "hist_packed": 0}
# the level histograms' launches among them whose node tiles each walked a
# list of their own rows (``LevelPlan.compact``)
LEVEL_COMPACT = {"hist_i32": 0, "hist_packed": 0}
# the leaf launches among them that route, gathering each (row, member)'s
# one packed word
LEAF_GATHERS = {"leaf_sums": 0}
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()


def _count(kernel: str, split: bool = False, gather: bool = False,
           compact: bool = False) -> None:
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1
        if split:
            LEVEL_SPLITS[kernel] += 1
        if compact:
            LEVEL_COMPACT[kernel] += 1
        if gather:
            LEAF_GATHERS[kernel] += 1


# the program inventory's hook: ``hook(kernel, signature, bytes, ops)``,
# one slot, so a wrapper without one pays one global load
_WORK_HOOK: list = [None]


def set_work_hook(hook) -> None:
    """Install (``None``: remove) the hook every wrapper reports its
    kernel's work to (``telemetry/programz.py`` owns it)."""
    _WORK_HOOK[0] = hook


def kernel_work(kernel: str, **shapes) -> tuple:
    """``(bytes, ops)`` of one launch of ``kernel`` at ``shapes``: every
    input read once and every output written once (4-byte elements), and
    one add per statistic cell a row touches.

    - ``hist_i32`` (``n, d, M, C, B, n_nodes``) and ``hist_packed`` (the
      same and ``W`` words a row): bins, node ids and statistics in, the
      histogram ``[M, n_nodes, C, d, B]`` out; ``n*M*C*d`` adds.
    - ``route_packed`` (``n, W, M, half``): packed words, parent ids and
      the two split tables ``[M, half]`` in, child ids out; ``n*M``
      compares.
    - ``leaf_sums`` (``n, M, C, leaves``, and ``W, half`` when it routes):
      packed words, parent ids and tables in, leaf ids out (when routed),
      statistics in, sums ``[M, leaves, C]`` out; ``n*M*C`` adds.
    - ``matmul`` (``m, k, n``, and ``batch``, default 1): ``batch``
      products ``[m, k] @ [k, n]`` in f32, operands read and results
      written once; ``2*batch*m*k*n`` flops (the matmul and stream tiers'
      one-hot products, ``ops/tree.py``)."""
    g = shapes.get
    if kernel in ("hist_i32", "hist_packed"):
        n, d, M, C = g("n"), g("d"), g("M"), g("C")
        words = n * (d if kernel == "hist_i32" else g("W"))
        out = M * g("n_nodes") * C * d * g("B")
        return 4 * (words + n * M + n * M * C + out), n * M * C * d
    if kernel == "route_packed":
        n, M = g("n"), g("M")
        return 4 * (n * g("W") + 2 * n * M + 2 * M * g("half")), n * M
    if kernel == "leaf_sums":
        n, M, C, half = g("n"), g("M"), g("C"), g("half", 0)
        ids = n * M * (2 if half else 1)
        return (4 * (n * g("W", 0) + ids + n * M * C + 2 * M * half + M * g("leaves") * C),
                n * M * C)
    if kernel == "matmul":
        m, k, n, b = g("m"), g("k"), g("n"), g("batch", 1)
        return 4 * b * (m * k + k * n + m * n), 2 * b * m * k * n
    raise ValueError(f"no work model for kernel {kernel!r}")


def report_work(kernel: str, **shapes) -> None:
    """Report one call's work (:func:`kernel_work` at ``shapes``) to the
    installed hook.  Every call site tests ``_WORK_HOOK[0]`` first, so a
    call without a hook costs one global load; the hook is read again
    here because another thread may remove it in between."""
    hook = _WORK_HOOK[0]
    if hook is not None:
        hook(kernel, tuple(shapes.items()), *kernel_work(kernel, **shapes))

# every plan depends on the shapes only (the level plan on its two knobs
# too, but its row chunking on the shipped block rows), so the summation
# order, and with it every bit of a result, is fixed by the shapes
_MAX_SMEM = 227 * 1024

# the level histogram's plan (csrc/hist.cu, level_hist): rows per staged
# tile and tiles in flight, the cells one warp owns and the cells one CTA
# holds, warps and cluster size per CTA, and the card it fills (H100 SXM:
# 132 SMs, 228 KB of shared memory per SM, and 1024 resident threads at the
# kernel's 64 registers a thread).  Clusters do not pack SMs fully, since a
# cluster lives within one GPC: about 0.9 of the CTA slots take part.
_LEVEL_ROWS = 256  # 128 when a staged row holds more than _LEVEL_WIDE words
_LEVEL_WIDE = 8
_LEVEL_STAGES = 3
_WARP_HIST_BYTES = 16 * 1024
_CTA_HIST_BYTES = 128 * 1024
_MAX_WARPS = 16
_MAX_CLUSTER = 8
_SMS, _SM_SMEM, _SM_THREADS = 132, 228 * 1024, 1024
_CLUSTER_PACKING = 0.9

# the row lists' plan (csrc/hist.cu, level_hist_count and level_hist_rows):
# warps per CTA (kRowWarps), each counting and then writing one segment of
# rows of one member; the segments a launch aims at over all members, and
# the least rows a segment takes (a multiple of the 32-row step); the most
# node tiles whose per-warp counters fit the kernels' 48 KB of shared memory
_ROW_WARPS = 8
_ROW_SEGMENTS = 4096
_ROW_MIN_SEG = 256
_ROW_MAX_TILES = 48 * 1024 // (4 * _ROW_WARPS)

# the route's plan (csrc/hist.cu, route_packed): threads per CTA, each
# taking 4 elements a pass, the bytes of packed words a tile stages, and the
# card's resident threads for a kernel this light on registers
_ROUTE_THREADS = 256
_ROUTE_WORD_BYTES = 32 * 1024
_SM_LIGHT_THREADS = 2048

# the leaf pass's plan (csrc/hist.cu, leaf_sums): rows a lane loads before
# it adds them (kLeafSteps), warps per CTA, the bytes of one warp's private
# columns, and CTAs per SM
_LEAF_STEPS = 8
_LEAF_WARPS = 8
_LEAF_WARP_BYTES = 16 * 1024
_LEAF_CTAS_PER_SM = 2


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, LEVEL_SPLITS, LEVEL_COMPACT, LEAF_GATHERS):
            for k in counts:
                counts[k] = 0


_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build from csrc/hist.cu at "
            "first use and need the CUDA toolkit"
        )
    return path


def build_dir() -> Path:
    """Where the kernels' library is built and found: the build cache's
    directory when one is enabled (``SE_TPU_COMPILE_CACHE``,
    ``autotune/compilation_cache.py``), else ``build/kernels`` under the
    checkout."""
    ensure_compilation_cache()
    enabled = compilation_cache_dir()
    return Path(enabled) if enabled else _BUILD_DIR


def build_kernels() -> Path:
    """Compile ``csrc/hist.cu`` (if not built yet) into
    ``<build_dir()>/libse_hist_<sha256>.so`` and return its path.  The
    name is keyed on the source's hash, so an edit rebuilds and a library
    of the same source, built by any process, loads without ``nvcc``.  A
    build is one compile on the telemetry ledger
    (``telemetry/events.note_compile``: a fit's ``compile_count``)."""
    from spark_ensemble_tpu_torch.telemetry.events import note_compile

    src = _SOURCE.read_bytes()
    out_dir = build_dir()
    so = out_dir / f"libse_hist_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        note_compile(time.perf_counter() - t0)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _library():
    global _lib
    with _LIB_LOCK:
        if _lib is None:
            _lib = _load_library()
    return _lib


def _load_library():
    lib = ctypes.CDLL(str(build_kernels()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.se_leaf_sums.argtypes = [P] * 9 + [I] * 15 + [P]
    lib.se_leaf_sums.restype = I
    lib.se_leaf_smem_bytes.argtypes = [I] * 6
    lib.se_leaf_smem_bytes.restype = ctypes.c_longlong
    lib.se_route_packed.argtypes = [P] * 5 + [I] * 8 + [P]
    lib.se_route_packed.restype = I
    lib.se_route_smem_bytes.argtypes = [I] * 4
    lib.se_route_smem_bytes.restype = ctypes.c_longlong
    lib.se_level_hist.argtypes = [I, P, P, P, P] + [I] * 15 + [P] * 4 + [I, P]
    lib.se_level_hist.restype = I
    lib.se_level_smem_bytes.argtypes = [I] * 9
    lib.se_level_smem_bytes.restype = ctypes.c_longlong
    lib.se_level_rows.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.se_level_rows.restype = I
    return lib


# ---------------------------------------------------------------------------
# argument checks and the launch plan
# ---------------------------------------------------------------------------


def _check(name, t, dtype, ndim):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name} must be {dtype} with {ndim} dims; got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device(*tensors) -> torch.device:
    """The one device all tensors share: the CPU (plain version) or CUDA
    (kernel); anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev


class LevelPlan(NamedTuple):
    g: int  # members per CTA
    nf: int  # features per CTA; one warp per (member, feature)
    np: int  # nodes per CTA
    cs: int  # CTAs per cluster, each one row chunk, summed in rank order
    clusters: int  # clusters per tile, summed in cluster order
    rows_per_chunk: int
    rows: int  # rows staged per step
    grid: int  # CTAs: member groups x feature tiles x node tiles x clusters x cs
    threads: int  # per CTA
    smem: int  # dynamic shared-memory bytes per CTA
    # node tiles each walk a list of their own rows (:func:`level_rows`)
    # instead of every row of the table: several node tiles, one member a CTA
    compact: bool


def _level_rows_smem(g, nf, np_, C, B, W, bits, block_rows=None, compact=False):
    """Rows per stage, and the bytes of the histogram tile, the row stages,
    one conflict-tag byte per (warp, node, bin) and, for a ``compact``
    plan, the ring of listed rows (one int a staged row and stage): the
    layout of ``csrc/hist.cu::level_hist``.  A stage holds one word per
    feature (i32 bins, or packed rows wider than the tile), or else every
    word of a row; ``block_rows`` (default ``_LEVEL_ROWS``) is halved when a
    staged row holds more than ``_LEVEL_WIDE`` words."""
    block_rows = _LEVEL_ROWS if block_rows is None else block_rows
    words = (nf if bits >= 32 or W > nf else W) + g + g * C  # per staged row
    rows = block_rows if words <= _LEVEL_WIDE else block_rows // 2
    tags = g * nf * (-(-(np_ * B) // 4) * 4)
    ring = _LEVEL_STAGES * rows if compact else 0
    return rows, 4 * (g * nf * np_ * C * B + _LEVEL_STAGES * rows * words + ring) + tags


def _level_tiling(n, d, M, C, B, n_nodes, bits, block_rows, hist_bytes,
                  compact=None) -> LevelPlan:
    """``level_plan`` at explicit knobs, fitting or not (:func:`_fits`).
    ``compact``: None decides from the shapes (several node tiles, one
    member a CTA, the lists' bounds); True takes one member a CTA and
    lists, False no lists."""
    W = d if bits >= 32 else -(-d // (32 // bits))  # words per row
    cell = 4 * C * B  # bytes of one (member, node, feature) histogram row
    np_ = n_nodes if n_nodes * cell <= _WARP_HIST_BYTES else max(1, _WARP_HIST_BYTES // cell)
    warp = np_ * cell
    nf = max(1, min(d, _MAX_WARPS, hist_bytes // warp))
    g = max(1, min(M, _MAX_WARPS // nf, hist_bytes // (nf * warp)))
    while g > 1 and _level_rows_smem(g, nf, np_, C, B, W, bits, block_rows)[1] > _MAX_SMEM:
        g -= 1
    if compact is None:
        compact = (np_ < n_nodes and g == 1 and n * M < 2**31
                   and -(-n_nodes // np_) <= _ROW_MAX_TILES)
    elif compact:
        g = 1
    rows, smem = _level_rows_smem(g, nf, np_, C, B, W, bits, block_rows, compact)
    threads = 32 * g * nf
    tiles = math.ceil(M / g) * math.ceil(d / nf) * math.ceil(n_nodes / np_)
    per_sm = max(1, min(_SM_SMEM // (smem + 1024), _SM_THREADS // threads))
    slots = int(_CLUSTER_PACKING * _SMS * per_sm)
    row_tiles = math.ceil(n / rows)
    cs = next((c for c in range(min(_MAX_CLUSTER, row_tiles), 1, -1)
               if slots // c >= tiles), 1)
    # the slots one cluster per tile leaves empty take more clusters, each
    # with at least a row tile a CTA, and none past the rows
    clusters = max(1, min(slots // (tiles * cs), row_tiles // cs))
    while clusters > 1 and (cs * clusters - 1) * math.ceil(n / (cs * clusters)) >= n:
        clusters -= 1
    chunks = cs * clusters
    return LevelPlan(g, nf, np_, cs, clusters, math.ceil(n / chunks), rows, tiles * chunks,
                     threads, smem, compact)


def _chunked_as(plan: LevelPlan, src: LevelPlan) -> LevelPlan:
    """``plan``'s tiling with ``src``'s row chunking (``cs``, ``clusters``,
    ``rows_per_chunk``), which with the row lists (``compact``, the same in
    both) alone fixes a cell's summation order."""
    tiles = plan.grid // (plan.cs * plan.clusters)
    return plan._replace(cs=src.cs, clusters=src.clusters, rows_per_chunk=src.rows_per_chunk,
                         grid=tiles * src.cs * src.clusters)


def _fits(plan: LevelPlan) -> bool:
    """Whether one CTA of ``plan`` fits the card's shared memory and stages
    whole 32-row steps of the kernel."""
    return plan.smem <= _MAX_SMEM and plan.rows >= 32 and plan.rows % 32 == 0


_LEVEL_KNOBS = {2: ("pallas_block_rows", "pallas_vmem_budget"),
                3: ("fused_block_rows", "fused_vmem_budget")}


def level_knobs(nterms: int, n: Optional[int] = None) -> tuple:
    """``(block_rows, hist_bytes)`` of ``level_hist<nterms>`` (2: the pallas
    tier, 3: the fused tier) as the autotune layer resolves them for ``n``
    rows: its tuned values, or ``_LEVEL_ROWS`` and ``_CTA_HIST_BYTES``.  A
    forest fit resolves them once and hands them to every launch."""
    rows, hist_bytes = _LEVEL_KNOBS[nterms]
    return (int(_tuned(rows, _LEVEL_ROWS, n=n)),
            int(_tuned(hist_bytes, _CTA_HIST_BYTES, n=n)))


def level_plan(n, d, M, C, B, n_nodes, bits=32, knobs=None) -> LevelPlan:
    """CTA tiling of one level histogram (``level_hist``) over bins of
    ``bits`` bits (32: i32 bins), at ``knobs = (block_rows, hist_bytes)``
    (None: :func:`level_knobs` of the pallas tier for 32-bit words, of the
    fused tier otherwise).  A warp owns one (member, feature)'s cells of a
    node tile: every node unless that passes ``_WARP_HIST_BYTES``.  A CTA
    then takes as many features, and for narrow ``d`` members, as fit
    ``hist_bytes``.  A tile's rows are cut into chunks, one a CTA.  The
    CTAs of one cluster (``cs``, at most 8, as many as let every tile's
    cluster run in one wave) sum their chunks in rank order through
    distributed shared memory.  Where one cluster per tile leaves the
    wave's CTA slots empty (tall rows, few members), a tile takes as many
    clusters as fill them (``clusters``), each CTA keeping at least a row
    tile; each cluster writes its sum to a workspace, and the tile's last
    cluster to finish adds them in cluster order, in the same launch.  So
    a cell's sum runs over the chunks in order whatever the clusters, and
    two launches give the same bits.

    Where the level has several node tiles and a CTA holds one member
    (``compact``), each (member, node tile) walks only its own rows: a list
    of them in ascending order, made on the card before the launch
    (:func:`level_rows`), its count split evenly over the tile's chunks on
    the card.  The plan is the same but for the flag and the ring of listed
    rows in shared memory; a cell still sums its rows in ascending order,
    chunk by chunk.  (The flag also needs the lists' int32 positions, n * M
    < 2**31, and at most ``_ROW_MAX_TILES`` node tiles.)

    The row chunking (``cs``, ``clusters``, ``rows_per_chunk``), which
    alone fixes a cell's summation order, is always that of the shipped
    ``_LEVEL_ROWS`` at the same ``hist_bytes``: ``block_rows`` moves only
    the rows staged per step and the tiling, never a bit of the result.
    Knobs whose tile does not fit one CTA's shared memory fall back to the
    shipped ones (a debug log); raises when the shipped ones do not fit
    either."""
    if knobs is None:
        knobs = level_knobs(2 if bits >= 32 else 3, n)
    return _level_plan(n, d, M, C, B, n_nodes, bits, int(knobs[0]), int(knobs[1]))


@functools.lru_cache(maxsize=1024)
def _level_plan(n, d, M, C, B, n_nodes, bits, block_rows, hist_bytes,
                compact=None) -> LevelPlan:
    """``level_plan`` at resolved knobs; ``compact`` as ``_level_tiling``'s."""
    base = _level_tiling(n, d, M, C, B, n_nodes, bits, _LEVEL_ROWS, hist_bytes, compact)
    if not _fits(base) and hist_bytes != _CTA_HIST_BYTES:
        logger.debug("level plan: hist_bytes=%d does not fit; using %d",
                     hist_bytes, _CTA_HIST_BYTES)
        hist_bytes = _CTA_HIST_BYTES
        base = _level_tiling(n, d, M, C, B, n_nodes, bits, _LEVEL_ROWS, hist_bytes, compact)
    if not _fits(base):
        raise ValueError(
            f"histogram tile needs {base.smem} bytes of shared memory "
            f"(C={C}, B={B}); the card has {_MAX_SMEM}"
        )
    if block_rows == _LEVEL_ROWS:
        return base
    plan = _level_tiling(n, d, M, C, B, n_nodes, bits, block_rows, hist_bytes, base.compact)
    if not _fits(plan):
        logger.debug("level plan: block_rows=%d does not fit; using %d",
                     block_rows, _LEVEL_ROWS)
        return base
    return _chunked_as(plan, base)


def _check_lanes(M: int, lanes: int) -> int:
    """The members of one lane; raises unless ``lanes`` divides M."""
    if lanes < 1 or M % lanes:
        raise ValueError(f"{M} members do not split into {lanes} lanes")
    return M // lanes


def lane_level_plan(n, d, M, C, B, n_nodes, bits=32, lanes=1, knobs=None) -> LevelPlan:
    """``level_plan`` of M = lanes * K members that sums each member's rows
    as a launch of K members does.  A cell's sum runs over its CTA's row
    chunk in 32-row steps from the chunk's start, whatever the member,
    feature and node tiling and the rows staged per step, and its chunks
    are added in rank order, then cluster order: so the row chunking
    (``cs``, ``clusters``, ``rows_per_chunk``) alone fixes its bits.  The
    wide plan keeps its own tiling and takes the K-member launch's
    chunking; its grid grows by the lanes instead of its chunks shrinking.
    Where the K-member launch walks row lists (one list a member and node
    tile, so the same rows for the same member), the wide one does too,
    one member a CTA.  ``knobs``: as ``level_plan``'s, resolved once for
    both plans."""
    if knobs is None:
        knobs = level_knobs(2 if bits >= 32 else 3, n)
    return _lane_level_plan(n, d, M, C, B, n_nodes, bits, lanes, int(knobs[0]),
                            int(knobs[1]))


@functools.lru_cache(maxsize=1024)
def _lane_level_plan(n, d, M, C, B, n_nodes, bits, lanes, block_rows, hist_bytes):
    knobs = (block_rows, hist_bytes)
    plan = level_plan(n, d, M, C, B, n_nodes, bits, knobs)
    if lanes == 1:
        return plan
    lane = level_plan(n, d, _check_lanes(M, lanes), C, B, n_nodes, bits, knobs)
    if plan.compact != lane.compact:
        plan = _level_plan(n, d, M, C, B, n_nodes, bits, block_rows, hist_bytes, lane.compact)
    return _chunked_as(plan, lane)


class RoutePlan(NamedTuple):
    rows: int  # rows per tile, a multiple of 4
    grid: int  # CTAs, one wave; each loops over tiles
    smem: int  # dynamic shared-memory bytes per CTA


@functools.lru_cache(maxsize=1024)
def route_plan(n, M, half, W) -> RoutePlan:
    """CTA tiling of one route (``route_packed``); a function of the shapes
    only.  A tile holds as many rows as give each thread one 4-element
    quad of (row, member) pairs, at most ``_ROUTE_WORD_BYTES`` of packed
    words and at least 4 rows; the grid is one wave of CTAs that loop over
    the tiles.  Raises when the split tables do not fit one CTA's shared
    memory."""
    rows = max(4, min(4 * _ROUTE_THREADS // M, _ROUTE_WORD_BYTES // (4 * W)) // 4 * 4)
    smem = 8 * M * half + 4 * rows * W
    if smem > _MAX_SMEM:
        raise ValueError(
            f"route tile needs {smem} bytes of shared memory (M={M}, "
            f"half={half}, W={W}); the card has {_MAX_SMEM}"
        )
    per_sm = max(1, min(_SM_LIGHT_THREADS // _ROUTE_THREADS, _SM_SMEM // (smem + 1024)))
    return RoutePlan(rows, max(1, min(math.ceil(n / rows), _SMS * per_sm)), smem)


class LeafPlan(NamedTuple):
    g: int  # members a row slot spans: lane = slot * g + member, 32 // g slots
    n_mg: int  # member groups per member tile
    n_rw: int  # warps per member group; they share the CTA's rows
    LT: int  # leaves per tile: a lane's private column holds LT x C sums
    cs: int  # CTAs per cluster, summed in rank order
    grid: int  # CTAs: clusters x cs; clusters are summed in order
    rows_per_cta: int
    threads: int  # per CTA
    smem: int  # dynamic shared-memory bytes per CTA


def _leaf_smem(C, g, n_mg, n_rw, LT, half):
    """Bytes of the warps' columns, the CTA's partial (one more set of
    columns per member group), the split tables and a flag: the layout of
    ``csrc/hist.cu::leaf_sums``."""
    return 4 * (n_mg * (n_rw + 1) * LT * C * 32 + 2 * n_mg * g * half + 1)


@functools.lru_cache(maxsize=1024)
def leaf_plan(n, M, C, leaves, half=0) -> LeafPlan:
    """CTA tiling of the leaf pass (``leaf_sums``) over ``leaves`` leaves,
    routed through split tables ``[M, half]`` (``half = 0``: the ids are
    given); a function of the shapes only, so the summation order is too.
    A routed pass reads one packed word a (row, member) and stages no rows,
    so the plan does not depend on the rows' width.  Lanes map to members
    (groups of 32), and a warp takes ``32 // g`` rows at once when M is
    small.  A
    lane's column holds every leaf unless a warp's columns pass
    ``_LEAF_WARP_BYTES`` (then leaves are tiled); a CTA has ``_LEAF_WARPS``
    warps; members are tiled past 8 groups.  Warps, member groups and then
    leaves per tile halve until a CTA fits its shared memory; raises when
    one warp with one leaf does not fit.  A CTA takes whole chunks of rows
    (``_LEAF_STEPS`` rows a lane), as few as let the grid fill
    ``_LEAF_CTAS_PER_SM`` CTAs per SM in one wave, in clusters of up to 8."""
    g = min(M, 32)
    S = 32 // g
    n_mg = min(-(-M // g), _LEAF_WARPS)
    n_rw = max(1, _LEAF_WARPS // n_mg)
    LT = min(leaves, max(1, _LEAF_WARP_BYTES // (128 * C)))
    while (smem := _leaf_smem(C, g, n_mg, n_rw, LT, half)) > _MAX_SMEM:
        if n_rw > 1:
            n_rw //= 2
        elif n_mg > 1:
            n_mg //= 2
        elif LT > 1:
            LT = -(-LT // 2)
        else:
            raise ValueError(
                f"leaf pass needs {smem} bytes of shared memory (M={M}, "
                f"C={C}, leaves={leaves}, half={half}); the card has "
                f"{_MAX_SMEM}"
            )
    threads = 32 * n_mg * n_rw
    per_sm = max(1, min(_SM_SMEM // (smem + 1024), _SM_LIGHT_THREADS // threads, _LEAF_CTAS_PER_SM))
    RC = _LEAF_STEPS * n_rw * S  # rows per chunk
    chunks = max(1, math.ceil(n / RC))
    cs = min(_MAX_CLUSTER, chunks)
    per_cta = math.ceil(chunks / (_SMS * per_sm // cs * cs))
    grid = cs * math.ceil(math.ceil(chunks / per_cta) / cs)
    return LeafPlan(g, n_mg, n_rw, LT, cs, grid, per_cta * RC, threads, smem)


def lane_leaf_plan(n, M, C, leaves, half=0, lanes=1) -> LeafPlan:
    """``leaf_plan`` of M = lanes * K members that sums each member's rows
    as a launch of K members does: the K-member plan itself.  A member's
    sum depends on its lane's row slots (``g``), the row warps
    (``n_rw``), the rows a CTA takes and the clusters, never on its place
    in the member tile, and a CTA loops over member tiles of
    ``n_mg * g`` members; so the wide launch runs the K-member grid with
    each CTA taking every lane's members in turn."""
    return leaf_plan(n, _check_lanes(M, lanes), C, leaves, half)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=1024)
def _checked_level_plan(n, d, M, C, B, n_nodes, W, bits, lanes, knobs) -> LevelPlan:
    """``lane_level_plan``, held once per shape and knobs against the
    kernel's own shared-memory layout."""
    plan = lane_level_plan(n, d, M, C, B, n_nodes, bits, lanes, knobs)
    if _library().se_level_smem_bytes(plan.g, plan.nf, plan.np, C, B, plan.rows, W, bits,
                                      int(plan.compact)) != plan.smem:
        raise RuntimeError("level_plan and csrc/hist.cu disagree on the shared-memory layout")
    return plan


# the level histograms' workspace per (device, stream), apart from the
# leaf pass's: one integer ticket per output tile, and the clusters'
# partials of every tile.  Each grows when a shape needs more; a tile's last
# cluster resets its ticket, and every cluster writes its whole partial
# before the last reads it, so the partials need no zeroing.
_LEVEL_WORKSPACES: dict = {}


def _level_workspace(dev: torch.device, stream: int, tiles: int, floats: int) -> tuple:
    tickets, partials = _LEVEL_WORKSPACES.get((dev.index, stream), (None, None))
    if tickets is None or tickets.numel() < tiles:
        tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
    if partials is None or partials.numel() < floats:
        partials = torch.empty(floats, dtype=torch.float32, device=dev)
    _LEVEL_WORKSPACES[(dev.index, stream)] = (tickets, partials)
    return tickets, partials


def _row_segments(n: int, M: int) -> tuple:
    """``(seg, n_ws)``: the rows of one segment of the row lists' kernels
    (a warp's, of one member) and the segments of a member, a function of
    the shapes: about ``_ROW_SEGMENTS`` segments over all members, each a
    multiple of 32 rows and at least ``_ROW_MIN_SEG``."""
    per = -(-n * M // _ROW_SEGMENTS)
    seg = max(_ROW_MIN_SEG, -(-per // 32) * 32)
    return seg, -(-n // seg)


# the row lists' workspace per (device, stream), apart from the others: the
# lists (n * M rows), their starts (M * n_pt * n_ws + 1) and the count
# kernel's ticket (0 between launches; its last CTA resets it).  Each grows
# when a shape needs more; a stream's launches run in order.
_ROW_WORKSPACES: dict = {}


def _row_workspace(dev: torch.device, stream: int, rows: int, starts: int) -> tuple:
    listed, first, ticket = _ROW_WORKSPACES.get((dev.index, stream), (None, None, None))
    if listed is None or listed.numel() < rows:
        listed = torch.empty(rows, dtype=torch.int32, device=dev)
    if first is None or first.numel() < starts:
        first = torch.empty(starts, dtype=torch.int32, device=dev)
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    _ROW_WORKSPACES[(dev.index, stream)] = (listed, first, ticket)
    return listed, first, ticket


def _launch_rows(node, n_nodes: int, np_: int, stream: int) -> tuple:
    """The row lists of ``node`` at ``np_`` nodes a tile, made on the card
    (two launches, no wait on the host) -> ``(rows, starts, n_ws)``, views
    of the stream's workspace that the next launch on it overwrites."""
    n, M = node.shape
    seg, n_ws = _row_segments(n, M)
    rows, starts, ticket = _row_workspace(node.device, stream, n * M,
                                          M * -(-n_nodes // np_) * n_ws + 1)
    rc = _library().se_level_rows(_ptr(node), _ptr(starts), _ptr(rows), _ptr(ticket), n, M,
                                  n_nodes, np_, seg, n_ws, stream)
    if rc != 0:
        raise RuntimeError(f"row-list kernel launch failed: CUDA error {rc}")
    return rows, starts, n_ws


def _launch_level(nterms, words, node, vals, out, *, d, B, n_nodes, W, bits,
                  lanes, knobs) -> LevelPlan:
    """One level-histogram launch into ``out`` (after the row lists' two,
    where the plan is compact) -> its plan (None for no rows)."""
    n, M, C = vals.shape
    if n == 0:
        out.zero_()
        return None
    if knobs is None:
        knobs = (_LEVEL_ROWS, _CTA_HIST_BYTES)
    plan = _checked_level_plan(n, d, M, C, B, n_nodes, W, bits, lanes, tuple(knobs))
    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        tickets = partials = rows = starts = None
        n_ws = 0
        if plan.clusters > 1:
            # held until the launch is enqueued, as the leaf pass's workspace
            tickets, partials = _level_workspace(
                out.device, stream, plan.grid // (plan.cs * plan.clusters),
                plan.clusters * out.numel())
        if plan.compact:
            rows, starts, n_ws = _launch_rows(node, n_nodes, plan.np, stream)
        rc = lib.se_level_hist(
            nterms, _ptr(words), _ptr(node), _ptr(vals), _ptr(out), n, d, M,
            C, B, n_nodes, W, bits, plan.g, plan.nf, plan.np, plan.cs,
            plan.clusters, plan.rows, plan.rows_per_chunk, _ptr(partials),
            _ptr(tickets), _ptr(rows), _ptr(starts), n_ws, stream,
        )
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed: CUDA error {rc}")
    return plan


@functools.lru_cache(maxsize=1024)
def _checked_route_plan(n, M, half, W) -> RoutePlan:
    """``route_plan``, held once per shape against the kernel's own
    shared-memory layout."""
    plan = route_plan(n, M, half, W)
    if _library().se_route_smem_bytes(M, half, W, plan.rows) != plan.smem:
        raise RuntimeError("route_plan and csrc/hist.cu disagree on the shared-memory layout")
    return plan


@functools.lru_cache(maxsize=1024)
def _checked_leaf_plan(n, M, C, leaves, half, lanes) -> LeafPlan:
    """``lane_leaf_plan``, held once per shape against the kernel's own
    shared-memory layout."""
    plan = lane_leaf_plan(n, M, C, leaves, half, lanes)
    if _library().se_leaf_smem_bytes(C, plan.g, plan.n_mg, plan.n_rw, plan.LT, half) != plan.smem:
        raise RuntimeError("leaf_plan and csrc/hist.cu disagree on the shared-memory layout")
    return plan


def _on(dev: torch.device):
    """The CUDA device context for a launch on ``dev``, entered only when
    ``dev`` is not the current device already."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


# the leaf pass's workspace per (device, stream): an integer ticket (4
# floats' room) and the clusters' partials.  It is made once and grows when
# a shape needs more; the kernel's last cluster resets the ticket, and a
# stream's launches run in order, so it is safe across streams.
_WORKSPACES: dict = {}


def _leaf_workspace(dev: torch.device, stream: int, floats: int) -> torch.Tensor:
    ws = _WORKSPACES.get((dev.index, stream))
    if ws is None or ws.numel() < 4 + floats:
        ws = torch.zeros(4 + floats, dtype=torch.float32, device=dev)
        _WORKSPACES[(dev.index, stream)] = ws
    return ws


def _launch_leaf(packed, node, vals, best_f, best_t, node_out, out, *,
                 leaves, bits, d, lanes):
    """One leaf-pass launch: routed when the split tables are given."""
    n, M, C = vals.shape
    route = best_f is not None
    half, W = (best_f.shape[1], packed.shape[1]) if route else (0, 0)
    plan = _checked_leaf_plan(n, M, C, leaves, half, lanes)
    dev = out.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ticket = partials = None
    if plan.grid > plan.cs:
        # held until the launch is enqueued: another thread may grow the
        # cached workspace meanwhile, and the allocator may then reuse this one
        ws = _leaf_workspace(dev, stream, plan.grid // plan.cs * M * leaves * C)
        ticket = ws.data_ptr()
        partials = ticket + 16
    with _on(dev):
        rc = _library().se_leaf_sums(
            _ptr(packed), _ptr(node), _ptr(vals), _ptr(best_f), _ptr(best_t),
            _ptr(node_out), _ptr(out), partials, ticket, n, M, C, leaves,
            half, W, bits, d, plan.g, plan.n_mg, plan.n_rw, plan.LT, plan.cs,
            plan.grid, plan.rows_per_cta, stream,
        )
    if rc != 0:
        raise RuntimeError(f"leaf kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# plain versions (CPU path; the card's yardstick in chip_smoke.py)
# ---------------------------------------------------------------------------


def split_terms(v: torch.Tensor, nterms: int) -> torch.Tensor:
    """The TPU kernels' per-row statistic split, summed in f32:
    hi = bf16(v), lo = bf16(v - hi), lo2 = bf16(v - hi - lo)."""
    if nterms == 1:
        return v
    hi = v.to(torch.bfloat16).to(torch.float32)
    lo = (v - hi).to(torch.bfloat16).to(torch.float32)
    if nterms == 2:
        return hi + lo
    lo2 = (v - hi - lo).to(torch.bfloat16).to(torch.float32)
    return hi + lo + lo2


def _add_at(flat, idx, src, ordered):
    """``flat[idx] += src``.  ``index_add_`` sums in row order on the CPU
    but adds by atomics on CUDA, in an order that changes from run to run;
    with ``ordered`` a CUDA tensor takes the sort-based ``index_put_``
    accumulation instead, whose order is fixed."""
    if ordered and flat.is_cuda:
        return flat.index_put_((idx,), src, accumulate=True)
    return flat.index_add_(0, idx, src)


def hist_plain(ids, node, vals, n_nodes, B, nterms, ordered=False) -> torch.Tensor:
    """``H[M, n_nodes, C, d, B]`` by ``index_add_`` over the split terms
    (``ordered``: see ``_add_at``)."""
    n, d = ids.shape
    _, M, C = vals.shape
    dev = vals.device
    t = split_terms(vals, nterms)
    base = torch.arange(M, device=dev)[None, :] * n_nodes + node.long()
    idx = (
        (base[:, :, None, None] * C + torch.arange(C, device=dev)[None, None, :, None])
        * d + torch.arange(d, device=dev)[None, None, None, :]
    ) * B + ids.long()[:, None, None, :]
    H = torch.zeros(M * n_nodes * C * d * B, dtype=torch.float32, device=dev)
    _add_at(H, idx.reshape(-1), t[:, :, :, None].expand(n, M, C, d).reshape(-1), ordered)
    return H.reshape(M, n_nodes, C, d, B)


def route_plain(ids, node, best_f, best_t) -> torch.Tensor:
    """``2 * node + 1 - [bin at best_f <= best_t]``, integer-exact."""
    M = node.shape[1]
    m = torch.arange(M, device=node.device)[None, :]
    nl = node.long()
    b = ids.gather(1, best_f[m, nl].long())
    return (2 * node + 1 - (b <= best_t[m, nl]).to(torch.int32)).to(torch.int32)


def level_rows_plain(node, n_nodes, nodes_per_tile) -> tuple:
    """The row lists of :func:`level_rows` by a stable sort: ``(rows
    i32[n * M], offs i32[M * n_pt + 1])``, list ``m * n_pt + t`` at
    ``rows[offs[l]:offs[l + 1]]``, -1 past the last list."""
    n, M = node.shape
    n_pt = -(-n_nodes // nodes_per_tile)
    nl = node.long().T  # [M, n]: member-major, rows ascending
    ok = (nl >= 0) & (nl < n_nodes)
    key = (torch.arange(M, device=node.device)[:, None] * n_pt
           + torch.div(nl, nodes_per_tile, rounding_mode="floor"))[ok]
    r = torch.arange(n, device=node.device).expand(M, n)[ok]
    rows = torch.full((n * M,), -1, dtype=torch.int32, device=node.device)
    rows[: key.numel()] = r[torch.sort(key, stable=True).indices].to(torch.int32)
    offs = torch.zeros(M * n_pt + 1, dtype=torch.int32, device=node.device)
    offs[1:] = torch.cumsum(torch.bincount(key, minlength=M * n_pt), 0).to(torch.int32)
    return rows, offs


def leaf_plain(node, vals, n_nodes, ordered=False) -> torch.Tensor:
    """``L[M, n_nodes, C]`` f32 sums by ``index_add_`` (``ordered``: see
    ``_add_at``)."""
    n, M, C = vals.shape
    idx = torch.arange(M, device=vals.device)[None, :] * n_nodes + node.long()
    L = torch.zeros(M * n_nodes, C, dtype=torch.float32, device=vals.device)
    _add_at(L, idx.reshape(-1), vals.reshape(-1, C), ordered)
    return L.reshape(M, n_nodes, C)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_stats(node, vals):
    _check("node", node, torch.int32, 2)
    _check("vals", vals, torch.float32, 3)
    if node.shape != vals.shape[:2]:
        raise ValueError(
            f"node {tuple(node.shape)} and vals {tuple(vals.shape)} disagree"
        )


def level_rows(node, *, n_nodes: int, nodes_per_tile: int) -> tuple:
    """The row lists a compact level histogram walks (``LevelPlan.compact``):
    for every member m and node tile t of ``nodes_per_tile`` nodes (list
    ``l = m * n_pt + t``), the rows r with ``node[r, m]`` in the tile, in
    ascending order -> ``(rows i32[n * M], offs i32[M * n_pt + 1])``, list
    l at ``rows[offs[l]:offs[l + 1]]`` and -1 past the last list.  A node
    outside ``[0, n_nodes)`` puts its row in no list.  On the card two
    launches (``level_hist_count``, ``level_hist_rows``) and nothing the
    host waits on; on the CPU :func:`level_rows_plain`."""
    _check("node", node, torch.int32, 2)
    dev = _device(node)
    n, M = node.shape
    if dev.type == "cpu" or n == 0:
        return level_rows_plain(node, n_nodes, nodes_per_tile)
    with _on(dev):
        rows, starts, n_ws = _launch_rows(node, n_nodes, nodes_per_tile,
                                          torch.cuda.current_stream(dev).cuda_stream)
        offs = starts[:M * -(-n_nodes // nodes_per_tile) * n_ws + 1:n_ws].clone()
        past = torch.arange(n * M, device=dev) >= offs[-1]
        return rows[:n * M].masked_fill(past, -1), offs


def hist_level_pallas(Xb, node, vals, *, n_nodes: int, max_bins: int,
                      lanes: int = 1, knobs=None):
    """Level histogram ``H f32[M, n_nodes, C, d, B]`` for all members —
    the pallas tier (replaces ``ops/pallas_hist.py::_hist_kernel``).

    ``Xb i32[n, d]`` binned features; ``node i32[n, M]`` each row's node at
    this level per member; ``vals f32[n, M, C]`` statistic channels, split
    into bf16 hi + lo.  Zero rows contribute exactly 0.  ``lanes``: see
    the module docstring.  ``knobs``: the launch's ``(block_rows,
    hist_bytes)``; None takes the shipped ones, with no resolution in the
    call (a forest fit passes the ones :func:`level_knobs` resolved)."""
    _check("Xb", Xb, torch.int32, 2)
    _check_stats(node, vals)
    _check_lanes(node.shape[1], lanes)
    if Xb.shape[0] != node.shape[0]:
        raise ValueError("Xb and node disagree on rows")
    dev = _device(Xb, node, vals)
    n, d = Xb.shape
    _, M, C = vals.shape
    split = {}  # the card's plan: clusters per tile, for the work hook
    if dev.type == "cpu":
        out = hist_plain(Xb, node, vals, n_nodes, max_bins, 2)
    else:
        out = torch.empty((M, n_nodes, C, d, max_bins), dtype=torch.float32, device=dev)
        plan = _launch_level(2, Xb, node, vals, out, d=d, B=max_bins, n_nodes=n_nodes,
                             W=d, bits=32, lanes=lanes, knobs=knobs)
        split["clusters"] = plan.clusters if plan else 1
        _count("hist_i32", split["clusters"] > 1, compact=bool(plan and plan.compact))
    if _WORK_HOOK[0] is not None:
        report_work("hist_i32", n=n, d=d, M=M, C=C, B=max_bins, n_nodes=n_nodes, **split)
    return out


def _check_packed(packed, bits, num_features):
    _check("packed", packed, torch.int32, 2)
    if bits not in (4, 8, 32):
        raise ValueError(f"bits must be 4, 8 or 32; got {bits}")
    if packed.shape[1] != -(-num_features // (32 // bits)):
        raise ValueError(
            f"packed has {packed.shape[1]} words per row; {num_features} "
            f"features at {bits} bits need {-(-num_features // (32 // bits))}"
        )


def _check_tables(best_f, best_t, node):
    _check("best_f", best_f, torch.int32, 2)
    _check("best_t", best_t, torch.int32, 2)
    if best_f.shape != best_t.shape or best_f.shape[0] != node.shape[1]:
        raise ValueError(
            f"split tables must be [M, half] for node {tuple(node.shape)}; got "
            f"{tuple(best_f.shape)} and {tuple(best_t.shape)}"
        )


def route_packed(packed, node, best_f, best_t, *, bits: int,
                 num_features: int):
    """Route every (row, member) one level down: ``2 * node + 1 -
    [bin(row, best_f[m, node]) <= best_t[m, node]]`` (the routing half of
    ``ops/pallas_hist.py::_fused_kernel``).  ``node`` holds the parent
    level's ids in ``[0, half)``; split tables are ``i32[M, half]``.  On the
    card, a parent outside ``[0, half)`` or a feature outside
    ``[0, num_features)`` routes to -1."""
    _check_packed(packed, bits, num_features)
    _check("node", node, torch.int32, 2)
    _check_tables(best_f, best_t, node)
    if packed.shape[0] != node.shape[0]:
        raise ValueError("packed and node disagree on rows")
    dev = _device(packed, node, best_f, best_t)
    n, M = node.shape
    W = packed.shape[1]
    if dev.type == "cpu":
        from spark_ensemble_tpu_torch.ops.binning import CompressedBins

        ids = unpack_bins(CompressedBins(packed, bits, num_features))
        out = route_plain(ids, node, best_f, best_t)
        if _WORK_HOOK[0] is not None:
            report_work("route_packed", n=n, W=W, M=M, half=best_f.shape[1])
        return out
    out = torch.empty_like(node)
    if out.numel() == 0:
        return out
    plan = _checked_route_plan(n, M, best_f.shape[1], W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on(dev):
        rc = _library().se_route_packed(
            _ptr(packed), _ptr(node), _ptr(best_f), _ptr(best_t), _ptr(out),
            n, M, best_f.shape[1], W, bits, num_features, plan.rows,
            plan.grid, stream,
        )
    if rc != 0:
        raise RuntimeError(f"route kernel launch failed: CUDA error {rc}")
    _count("route_packed")
    if _WORK_HOOK[0] is not None:
        report_work("route_packed", n=n, W=W, M=M, half=best_f.shape[1])
    return out


def hist_level_packed(packed, node, vals, *, n_nodes: int, max_bins: int,
                      bits: int, num_features: int, lanes: int = 1,
                      knobs=None):
    """Level histogram over packed bins with the fused tier's 3-term bf16
    split (the histogram half of ``ops/pallas_hist.py::_fused_kernel``);
    ``lanes``: see the module docstring; ``knobs``: as
    :func:`hist_level_pallas`'s, of the fused tier."""
    _check_packed(packed, bits, num_features)
    _check_stats(node, vals)
    _check_lanes(node.shape[1], lanes)
    if packed.shape[0] != node.shape[0]:
        raise ValueError("packed and node disagree on rows")
    dev = _device(packed, node, vals)
    n, M, C = vals.shape
    split = {}  # as hist_level_pallas's
    if dev.type == "cpu":
        from spark_ensemble_tpu_torch.ops.binning import CompressedBins

        ids = unpack_bins(CompressedBins(packed, bits, num_features))
        out = hist_plain(ids, node, vals, n_nodes, max_bins, 3)
    else:
        out = torch.empty((M, n_nodes, C, num_features, max_bins),
                          dtype=torch.float32, device=dev)
        plan = _launch_level(3, packed, node, vals, out, d=num_features, B=max_bins,
                             n_nodes=n_nodes, W=packed.shape[1], bits=bits, lanes=lanes,
                             knobs=knobs)
        split["clusters"] = plan.clusters if plan else 1
        _count("hist_packed", split["clusters"] > 1, compact=bool(plan and plan.compact))
    if _WORK_HOOK[0] is not None:
        report_work("hist_packed", n=n, d=num_features, W=packed.shape[1], M=M, C=C,
                B=max_bins, n_nodes=n_nodes, **split)
    return out


def leaf_sums(node, vals, *, n_nodes: int, lanes: int = 1):
    """Exact f32 leaf statistics ``L[M, n_nodes, C]`` of this level's ids
    (the leaf mode of ``ops/pallas_hist.py::_fused_kernel`` without
    routing).  On the card, an id outside ``[0, n_nodes)`` adds to no
    leaf.  ``lanes``: see the module docstring."""
    _check_stats(node, vals)
    _check_lanes(node.shape[1], lanes)
    dev = _device(node, vals)
    n, M, C = vals.shape
    if dev.type == "cpu":
        out = leaf_plain(node, vals, n_nodes)
    else:
        out = torch.empty((M, n_nodes, C), dtype=torch.float32, device=dev)
        if n == 0 or out.numel() == 0:
            return out.zero_()
        _launch_leaf(None, node, vals, None, None, None, out, leaves=n_nodes,
                     bits=0, d=0, lanes=lanes)
        _count("leaf_sums")
    if _WORK_HOOK[0] is not None:
        report_work("leaf_sums", n=n, M=M, C=C, leaves=n_nodes)
    return out


def _leaf_routed(packed, node, vals, best_f, best_t, *, n_nodes: int,
                 bits: int, num_features: int, lanes: int = 1):
    """The leaf mode of ``ops/pallas_hist.py::_fused_kernel`` in one launch:
    route the PARENT ids ``node`` through ``best_f/best_t i32[M, half]``
    (``n_nodes == 2 * half``), then take the exact f32 leaf sums ->
    ``(L[M, n_nodes, C], leaf ids i32[n, M])``."""
    _check_packed(packed, bits, num_features)
    _check_stats(node, vals)
    _check_tables(best_f, best_t, node)
    _check_lanes(node.shape[1], lanes)
    if packed.shape[0] != node.shape[0]:
        raise ValueError("packed and node disagree on rows")
    if n_nodes != 2 * best_f.shape[1]:
        raise ValueError(
            f"split tables of {best_f.shape[1]} parents route into "
            f"{2 * best_f.shape[1]} leaves, not n_nodes={n_nodes}"
        )
    dev = _device(packed, node, vals, best_f, best_t)
    n, M, C = vals.shape
    if dev.type == "cpu":
        from spark_ensemble_tpu_torch.ops.binning import CompressedBins

        ids = unpack_bins(CompressedBins(packed, bits, num_features))
        node_out = route_plain(ids, node, best_f, best_t)
        out = leaf_plain(node_out, vals, n_nodes)
    else:
        out = torch.empty((M, n_nodes, C), dtype=torch.float32, device=dev)
        node_out = torch.empty_like(node)
        if n == 0 or out.numel() == 0:
            return out.zero_(), node_out
        _launch_leaf(packed, node, vals, best_f, best_t, node_out, out,
                     leaves=n_nodes, bits=bits, d=num_features, lanes=lanes)
        _count("leaf_sums", gather=True)
    if _WORK_HOOK[0] is not None:
        report_work("leaf_sums", n=n, M=M, C=C, leaves=n_nodes, W=packed.shape[1],
                half=best_f.shape[1])
    return out, node_out


def fused_round_level(packed, node, vals, best_f=None, best_t=None, *,
                      n_nodes: int, max_bins: int, bits: int,
                      num_features: int, leaf: bool = False, lanes: int = 1,
                      knobs=None):
    """One fused level -> ``(H, node_out)``, the counterpart of
    ``ops/pallas_hist.py::fused_round_level``: with split tables
    ``best_f/best_t i32[M, half]`` the PARENT-level ``node`` ids are routed
    first; then the level histogram ``H f32[M, n_nodes, C, d, B]`` (a route
    launch, then a histogram launch), or, when ``leaf``, the leaf sums
    ``[M, n_nodes, C]`` (one launch routes and sums).  ``lanes``: see the
    module docstring; ``knobs``: the histogram launch's, as
    :func:`hist_level_packed`'s (the route's and the leaf pass's plans are
    not tunable)."""
    if (best_f is None) != (best_t is None):
        raise ValueError("best_f and best_t come together")
    if leaf:
        if best_f is None:
            return leaf_sums(node, vals, n_nodes=n_nodes, lanes=lanes), node
        return _leaf_routed(packed, node, vals, best_f, best_t,
                            n_nodes=n_nodes, bits=bits,
                            num_features=num_features, lanes=lanes)
    if best_f is not None:
        node = route_packed(packed, node, best_f, best_t, bits=bits,
                            num_features=num_features)
    H = hist_level_packed(packed, node, vals, n_nodes=n_nodes,
                          max_bins=max_bins, bits=bits,
                          num_features=num_features, lanes=lanes, knobs=knobs)
    return H, node
