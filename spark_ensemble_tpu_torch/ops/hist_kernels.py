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
  tables it only sums, :func:`leaf_sums`).

Both level histograms launch one kernel, ``level_hist`` (i32 bins are
32-bit words), tiled by :func:`level_plan`.

Every wrapper checks device, dtype, shape and contiguity, and raises on
anything the kernel does not take.  On CPU tensors it runs the plain
version; on CUDA tensors it launches the kernel on the stream current at
the call (so host threads may launch side by side) or raises — it never
falls back.  Each launch adds one to ``LAUNCHES[<kernel>]``, under a lock;
the library loads once per process, under another.  The kernel source notes what bounds each kernel and
what its design does about it.

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

from spark_ensemble_tpu_torch.ops.binning import unpack_bins

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hist.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# launches on the card, by kernel; the CPU plain versions never count
LAUNCHES = {"hist_i32": 0, "route_packed": 0, "hist_packed": 0, "leaf_sums": 0}
_COUNT_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()


def _count(kernel: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1

# every plan depends on the shapes only, so the summation order, and with
# it every bit of a result, is fixed by the shapes
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
        for k in LAUNCHES:
            LAUNCHES[k] = 0


_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build from csrc/hist.cu at "
            "first use and need the CUDA toolkit"
        )
    return path


def build_kernels() -> Path:
    """Compile ``csrc/hist.cu`` (if not built yet) into
    ``build/kernels/libse_hist_<sha256>.so`` and return its path.  The
    name is keyed on the source's hash, so an edit rebuilds.  A build is
    one compile on the telemetry ledger (``telemetry/events.note_compile``:
    a fit's ``compile_count``)."""
    from spark_ensemble_tpu_torch.telemetry.events import note_compile

    src = _SOURCE.read_bytes()
    so = _BUILD_DIR / f"libse_hist_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
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
    lib.se_leaf_smem_bytes.argtypes = [I] * 7
    lib.se_leaf_smem_bytes.restype = ctypes.c_longlong
    lib.se_route_packed.argtypes = [P] * 5 + [I] * 8 + [P]
    lib.se_route_packed.restype = I
    lib.se_route_smem_bytes.argtypes = [I] * 4
    lib.se_route_smem_bytes.restype = ctypes.c_longlong
    lib.se_level_hist.argtypes = [I, P, P, P, P] + [I] * 14 + [P]
    lib.se_level_hist.restype = I
    lib.se_level_smem_bytes.argtypes = [I] * 8
    lib.se_level_smem_bytes.restype = ctypes.c_longlong
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
    cs: int  # row chunks: the CTAs of one cluster, summed in rank order
    rows_per_chunk: int
    rows: int  # rows staged per step
    grid: int  # CTAs: member groups x feature tiles x node tiles x cs
    threads: int  # per CTA
    smem: int  # dynamic shared-memory bytes per CTA


def _level_rows_smem(g, nf, np_, C, B, W, bits):
    """Rows per stage, and the bytes of the histogram tile, the row stages
    and one conflict-tag byte per (warp, node, bin): the layout of
    ``csrc/hist.cu::level_hist``.  A stage holds one word per feature (i32
    bins, or packed rows wider than the tile), or else every word of a
    row."""
    words = (nf if bits >= 32 or W > nf else W) + g + g * C  # per staged row
    rows = _LEVEL_ROWS if words <= _LEVEL_WIDE else _LEVEL_ROWS // 2
    tags = g * nf * (-(-(np_ * B) // 4) * 4)
    return rows, 4 * (g * nf * np_ * C * B + _LEVEL_STAGES * rows * words) + tags


@functools.lru_cache(maxsize=1024)
def level_plan(n, d, M, C, B, n_nodes, bits=32) -> LevelPlan:
    """CTA tiling of one level histogram (``level_hist``) over bins of
    ``bits`` bits (32: i32 bins); a function of the shapes only, so the
    summation order is too.  A warp owns one (member, feature)'s cells of a
    node tile: every node unless that passes ``_WARP_HIST_BYTES``.  A CTA
    then takes as many features, and for narrow ``d`` members, as fit
    ``_CTA_HIST_BYTES``.  Each tile's row chunks form one cluster, as large
    as lets every tile's cluster run in one wave, and at most 8.  Raises when
    one warp's cells and the staged rows do not fit one CTA's shared
    memory."""
    W = d if bits >= 32 else -(-d // (32 // bits))  # words per row
    cell = 4 * C * B  # bytes of one (member, node, feature) histogram row
    np_ = n_nodes if n_nodes * cell <= _WARP_HIST_BYTES else max(1, _WARP_HIST_BYTES // cell)
    warp = np_ * cell
    nf = max(1, min(d, _MAX_WARPS, _CTA_HIST_BYTES // warp))
    g = max(1, min(M, _MAX_WARPS // nf, _CTA_HIST_BYTES // (nf * warp)))
    while g > 1 and _level_rows_smem(g, nf, np_, C, B, W, bits)[1] > _MAX_SMEM:
        g -= 1
    rows, smem = _level_rows_smem(g, nf, np_, C, B, W, bits)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"histogram tile needs {smem} bytes of shared memory "
            f"(C={C}, B={B}); the card has {_MAX_SMEM}"
        )
    threads = 32 * g * nf
    tiles = math.ceil(M / g) * math.ceil(d / nf) * math.ceil(n_nodes / np_)
    per_sm = max(1, min(_SM_SMEM // (smem + 1024), _SM_THREADS // threads))
    slots = int(_CLUSTER_PACKING * _SMS * per_sm)
    cs = next((c for c in range(min(_MAX_CLUSTER, math.ceil(n / rows)), 1, -1)
               if slots // c >= tiles), 1)
    return LevelPlan(g, nf, np_, cs, math.ceil(n / cs), rows, tiles * cs, threads, smem)


def _check_lanes(M: int, lanes: int) -> int:
    """The members of one lane; raises unless ``lanes`` divides M."""
    if lanes < 1 or M % lanes:
        raise ValueError(f"{M} members do not split into {lanes} lanes")
    return M // lanes


@functools.lru_cache(maxsize=1024)
def lane_level_plan(n, d, M, C, B, n_nodes, bits=32, lanes=1) -> LevelPlan:
    """``level_plan`` of M = lanes * K members that sums each member's rows
    as a launch of K members does.  A cell's sum runs over its CTA's row
    chunk in 32-row steps from the chunk's start, whatever the member,
    feature and node tiling and the rows staged per step, and its chunks
    are added in rank order: so the row chunking (``cs``,
    ``rows_per_chunk``) alone fixes its bits.  The wide plan keeps its own
    tiling and takes the K-member launch's chunking; its grid grows by the
    lanes instead of its chunks shrinking."""
    plan = level_plan(n, d, M, C, B, n_nodes, bits)
    if lanes == 1:
        return plan
    lane = level_plan(n, d, _check_lanes(M, lanes), C, B, n_nodes, bits)
    return plan._replace(cs=lane.cs, rows_per_chunk=lane.rows_per_chunk,
                         grid=plan.grid // plan.cs * lane.cs)


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


def _leaf_smem(C, g, n_mg, n_rw, LT, half, W):
    """Bytes of the warps' columns, the CTA's partial (one more set of
    columns per member group), the split tables, two chunks of packed
    words and a flag: the layout of ``csrc/hist.cu::leaf_sums``."""
    MT = n_mg * g
    RC = _LEAF_STEPS * n_rw * (32 // g)
    return 4 * (n_mg * (n_rw + 1) * LT * C * 32 + 2 * MT * half + 2 * RC * W + 1)


@functools.lru_cache(maxsize=1024)
def leaf_plan(n, M, C, leaves, half=0, W=0) -> LeafPlan:
    """CTA tiling of the leaf pass (``leaf_sums``) over ``leaves`` leaves,
    routed through split tables ``[M, half]`` over packed rows of ``W``
    words (``half = W = 0``: the ids are given); a function of the shapes
    only, so the summation order is too.  Lanes map to members (groups of
    32), and a warp takes ``32 // g`` rows at once when M is small.  A
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
    while (smem := _leaf_smem(C, g, n_mg, n_rw, LT, half, W)) > _MAX_SMEM:
        if n_rw > 1:
            n_rw //= 2
        elif n_mg > 1:
            n_mg //= 2
        elif LT > 1:
            LT = -(-LT // 2)
        else:
            raise ValueError(
                f"leaf pass needs {smem} bytes of shared memory (M={M}, "
                f"C={C}, leaves={leaves}, half={half}, W={W}); the card has "
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


def lane_leaf_plan(n, M, C, leaves, half=0, W=0, lanes=1) -> LeafPlan:
    """``leaf_plan`` of M = lanes * K members that sums each member's rows
    as a launch of K members does: the K-member plan itself.  A member's
    sum depends on its lane's row slots (``g``), the row warps
    (``n_rw``), the rows a CTA takes and the clusters, never on its place
    in the member tile, and a CTA loops over member tiles of
    ``n_mg * g`` members; so the wide launch runs the K-member grid with
    each CTA taking every lane's members in turn."""
    return leaf_plan(n, _check_lanes(M, lanes), C, leaves, half, W)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=1024)
def _checked_level_plan(n, d, M, C, B, n_nodes, W, bits, lanes) -> LevelPlan:
    """``lane_level_plan``, held once per shape against the kernel's own
    shared-memory layout."""
    plan = lane_level_plan(n, d, M, C, B, n_nodes, bits, lanes)
    if _library().se_level_smem_bytes(plan.g, plan.nf, plan.np, C, B, plan.rows, W, bits) != plan.smem:
        raise RuntimeError("level_plan and csrc/hist.cu disagree on the shared-memory layout")
    return plan


def _launch_level(nterms, words, node, vals, out, *, d, B, n_nodes, W, bits,
                  lanes):
    n, M, C = vals.shape
    if n == 0:
        return out.zero_()
    plan = _checked_level_plan(n, d, M, C, B, n_nodes, W, bits, lanes)
    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.se_level_hist(
            nterms, _ptr(words), _ptr(node), _ptr(vals), _ptr(out), n, d, M,
            C, B, n_nodes, W, bits, plan.g, plan.nf, plan.np, plan.cs,
            plan.rows, plan.rows_per_chunk, stream,
        )
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed: CUDA error {rc}")
    return out


@functools.lru_cache(maxsize=1024)
def _checked_route_plan(n, M, half, W) -> RoutePlan:
    """``route_plan``, held once per shape against the kernel's own
    shared-memory layout."""
    plan = route_plan(n, M, half, W)
    if _library().se_route_smem_bytes(M, half, W, plan.rows) != plan.smem:
        raise RuntimeError("route_plan and csrc/hist.cu disagree on the shared-memory layout")
    return plan


@functools.lru_cache(maxsize=1024)
def _checked_leaf_plan(n, M, C, leaves, half, W, lanes) -> LeafPlan:
    """``lane_leaf_plan``, held once per shape against the kernel's own
    shared-memory layout."""
    plan = lane_leaf_plan(n, M, C, leaves, half, W, lanes)
    if _library().se_leaf_smem_bytes(C, plan.g, plan.n_mg, plan.n_rw, plan.LT, half, W) != plan.smem:
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
    plan = _checked_leaf_plan(n, M, C, leaves, half, W, lanes)
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


def hist_level_pallas(Xb, node, vals, *, n_nodes: int, max_bins: int,
                      lanes: int = 1):
    """Level histogram ``H f32[M, n_nodes, C, d, B]`` for all members —
    the pallas tier (replaces ``ops/pallas_hist.py::_hist_kernel``).

    ``Xb i32[n, d]`` binned features; ``node i32[n, M]`` each row's node at
    this level per member; ``vals f32[n, M, C]`` statistic channels, split
    into bf16 hi + lo.  Zero rows contribute exactly 0.  ``lanes``: see
    the module docstring."""
    _check("Xb", Xb, torch.int32, 2)
    _check_stats(node, vals)
    _check_lanes(node.shape[1], lanes)
    if Xb.shape[0] != node.shape[0]:
        raise ValueError("Xb and node disagree on rows")
    dev = _device(Xb, node, vals)
    if dev.type == "cpu":
        return hist_plain(Xb, node, vals, n_nodes, max_bins, 2)
    n, d = Xb.shape
    _, M, C = vals.shape
    out = torch.empty((M, n_nodes, C, d, max_bins), dtype=torch.float32, device=dev)
    _launch_level(2, Xb, node, vals, out, d=d, B=max_bins, n_nodes=n_nodes,
                  W=d, bits=32, lanes=lanes)
    _count("hist_i32")
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
    if dev.type == "cpu":
        from spark_ensemble_tpu_torch.ops.binning import CompressedBins

        ids = unpack_bins(CompressedBins(packed, bits, num_features))
        return route_plain(ids, node, best_f, best_t)
    n, M = node.shape
    out = torch.empty_like(node)
    if out.numel() == 0:
        return out
    W = packed.shape[1]
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
    return out


def hist_level_packed(packed, node, vals, *, n_nodes: int, max_bins: int,
                      bits: int, num_features: int, lanes: int = 1):
    """Level histogram over packed bins with the fused tier's 3-term bf16
    split (the histogram half of ``ops/pallas_hist.py::_fused_kernel``);
    ``lanes``: see the module docstring."""
    _check_packed(packed, bits, num_features)
    _check_stats(node, vals)
    _check_lanes(node.shape[1], lanes)
    if packed.shape[0] != node.shape[0]:
        raise ValueError("packed and node disagree on rows")
    dev = _device(packed, node, vals)
    if dev.type == "cpu":
        from spark_ensemble_tpu_torch.ops.binning import CompressedBins

        ids = unpack_bins(CompressedBins(packed, bits, num_features))
        return hist_plain(ids, node, vals, n_nodes, max_bins, 3)
    _, M, C = vals.shape
    out = torch.empty((M, n_nodes, C, num_features, max_bins),
                      dtype=torch.float32, device=dev)
    _launch_level(3, packed, node, vals, out, d=num_features, B=max_bins,
                  n_nodes=n_nodes, W=packed.shape[1], bits=bits, lanes=lanes)
    _count("hist_packed")
    return out


def leaf_sums(node, vals, *, n_nodes: int, lanes: int = 1):
    """Exact f32 leaf statistics ``L[M, n_nodes, C]`` of this level's ids
    (the leaf mode of ``ops/pallas_hist.py::_fused_kernel`` without
    routing).  On the card, an id outside ``[0, n_nodes)`` adds to no
    leaf.  ``lanes``: see the module docstring."""
    _check_stats(node, vals)
    _check_lanes(node.shape[1], lanes)
    dev = _device(node, vals)
    if dev.type == "cpu":
        return leaf_plain(node, vals, n_nodes)
    _, M, C = vals.shape
    out = torch.empty((M, n_nodes, C), dtype=torch.float32, device=dev)
    if node.shape[0] == 0 or out.numel() == 0:
        return out.zero_()
    _launch_leaf(None, node, vals, None, None, None, out, leaves=n_nodes,
                 bits=0, d=0, lanes=lanes)
    _count("leaf_sums")
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
    if dev.type == "cpu":
        from spark_ensemble_tpu_torch.ops.binning import CompressedBins

        ids = unpack_bins(CompressedBins(packed, bits, num_features))
        leaf = route_plain(ids, node, best_f, best_t)
        return leaf_plain(leaf, vals, n_nodes), leaf
    _, M, C = vals.shape
    out = torch.empty((M, n_nodes, C), dtype=torch.float32, device=dev)
    node_out = torch.empty_like(node)
    if node.shape[0] == 0 or out.numel() == 0:
        return out.zero_(), node_out
    _launch_leaf(packed, node, vals, best_f, best_t, node_out, out,
                 leaves=n_nodes, bits=bits, d=num_features, lanes=lanes)
    _count("leaf_sums")
    return out, node_out


def fused_round_level(packed, node, vals, best_f=None, best_t=None, *,
                      n_nodes: int, max_bins: int, bits: int,
                      num_features: int, leaf: bool = False, lanes: int = 1):
    """One fused level -> ``(H, node_out)``, the counterpart of
    ``ops/pallas_hist.py::fused_round_level``: with split tables
    ``best_f/best_t i32[M, half]`` the PARENT-level ``node`` ids are routed
    first; then the level histogram ``H f32[M, n_nodes, C, d, B]`` (a route
    launch, then a histogram launch), or, when ``leaf``, the leaf sums
    ``[M, n_nodes, C]`` (one launch routes and sums).  ``lanes``: see the
    module docstring."""
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
                          num_features=num_features, lanes=lanes)
    return H, node
