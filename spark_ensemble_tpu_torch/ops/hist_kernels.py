"""Level-histogram kernels for the H100 and their plain PyTorch versions
(port of ``spark_ensemble_tpu/ops/pallas_hist.py``).

Two TPU kernels are replaced, both by ``csrc/hist.cu`` (CUDA C++ for
``sm_90a``, built with ``nvcc`` at first use and bound with ``ctypes``):

- ``_hist_kernel`` (``ops/pallas_hist.py:100``, the pallas tier) ->
  :func:`hist_level_pallas`: the level histogram over ``i32`` bins with the
  statistics split into bf16 hi + lo.
- ``_fused_kernel`` (``ops/pallas_hist.py:258``, the fused tier) ->
  :func:`fused_round_level`, split into a route launch
  (:func:`route_packed`), then the level histogram over packed words with
  a 3-term bf16 split (:func:`hist_level_packed`) or, in leaf mode, exact
  f32 leaf sums (:func:`leaf_sums`).

Both level histograms launch one kernel, ``level_hist`` (i32 bins are
32-bit words), tiled by :func:`level_plan`; the leaf sums keep their own
kernel and :func:`hist_plan`.

Every wrapper checks device, dtype, shape and contiguity, and raises on
anything the kernel does not take.  On CPU tensors it runs the plain
version; on CUDA tensors it launches the kernel on the current stream or
raises — it never falls back.  Each launch adds one to
``LAUNCHES[<kernel>]``.  The kernel source notes what bounds each kernel and
what its design does about it.

Precision: the kernel and its plain version split each row's statistic
into exactly the same bf16 terms and sum them in f32; only the order of
the sum differs.  Leaf sums are plain f32.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
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

# rows staged per step and the per-CTA shared-memory budget of the
# histogram tile (csrc/hist.cu); the tile plan depends on shapes only, so
# the summation order, and with it every bit of the result, is fixed by the
# shapes
_TILE_ROWS = 128
_HIST_SMEM_BUDGET = 32 * 1024
_MAX_SMEM = 227 * 1024
_TARGET_CTAS = 528
_SRC_NONE = 2

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


def reset_launch_counts() -> None:
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
    name is keyed on the source's hash, so an edit rebuilds."""
    src = _SOURCE.read_bytes()
    so = _BUILD_DIR / f"libse_hist_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_kernels()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.se_hist_level.argtypes = [I, I, P, P, P, P, P] + [I] * 13 + [P]
        lib.se_hist_level.restype = I
        lib.se_route_packed.argtypes = [P] * 5 + [I] * 5 + [P]
        lib.se_route_packed.restype = I
        lib.se_hist_smem_bytes.argtypes = [I] * 4
        lib.se_hist_smem_bytes.restype = ctypes.c_longlong
        lib.se_level_hist.argtypes = [I, P, P, P, P] + [I] * 14 + [P]
        lib.se_level_hist.restype = I
        lib.se_level_smem_bytes.argtypes = [I] * 8
        lib.se_level_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


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


class HistPlan(NamedTuple):
    nf: int  # features per CTA tile
    np: int  # nodes per CTA tile
    K: int  # threads per feature (each owns the keys == L mod K)
    chunks: int  # row chunks, summed in order by the reduce grid
    rows_per_chunk: int
    smem: int  # dynamic shared-memory bytes per CTA


def hist_plan(n, d, M, C, B, n_nodes) -> HistPlan:
    """CTA tiling of the leaf sums (``d = B = 1``); a function of the shapes
    only."""
    cell = C * B * 4  # bytes of one (node, feature) histogram row
    if n_nodes * cell <= _HIST_SMEM_BUDGET:
        np_ = n_nodes
        nf = max(1, min(d, _HIST_SMEM_BUDGET // (np_ * cell)))
    else:
        nf, np_ = 1, max(1, _HIST_SMEM_BUDGET // cell)
    K = min(128, 1 << (np_ - 1).bit_length())
    nf = min(nf, 1024 // K)
    smem = 4 * (np_ * C * nf * B + _TILE_ROWS * (1 + C + nf))
    if smem > _MAX_SMEM:
        raise ValueError(
            f"histogram tile needs {smem} bytes of shared memory "
            f"(C={C}, B={B}); the card has {_MAX_SMEM}"
        )
    base = M * math.ceil(d / nf) * math.ceil(n_nodes / np_)
    chunks = max(1, min(math.ceil(_TARGET_CTAS / base), math.ceil(n / _TILE_ROWS)))
    rows = math.ceil(n / chunks)
    return HistPlan(nf, np_, K, math.ceil(n / rows), rows, smem)


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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=1024)
def _checked_level_plan(n, d, M, C, B, n_nodes, W, bits) -> LevelPlan:
    """``level_plan``, held once per shape against the kernel's own
    shared-memory layout."""
    plan = level_plan(n, d, M, C, B, n_nodes, bits)
    if _library().se_level_smem_bytes(plan.g, plan.nf, plan.np, C, B, plan.rows, W, bits) != plan.smem:
        raise RuntimeError("level_plan and csrc/hist.cu disagree on the shared-memory layout")
    return plan


def _launch_level(nterms, words, node, vals, out, *, d, B, n_nodes, W, bits):
    n, M, C = vals.shape
    if n == 0:
        return out.zero_()
    plan = _checked_level_plan(n, d, M, C, B, n_nodes, W, bits)
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


def _launch_hist(src, nterms, bins, node, vals, out, *, d, B, n_nodes, W=0,
                 bits=0):
    n, M, C = vals.shape
    if n == 0:
        return out.zero_()
    plan = hist_plan(n, d, M, C, B, n_nodes)
    lib = _library()
    if lib.se_hist_smem_bytes(C, B, plan.nf, plan.np) != plan.smem:
        raise RuntimeError("hist_plan and csrc/hist.cu disagree on the shared-memory layout")
    scratch = (
        torch.empty(plan.chunks * out.numel(), dtype=torch.float32,
                    device=out.device)
        if plan.chunks > 1 else None
    )
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.se_hist_level(
            src, nterms, _ptr(bins), _ptr(node), _ptr(vals), _ptr(out),
            _ptr(scratch), n, d, M, C, B, n_nodes, W, bits, plan.nf,
            plan.np, plan.K, plan.chunks, plan.rows_per_chunk, stream,
        )
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed: CUDA error {rc}")
    return out


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


def hist_plain(ids, node, vals, n_nodes, B, nterms) -> torch.Tensor:
    """``H[M, n_nodes, C, d, B]`` by ``index_add_`` over the split terms."""
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
    H.index_add_(0, idx.reshape(-1), t[:, :, :, None].expand(n, M, C, d).reshape(-1))
    return H.reshape(M, n_nodes, C, d, B)


def route_plain(ids, node, best_f, best_t) -> torch.Tensor:
    """``2 * node + 1 - [bin at best_f <= best_t]``, integer-exact."""
    M = node.shape[1]
    m = torch.arange(M, device=node.device)[None, :]
    nl = node.long()
    b = ids.gather(1, best_f[m, nl].long())
    return (2 * node + 1 - (b <= best_t[m, nl]).to(torch.int32)).to(torch.int32)


def leaf_plain(node, vals, n_nodes) -> torch.Tensor:
    """``L[M, n_nodes, C]`` f32 sums by ``index_add_``."""
    n, M, C = vals.shape
    idx = torch.arange(M, device=vals.device)[None, :] * n_nodes + node.long()
    L = torch.zeros(M * n_nodes, C, dtype=torch.float32, device=vals.device)
    L.index_add_(0, idx.reshape(-1), vals.reshape(-1, C))
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


def hist_level_pallas(Xb, node, vals, *, n_nodes: int, max_bins: int):
    """Level histogram ``H f32[M, n_nodes, C, d, B]`` for all members —
    the pallas tier (replaces ``ops/pallas_hist.py::_hist_kernel``).

    ``Xb i32[n, d]`` binned features; ``node i32[n, M]`` each row's node at
    this level per member; ``vals f32[n, M, C]`` statistic channels, split
    into bf16 hi + lo.  Zero rows contribute exactly 0."""
    _check("Xb", Xb, torch.int32, 2)
    _check_stats(node, vals)
    if Xb.shape[0] != node.shape[0]:
        raise ValueError("Xb and node disagree on rows")
    dev = _device(Xb, node, vals)
    if dev.type == "cpu":
        return hist_plain(Xb, node, vals, n_nodes, max_bins, 2)
    n, d = Xb.shape
    _, M, C = vals.shape
    out = torch.empty((M, n_nodes, C, d, max_bins), dtype=torch.float32, device=dev)
    _launch_level(2, Xb, node, vals, out, d=d, B=max_bins, n_nodes=n_nodes,
                  W=d, bits=32)
    LAUNCHES["hist_i32"] += 1
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


def route_packed(packed, node, best_f, best_t, *, bits: int,
                 num_features: int):
    """Route every (row, member) one level down: ``2 * node + 1 -
    [bin(row, best_f[m, node]) <= best_t[m, node]]`` (the routing half of
    ``ops/pallas_hist.py::_fused_kernel``).  ``node`` holds the parent
    level's ids in ``[0, half)``; split tables are ``i32[M, half]``."""
    _check_packed(packed, bits, num_features)
    _check("node", node, torch.int32, 2)
    _check("best_f", best_f, torch.int32, 2)
    _check("best_t", best_t, torch.int32, 2)
    if best_f.shape != best_t.shape or best_f.shape[0] != node.shape[1]:
        raise ValueError("split tables must be [M, half] for node [n, M]")
    dev = _device(packed, node, best_f, best_t)
    if dev.type == "cpu":
        from spark_ensemble_tpu_torch.ops.binning import CompressedBins

        ids = unpack_bins(CompressedBins(packed, bits, num_features))
        return route_plain(ids, node, best_f, best_t)
    n, M = node.shape
    out = torch.empty_like(node)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.se_route_packed(
            _ptr(packed), _ptr(node), _ptr(best_f), _ptr(best_t), _ptr(out),
            n, M, best_f.shape[1], packed.shape[1], bits, stream,
        )
    if rc != 0:
        raise RuntimeError(f"route kernel launch failed: CUDA error {rc}")
    LAUNCHES["route_packed"] += 1
    return out


def hist_level_packed(packed, node, vals, *, n_nodes: int, max_bins: int,
                      bits: int, num_features: int):
    """Level histogram over packed bins with the fused tier's 3-term bf16
    split (the histogram half of ``ops/pallas_hist.py::_fused_kernel``)."""
    _check_packed(packed, bits, num_features)
    _check_stats(node, vals)
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
                  n_nodes=n_nodes, W=packed.shape[1], bits=bits)
    LAUNCHES["hist_packed"] += 1
    return out


def leaf_sums(node, vals, *, n_nodes: int):
    """Exact f32 leaf statistics ``L[M, n_nodes, C]`` (the leaf mode of
    ``ops/pallas_hist.py::_fused_kernel``)."""
    _check_stats(node, vals)
    dev = _device(node, vals)
    if dev.type == "cpu":
        return leaf_plain(node, vals, n_nodes)
    _, M, C = vals.shape
    out = torch.empty((M, n_nodes, C), dtype=torch.float32, device=dev)
    _launch_hist(_SRC_NONE, 1, None, node, vals, out, d=1, B=1,
                 n_nodes=n_nodes)
    LAUNCHES["leaf_sums"] += 1
    return out


def fused_round_level(packed, node, vals, best_f=None, best_t=None, *,
                      n_nodes: int, max_bins: int, bits: int,
                      num_features: int, leaf: bool = False):
    """One fused level -> ``(H, node_out)``, the counterpart of
    ``ops/pallas_hist.py::fused_round_level``: with split tables
    ``best_f/best_t i32[M, half]`` the PARENT-level ``node`` ids are routed
    first (one route launch); then the level histogram
    ``H f32[M, n_nodes, C, d, B]``, or the leaf sums ``[M, n_nodes, C]``
    when ``leaf``."""
    if best_f is not None:
        node = route_packed(packed, node, best_f, best_t, bits=bits,
                            num_features=num_features)
    if leaf:
        return leaf_sums(node, vals, n_nodes=n_nodes), node
    H = hist_level_packed(packed, node, vals, n_nodes=n_nodes,
                          max_bins=max_bins, bits=bits,
                          num_features=num_features)
    return H, node
