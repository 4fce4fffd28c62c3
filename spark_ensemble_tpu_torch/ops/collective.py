"""Cross-rank reductions of the SPMD fits (PyTorch port of
``ops/collective.py``).

The JAX package psums every base learner's sufficient statistics over the
mesh's data axis inside ``shard_map``: the XLA stand-in for Spark executors
combining per-partition statistics with ``treeAggregate``
(`GBMClassifier.scala:344-355`).  The port runs one process per device,
joined by ``torch.distributed``; an axis is an :class:`Axis`, the process
group of the ranks that share this rank's other mesh coordinates
(``parallel/mesh.py`` builds them).  ``None`` stands for an unsharded fit,
where every helper is the identity.

- :func:`preduce` all-gathers the per-rank tensors and sums them in rank
  order by :func:`pairwise_sum`, a fixed tree of elementwise adds.  It is
  not ``all_reduce``: a backend's ring or tree may add the ranks in any
  order, and the fit's split choices must come out bit-identical on every
  rank and every backend (the port's determinism rule).  It moves W times
  the bytes of an ``all_reduce``.
- :func:`pmax_reduce` and :func:`pmin_reduce` are exact in any order and
  use ``all_reduce`` with MAX / MIN.
- :func:`pgather` concatenates the ranks' blocks along a dimension (the
  class-dim blocks of the member axis).

The JAX package's ``pvary_like_shard`` and ``pzero_like_shard`` exist only
for shard_map's varying-axes type tracking and have no counterpart here.

Backends: NCCL carries CUDA tensors.  On gloo a CUDA tensor is staged
through host memory (gloo's collectives are host collectives); this is the
rule of the gloo backend, used when two ranks share one card, not a
fallback from NCCL.

Every gather adds to :func:`collective_stats` (``gathers``, ``bytes`` sent
by this rank); :func:`set_collective_timing` also times each one (CUDA
events on the card, the host clock on the CPU) into ``ms``.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist


class Axis:
    """One reduction axis of a mesh fit: the process ``group`` of ``ranks``
    (global ranks, in mesh order), this rank's ``index`` among them, the
    mesh axis ``names`` it spans and this rank's ``coords`` along each
    (the JAX package's ``axis_index``)."""

    def __init__(self, group, ranks: Sequence[int], names: Sequence[str],
                 coords: Optional[dict] = None):
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.names = tuple(names)
        self.coords = dict(coords or {})
        self.backend = str(dist.get_backend(group))

    def __repr__(self):
        return f"Axis({self.names}, ranks={self.ranks})"


_STATS = {"gathers": 0, "bytes": 0}
_TIMING = {"on": False, "events": [], "host_s": 0.0}


def collective_stats() -> dict:
    """``{"gathers", "bytes", "ms"}`` since the last reset; ``ms`` is the
    timed gathers' total (0.0 unless timing is on).  Reading synchronizes
    the timed CUDA events."""
    ms = _TIMING["host_s"] * 1e3
    for a, b in _TIMING["events"]:
        b.synchronize()
        ms += a.elapsed_time(b)
    return {"gathers": _STATS["gathers"], "bytes": _STATS["bytes"], "ms": ms}


def reset_collective_stats() -> None:
    _STATS["gathers"] = 0
    _STATS["bytes"] = 0
    _TIMING["events"] = []
    _TIMING["host_s"] = 0.0


def set_collective_timing(on: bool) -> None:
    """Time every gather from now on (``on``) or stop timing."""
    _TIMING["on"] = bool(on)


def pairwise_sum(terms: torch.Tensor) -> torch.Tensor:
    """``terms.sum(0)`` by a fixed pairwise tree of elementwise adds: term
    ``m`` with term ``m + half``, level by level, an odd last term carried
    up.  Every element takes the same adds in the same order whatever the
    trailing shape, so neither a reduction kernel's split of the leading
    axis nor a matmul's blocking can move its bits (CUDA's sum over a
    leading axis reorders when one row is left).  The one owner of that
    order: the GBM, Boosting and Bagging member sums and the cross-rank sum
    of :func:`preduce` all call it."""
    r = terms.shape[0]
    while r > 1:
        half = r // 2
        paired = terms[:half] + terms[half:2 * half]
        terms = torch.cat((paired, terms[2 * half:r])) if r % 2 else paired
        r = terms.shape[0]
    return terms[0]


def _staged(x: torch.Tensor, axis: Axis) -> bool:
    return axis.backend == "gloo" and x.is_cuda


def _timed(fn, x: torch.Tensor):
    if not _TIMING["on"]:
        return fn()
    if x.is_cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        _TIMING["events"].append((a, b))
        return out
    t0 = time.perf_counter()
    out = fn()
    _TIMING["host_s"] += time.perf_counter() - t0
    return out


def _all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ranks' copies of ``x`` stacked in rank order -> ``[W, *x.shape]``."""
    src = x.contiguous()
    _STATS["gathers"] += 1
    _STATS["bytes"] += src.numel() * src.element_size()

    def run():
        if _staged(src, axis):
            host = src.cpu()
            parts = [torch.empty_like(host) for _ in range(axis.size)]
            dist.all_gather(parts, host, group=axis.group)
            return torch.stack(parts).to(src.device)
        if axis.backend == "nccl":
            out = src.new_empty((axis.size,) + tuple(src.shape))
            dist.all_gather_into_tensor(out, src, group=axis.group)
            return out
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(parts, src, group=axis.group)
        return torch.stack(parts)

    return _timed(run, src)


def preduce(x, axis: Optional[Axis]):
    """The sum of ``x`` over ``axis``'s ranks, added in rank order by
    :func:`pairwise_sum` (bit-identical on every rank); identity when
    ``axis`` is None.  ``x`` may be a tensor or a list/tuple of tensors of
    one dtype, reduced in one gather."""
    if axis is None:
        return x
    if isinstance(x, (list, tuple)):
        flat = torch.cat([t.reshape(-1) for t in x])
        total = pairwise_sum(_all_gather(flat, axis))
        out, o = [], 0
        for t in x:
            out.append(total[o:o + t.numel()].reshape(t.shape))
            o += t.numel()
        return type(x)(out)
    return pairwise_sum(_all_gather(x, axis))


def _all_reduce(x, axis: Optional[Axis], op):
    if axis is None:
        return x
    t = x.detach().clone().contiguous()
    if _staged(t, axis):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=axis.group)
        return host.to(t.device)
    dist.all_reduce(t, op=op, group=axis.group)
    return t


def pmax_reduce(x, axis: Optional[Axis]):
    """The elementwise max of ``x`` over ``axis``'s ranks (exact in any
    order); identity when unsharded (Drucker boosting's distributed
    ``maxError``, `BoostingRegressor.scala:232-249`)."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def pmin_reduce(x, axis: Optional[Axis]):
    """The elementwise min over ``axis``'s ranks; identity when unsharded
    (brackets the sharded quantile, ``utils/quantile.py``)."""
    return _all_reduce(x, axis, dist.ReduceOp.MIN)


def pgather(x: torch.Tensor, axis: Optional[Axis], dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` in rank order
    (the JAX package's tiled ``all_gather``); identity when unsharded."""
    if axis is None:
        return x
    parts = _all_gather(x, axis)
    return torch.cat(list(parts.unbind(0)), dim=dim)
