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
- :func:`psum_reduce` is one ``all_reduce`` (SUM), for the elastic shard
  sweep's ``reduce="psum"`` mode, which trades bit-identity for bytes.
- :func:`gather_objects` all-gathers picklable objects (fitted models as
  :func:`model_bytes`: Stacking's members and a sharded sweep's lanes).

The JAX package's ``pvary_like_shard`` and ``pzero_like_shard`` exist only
for shard_map's varying-axes type tracking and have no counterpart here.

Backends: NCCL carries CUDA tensors.  On gloo a CUDA tensor is staged
through host memory (gloo's collectives are host collectives); this is the
rule of the gloo backend, used when two ranks share one card, not a
fallback from NCCL.

Every gather adds to :func:`collective_stats` (``gathers``, ``bytes`` sent
by this rank); :func:`set_collective_timing` also times each one (CUDA
events on the card, the host clock on the CPU) into ``ms``.
:func:`observe_axes` hands every collective's :class:`Axis` to a callback
(the contracts' check that a mesh fit reduces only over its mesh's axes).
"""

from __future__ import annotations

import contextlib
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


_STATS = {"gathers": 0, "reduces": 0, "bytes": 0}
_AXIS_OBSERVERS: list = []


@contextlib.contextmanager
def observe_axes(callback):
    """Call ``callback(axis)`` with the :class:`Axis` of every collective
    this process runs in the scope."""
    _AXIS_OBSERVERS.append(callback)
    try:
        yield
    finally:
        _AXIS_OBSERVERS.remove(callback)


def _observe(axis: Axis) -> None:
    for cb in list(_AXIS_OBSERVERS):
        cb(axis)
_TIMING = {"on": False, "events": [], "host_s": 0.0}


def collective_stats() -> dict:
    """``{"gathers", "reduces", "bytes", "ms"}`` since the last reset;
    ``ms`` is the timed collectives' total (0.0 unless timing is on).
    Reading synchronizes the timed CUDA events."""
    ms = _TIMING["host_s"] * 1e3
    for a, b in _TIMING["events"]:
        b.synchronize()  # graftlint: ignore[unfenced-blocking-read] -- the stats read is the measurement: it waits for the timed gathers' end events, after the fit
        ms += a.elapsed_time(b)
    return {"gathers": _STATS["gathers"], "reduces": _STATS["reduces"],
            "bytes": _STATS["bytes"], "ms": ms}


def reset_collective_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0
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
    _observe(axis)
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
    _observe(axis)
    t = x.detach().clone().contiguous()
    if _staged(t, axis):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=axis.group)
        return host.to(t.device)
    dist.all_reduce(t, op=op, group=axis.group)
    return t


def psum_reduce(x, axis: Optional[Axis]):
    """The sum of ``x`` over ``axis``'s ranks in ONE ``all_reduce`` (SUM):
    the backend picks the order of the adds, so the result is allclose to
    :func:`preduce`'s, not bit-equal (the elastic sweep's
    ``reduce="psum"``); identity when unsharded.  Counted in
    :func:`collective_stats` as ``reduces``."""
    if axis is None:
        return x
    _STATS["reduces"] += 1
    _STATS["bytes"] += x.numel() * x.element_size()
    return _timed(lambda: _all_reduce(x, axis, dist.ReduceOp.SUM), x)


def gather_objects(obj, axis: Optional[Axis]) -> list:
    """Every rank's picklable ``obj`` over ``axis``, in rank order (a list
    of one without an axis).  Fitted models travel as
    :func:`model_bytes`."""
    if axis is None:
        return [obj]
    _observe(axis)
    out = [None] * axis.size
    dist.all_gather_object(out, obj, group=axis.group)
    return out


def model_bytes(model) -> bytes:
    """A fitted model as bytes (``torch.save``: tensors keep their bits)."""
    import io

    buf = io.BytesIO()
    torch.save(model, buf)
    return buf.getvalue()


def model_from_bytes(blob: bytes, device):
    """The model of :func:`model_bytes`, every tensor on ``device``."""
    import io

    return torch.load(io.BytesIO(blob), map_location=device, weights_only=False)


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
