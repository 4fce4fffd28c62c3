"""Elastic training plane: streaming fits whose shard sweeps span the ranks
of a mesh, and that survive losing a rank (PyTorch port of
``parallel/elastic.py``).

The shard manifest is partitioned round-robin over the mesh's row positions
(``data/partition.py``): row position ``w`` (this rank's
``mesh.row_index``) prefetches only shards ``w, w + W, w + 2W, ...``.  A
store handle that already covers them (a full open, or a subset that holds
them) is read as it is; otherwise the rank opens and hash-verifies just
those (``ShardStore.open(..., shards=...)``), so a caller that opens the
store with ``shards=[]`` (manifest and thresholds only) has each rank hash
only its own shards.  Everything else of
the fit (labels, weights, carried predictions, the node ids of the finished
trees) is whole on every rank, so each rank runs the resident round loop
and only the sweeps are distributed.  At step ``k`` position ``w`` computes
the histogram of shard ``k*W + w`` into a FRESH zero accumulator (``0 +
D_s``, which only turns ``-0`` into ``+0``), and the positions' per-step
contributions are reduced across the row axes before split selection:

- ``reduce="ordered"`` (default): one all-gather per step over the row axis
  (``ops/collective.py``), folded into the running accumulator in position
  order.  Position ``w`` holds shard ``k*W + w``, so the fold adds the
  shards in exactly the global order ``0..S-1``: the same f32 adds, in the
  same order, as the single-process sweep (``ops/tree.stream_forest``), and
  the fit is BIT-IDENTICAL to the single-process ``fit_streaming`` (and to
  the resident ``hist="stream"`` fit at matched chunk rows).  The running
  accumulator is never ``-0`` (``x + y`` is ``-0`` only when both are), so
  ``x + (+0) == x``.  Positions past the last shard send ``+0`` blocks, so
  every step issues the same collective whatever the shard count and width.
- ``reduce="psum"``: one ``all_reduce`` (SUM) per step: the backend orders
  the adds, so results are allclose to the single-process fit, not equal.

Every rank scores each level from the same reduced accumulator, so every
rank takes the same splits; after the leaf pass the node ids are gathered
(one all-gather), so every rank updates the whole prediction.  The sweep
runs the stream tier's chunk one-hot matmuls and launches none of the
hand-written kernels, as the JAX package's elastic sweep calls
``stream_level_step`` too.

Elasticity.  The sweep polls the chaos ``host_preempt`` hook at every step
boundary.  The verdict is a pure function of ``(seed, fault, site)``, so
every rank reaches it at the same site without talking, after the previous
step's collective has completed on every rank (gloo's collectives block; on
CUDA the sweep also synchronizes the device), so nothing is in flight.  The
victim raises :class:`~spark_ensemble_tpu_torch.robustness.chaos.
ChaosHostPreemption` and leaves; every survivor raises
:class:`HostLostError`.  :class:`ElasticCoordinator` catches it, builds the
survivors' mesh (:func:`survivor_mesh`) and re-enters the fit, which
repartitions the manifest over the new width (round-robin is a pure
function of ``(num_shards, W)``) and rewinds through the last committed
round checkpoint.  A streaming checkpoint holds no mesh component, so it
resumes at any width, and the ordered fold makes every round independent of
the width: the resumed fit is bit-identical to an uninterrupted one.

The survivors' rendezvous.  The port runs one process per device, so a
"host" is a rank.  After the verdict no survivor calls a collective on the
old groups: :func:`survivor_mesh` builds a :class:`~spark_ensemble_tpu_torch.
parallel.mesh.Mesh` over the surviving ranks whose groups are created with
``torch.distributed.new_group(..., use_local_synchronization=True)``, a
rendezvous of those ranks alone on the default group's store.  Survivor
``i`` in rank order takes row position ``i``.  The victim is never waited
for: it may exit, or stay parked and rejoin the default group's collectives
after the survivors are done (the tests' ranks do; they all meet at the next
world collective).  The store lives in the process that hosts it
(``multihost.store_host_rank``: rank 0 under ``tcp://`` and ``env://``,
torchrun's agent under torchrun).  If the victim hosts it, the survivors
cannot meet, and :func:`survivor_mesh` raises a ``RuntimeError`` at once
instead of waiting for a timeout.
"""

from __future__ import annotations

import itertools
import os
import time
import zlib
from typing import List, Tuple

import numpy as np
import torch

from spark_ensemble_tpu_torch.data.partition import (
    PartitionedShardReader,
    digest_words,
    manifest_digest,
    partition_shards,
    partition_steps,
)
from spark_ensemble_tpu_torch.data.shards import ShardStore
from spark_ensemble_tpu_torch.models.base import program_call
from spark_ensemble_tpu_torch.ops.binning import CompressedBins, unpack_bins
from spark_ensemble_tpu_torch.ops.collective import _all_gather, psum_reduce
from spark_ensemble_tpu_torch.ops.tree import (
    Tree,
    _empty_splits,
    stream_leaf_step,
    stream_leaf_values,
    stream_level_step,
    stream_level_update,
)
from spark_ensemble_tpu_torch.parallel import multihost
from spark_ensemble_tpu_torch.parallel.mesh import Mesh, mesh_sizes
from spark_ensemble_tpu_torch.robustness.chaos import ChaosHostPreemption
from spark_ensemble_tpu_torch.telemetry.events import global_metrics
from spark_ensemble_tpu_torch.telemetry.flight import dump_flight

REDUCE_MODES = ("ordered", "psum")


def preempt_flow_id(victim: int, site: str) -> int:
    """Trace-flow id tying a ``host_preempt`` span to the ``rewind`` span
    of the attempt that absorbs it.  Derived from ``(victim, site)``, which
    every rank knows, so every process holds the same id without talking
    (a pid-local ``trace.new_flow_id()`` would not stitch across
    streams)."""
    return zlib.crc32(f"host_preempt:{victim}:{site}".encode()) & 0x7FFFFFFF


#: flow id of the preemption this process acknowledges on its next
#: distributed attempt (set when raising, consumed by the next
#: DistributedSweep so its rewind span carries the matching flow_in)
_PENDING_REWIND_FLOW: List[int] = []


def consume_rewind_flow() -> int:
    """Pop the pending preemption flow id (0 when none): every
    ``DistributedSweep`` calls it, so a stale id never leaks into an
    unrelated fit."""
    if _PENDING_REWIND_FLOW:
        fid = _PENDING_REWIND_FLOW[-1]
        _PENDING_REWIND_FLOW.clear()
        return fid
    return 0


def _site_round(site: str) -> int:
    """The stream-round index of a sweep site
    (``"{family}:stream_round:{r}:..."``; -1 when absent), attached to the
    sweep spans so skew is attributed per round."""
    marker = "stream_round:"
    i = site.find(marker)
    if i < 0:
        return -1
    digits = ""
    for ch in site[i + len(marker):]:
        if not ch.isdigit():
            break
        digits += ch
    return int(digits) if digits else -1


#: env flag: synchronize around every reduce and accumulate its wall time
#: (``take_stats()["reduce_s"]``).  Off by default: the fences serialize
#: the sweep, a measurement mode, not a production mode
_MEASURE_ENV = "SE_TPU_DIST_MEASURE"


class HostLostError(Exception):
    """A peer rank was preempted mid-round.  Raised on SURVIVORS only (the
    victim gets ``ChaosHostPreemption``), after the last collective has
    completed on every rank, so catching it and re-entering the fit on the
    survivors' mesh is always safe.  ``victim`` is the lost global rank,
    ``t_verdict`` the ``time.perf_counter()`` of the verdict."""

    def __init__(self, victim: int, site: str):
        super().__init__(
            f"host {victim} preempted at {site}; rebuild the mesh from "
            "the survivors and re-enter the fit (ElasticCoordinator)"
        )
        self.victim = int(victim)
        self.site = site
        self.t_verdict = time.perf_counter()


def surviving_devices(mesh: Mesh, victim: int) -> List[int]:
    """The ranks of ``mesh`` that outlive rank ``victim``, in mesh order.
    One process drives one device, so a lost host is a lost rank and its
    device leaves with it."""
    out = [r for r in mesh.ranks if r != int(victim)]
    if not out:
        raise ValueError(f"no devices survive losing host {victim}")
    return out


def survivor_mesh(mesh: Mesh, victim: int) -> Mesh:
    """The mesh the fit resumes on after losing rank ``victim``: the
    surviving ranks re-laid as a plain ``("data", "member")`` mesh (the
    hybrid ``dcn_data`` axis is not rebuilt: survivor counts are rarely
    host-aligned).  Only the survivors call it, each with the same
    ``victim`` (see the module docstring for the rendezvous); losing the
    rank that hosts the store raises ``RuntimeError`` at once."""
    if int(victim) == multihost.store_host_rank():
        raise RuntimeError(
            f"rank {victim} hosted the process group's rendezvous store; "
            "the survivors cannot build a new group without it.  Restart "
            "the job from its checkpoints, or launch it under torchrun, "
            "whose agent hosts the store"
        )
    member = int(mesh.shape.get("member", 1))
    ranks = surviving_devices(mesh, victim)
    if len(ranks) % member:
        raise ValueError(
            f"{len(ranks)} surviving ranks do not fill member={member} blocks"
        )
    return Mesh({"data": len(ranks) // member, "member": member},
                device=mesh.device, ranks=ranks)


class DistributedSweep:
    """The distributed twin of ``data/streaming._ShardTrees``' sweep.

    Owns the mesh-wide state of one fit attempt: the manifest partition,
    this rank's shard subset, the per-step reduces, the node-id gather and
    the preemption seam.  ``data/streaming`` delegates its sweeps here when
    a fit is given a mesh."""

    def __init__(self, mesh: Mesh, store, *, reduce: str = "ordered",
                 telem=None):
        if reduce not in REDUCE_MODES:
            raise ValueError(f"reduce={reduce!r}; expected one of {REDUCE_MODES}")
        if int(mesh.shape.get("member", 1)) != 1:
            raise ValueError(
                "distributed streaming shards rows only; use member=1 "
                f"(got member={mesh.shape.get('member')})"
            )
        self.mesh = mesh
        self.reduce = reduce
        self.telem = telem
        #: the row axis spans every rank of the mesh (member is 1)
        self.axis = mesh.row_axis
        self.W = mesh_sizes(mesh)[0]
        self.position = int(mesh.row_index)
        self.S = int(store.num_shards)
        self.R = int(store.shard_rows)
        self.K = partition_steps(self.S, self.W)
        mine = partition_shards(self.S, self.W, self.position)
        # this rank reads only its own shards: through the caller's handle
        # where it covers them, else through a handle that verifies just them
        have = store.verified_shards
        self.store = (store if have is None or set(mine) <= have
                      else ShardStore.open(store.directory, shards=mine))
        self.rank = int(mesh.ranks[mesh.rank])
        #: "hosts" of the preemption fault: one per rank
        self.num_hosts = self.W
        self.device = mesh.device
        self.measure = os.environ.get(_MEASURE_ENV, "") == "1"
        self.reduce_s = 0.0
        self.sweep_s = 0.0
        self.steps = 0
        rewind_fid = consume_rewind_flow()
        if telem is not None:
            telem.emit(
                "dist_config", hosts=self.num_hosts, positions=self.W,
                steps=self.K, shards=self.S, reduce=reduce, process=self.rank,
            )
            if rewind_fid:
                # this attempt absorbs a preemption: an instant span whose
                # flow_in matches the victim's host_preempt flow_out
                telem.emit_span("rewind", time.time(), 0.0,
                                thread=f"host{self.rank}", flow_in=rewind_fid)

    # -- manifest agreement ------------------------------------------------

    def reader(self) -> PartitionedShardReader:
        """This rank's manifest slice as a prefetchable store (step-major;
        steps past the manifest's end read as zero blocks)."""
        return PartitionedShardReader(self.store, [self.position], self.W)

    def check_agreement(self) -> str:
        """All-gather every position's manifest digest and require them
        equal: ranks that disagree on the global row count or the bin
        thresholds fail loudly BEFORE any histogram math."""
        digest = manifest_digest(self.store)
        words = torch.from_numpy(digest_words(digest).view(np.int32).copy())
        every = _all_gather(words.to(self.device), self.axis).cpu()
        bad = [w for w in range(self.W) if not torch.equal(every[w], every[0])]
        if bad:
            raise ValueError(
                f"manifest digests disagree across the mesh at row "
                f"positions {bad}: hosts are not training on the same "
                "shard store (global n / thresholds mismatch)"
            )
        if self.telem is not None:
            self.telem.emit("dist_manifest_agreed", digest=digest[:16])
        return digest

    # -- the per-step reduce -----------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            # graftlint: ignore[unfenced-blocking-read] -- the measure mode's fence edges (reduce_s is timed around it) and the preemption drain of an abandoned fit
            torch.cuda.synchronize(self.device)

    def _reduce(self, acc, contrib):
        """Fold the W positions' contributions of one step into ``acc``:
        position order under ``ordered`` (bit-exact), one all_reduce
        under ``psum``."""
        if self.measure:
            self._sync()
            t0 = time.perf_counter()
        if self.reduce == "psum":
            acc.add_(psum_reduce(contrib, self.axis))
        else:
            gathered = _all_gather(contrib, self.axis)  # [W, ...] position order
            for w in range(self.W):
                acc.add_(gathered[w])
        if self.measure:
            self._sync()
            self.reduce_s += time.perf_counter() - t0
        self.steps += 1
        return acc

    def _gather_nodes(self, node_w):
        """Every position's node ids ``[K, R, M]`` -> the single-process
        ``node_all [S, R, M]`` layout (shard ``k*W + w`` at row ``k*W + w``;
        exact int copies)."""
        g = _all_gather(node_w, self.axis)  # [W, K, R, M]
        g = g.permute(1, 0, 2, 3).reshape((self.K * self.W,) + tuple(node_w.shape[1:]))
        return g[:self.S]

    # -- chaos seams --------------------------------------------------------

    def _maybe_preempt(self, ctl, site: str) -> None:
        """Chaos seam: the same verdict on every rank, drain, then the
        victim and the survivors raise.  Before raising, this is the
        flush-on-crash chokepoint: the telemetry stream is fsync'd and the
        flight recorder dumped (a preempted process may be killed the
        moment it leaves)."""
        hook = getattr(ctl, "host_preempt", None)
        if hook is None or not hook(site):
            return
        victim = int(self.axis.ranks[ctl.pick("host_preempt", site, self.num_hosts)])
        # drain: the previous step's collective completed on every rank;
        # the device's queue is emptied so nothing is left running
        self._sync()
        fid = preempt_flow_id(victim, site)
        if self.telem is not None:
            self.telem.emit("host_preempted", victim=victim, site=site)
            if victim == self.rank:
                # the flow's source is the victim's: a survivor's stream
                # carries the matching rewind flow_in
                self.telem.emit_span(
                    "host_preempt", time.time(), 0.0, thread=f"host{self.rank}",
                    flow_out=[fid], victim=victim, site=site,
                )
            self.telem.flush(fsync=True)
        _PENDING_REWIND_FLOW.clear()
        _PENDING_REWIND_FLOW.append(fid)
        dump_flight(
            reason="host_preempt",
            telemetry_path=getattr(self.telem, "_path", None),
            extra={"victim": victim, "site": site, "process_index": self.rank},
        )
        if victim == self.rank:
            raise ChaosHostPreemption(f"chaos: host {victim} preempted at {site}")
        raise HostLostError(victim, site)

    def _maybe_stall(self, ctl, site: str) -> None:
        """Straggler seam: the ``host_stall`` verdict is the same on every
        rank, and only the picked victim sleeps, dragging its sweep step."""
        hook = getattr(ctl, "host_stall_s", None)
        if hook is None:
            return
        seconds = hook(site)
        if seconds <= 0:
            return
        victim = int(self.axis.ranks[ctl.pick("host_stall", site, self.num_hosts)])
        if victim != self.rank:
            return  # peers saw the same draw; only the victim drags
        if self.telem is not None:
            self.telem.emit("host_stalled", victim=victim, site=site,
                            seconds=float(seconds))
        time.sleep(seconds)

    # -- the sweep ----------------------------------------------------------

    def sweep_forest(self, prefetch, ctl, site, vals_all, y_mean, feature_mask,
                     thresholds, *, rows, d, bits, max_depth, max_bins,
                     min_info_gain, triangular, round_bf16):
        """The distributed twin of ``ops/tree.stream_forest`` over the
        shard store: ``vals_all [S, R, M, C]`` the value channels of every
        shard (whole on every rank), ``rows[s]`` shard ``s``'s real rows ->
        ``(Tree [M, ...], node_all [S, R, M])``, bit-identical to the
        single-process sweep under ``reduce="ordered"``."""
        S, R, M, C = vals_all.shape
        B = max_bins
        dev = vals_all.device
        W, K, pos = self.W, self.K, self.position
        out = _empty_splits(M, 2**max_depth - 1, dev)
        parent_value = y_mean[:, None, :]
        tables = None
        node_w = torch.zeros((K, R, M), dtype=torch.int32, device=dev)
        thread = f"host{self.rank}"
        rnd = _site_round(site)

        def steps(tag, zero, step, program):
            """One pass: this position's shard of each step into a fresh
            zero block, reduced into the pass's accumulator.  Each step's
            contribution is one call of the JAX package's mesh program
            ``program`` (``models/base.program_call``)."""
            acc = torch.zeros_like(zero)
            it = prefetch.sweep()
            for k in range(K):
                step_site = f"{site}:{tag}:dist_step:{k}"
                self._maybe_stall(ctl, step_site)
                self._maybe_preempt(ctl, step_site)
                _, words = next(it)
                contrib = torch.zeros_like(zero)
                s = k * W + pos
                if s < S:  # past the manifest's end: an exact +0 block
                    r = rows[s]
                    xb = unpack_bins(CompressedBins(words[:r], bits, d))
                    with program_call(program, xb, vals_all[s, :r], tag):
                        contrib, node_w[k, :r] = step(contrib, xb, node_w[k, :r],
                                                      vals_all[s, :r])
                acc = self._reduce(acc, contrib)
            return acc

        for level in range(max_depth):
            t_lvl, t0 = time.time(), time.perf_counter()
            n_nodes = 2**level
            zero = torch.zeros((M, n_nodes, C, d, B), dtype=torch.float32, device=dev)
            H = steps(f"level:{level}", zero, lambda acc, xb, nd, vl: stream_level_step(
                acc, xb, nd, vl, n_nodes=n_nodes, tables=tables, max_bins=B),
                "dist_level_contrib")
            t1 = time.perf_counter()
            tables, parent_value = stream_level_update(
                H, feature_mask, min_info_gain, thresholds, B, triangular,
                round_bf16, level, parent_value, out,
            )
            self._span(f"dist_level_{level}", t_lvl, t0, t1, thread, rnd)
        t_lvl, t0 = time.time(), time.perf_counter()
        L = steps("leaf", torch.zeros((M, 2**max_depth, C), dtype=torch.float32, device=dev),
                  lambda acc, xb, nd, vl: stream_leaf_step(
                      acc, xb, nd, vl, num_leaves=2**max_depth, tables=tables),
                  "dist_leaf_contrib")
        t1 = time.perf_counter()
        node_all = self._gather_nodes(node_w)
        tree = Tree(
            *out[:3],
            leaf_value=stream_leaf_values(L[:, :, 0], L[:, :, 1:], parent_value, y_mean),
            split_gain=out[3],
        )
        self._span("dist_leaf", t_lvl, t0, t1, thread, rnd)
        return tree, node_all

    def _span(self, name, t_wall, t0, t1, thread, rnd):
        """One pass's span: ``steps_s`` the steps with their reduces,
        ``fetch_s`` the finish after the last reduce (the port scores on the
        device, with no host fetch; podview reads the pair as the JAX
        package's)."""
        dur = time.perf_counter() - t0
        self.sweep_s += dur
        if self.telem is not None:
            self.telem.emit_span(name, t_wall, dur, thread=thread, steps=self.K,
                                 steps_s=t1 - t0, fetch_s=dur - (t1 - t0),
                                 round=rnd)

    def take_stats(self) -> dict:
        """Cumulative sweep and reduce wall time (the reduce only under
        ``SE_TPU_DIST_MEASURE=1``) and the steps reduced; resets them."""
        out = {"sweep_s": self.sweep_s, "reduce_s": self.reduce_s,
               "steps": self.steps}
        self.sweep_s = self.reduce_s = 0.0
        self.steps = 0
        return out


#: stats of the most recent distributed fit in this process (the sweep
#: object lives and dies inside the fit call)
_LAST_FIT_STATS: dict = {}


def last_fit_stats() -> dict:
    return dict(_LAST_FIT_STATS)


def _record_fit_stats(dist: DistributedSweep) -> None:
    stats = dist.take_stats()
    _LAST_FIT_STATS.clear()
    _LAST_FIT_STATS.update(stats)
    if dist.telem is not None:
        dist.telem.emit(
            "dist_sweep", sweep_us=int(stats["sweep_s"] * 1e6),
            reduce_us=int(stats["reduce_s"] * 1e6), steps=stats["steps"],
        )


_COORD_SEQ = itertools.count()


class ElasticCoordinator:
    """Detect -> drain -> repartition -> rewind -> resume.

    Wraps a distributed ``fit_streaming`` call in the preemption-recovery
    loop: on :class:`HostLostError` the coordinator builds the survivors'
    mesh (:func:`survivor_mesh`) and re-enters the fit, which repartitions
    the manifest over the new width and rewinds through the estimator's
    last committed round checkpoint.  Give the estimator a
    ``checkpoint_dir`` (one per rank) or the "rewind" is a full replay from
    round 0 (still bit-identical, just slower).

    The victim does not keep training: it receives ``ChaosHostPreemption``
    (or a real SIGTERM) and leaves.  Past ``max_losses`` absorbed losses a
    survivor re-raises ``HostLostError``; it never continues quietly."""

    def __init__(self, mesh: Mesh, *, reduce: str = "ordered",
                 max_losses: int = 2):
        if reduce not in REDUCE_MODES:
            raise ValueError(f"reduce={reduce!r}; expected one of {REDUCE_MODES}")
        self.mesh = mesh
        self.reduce = reduce
        self.max_losses = int(max_losses)
        #: (victim, site, surviving width) per absorbed preemption
        self.losses: List[Tuple[int, str, int]] = []
        #: fit attempts entered (1 for an uninterrupted fit)
        self.attempts = 0
        #: ``time.perf_counter()`` of each absorbed loss's verdict
        self.verdicts: List[float] = []
        self._t0 = time.time()
        self._label = f"elastic:{os.getpid()}:{next(_COORD_SEQ)}"
        self._source_name = f"elastic/{self._label}"

    def statusz(self) -> dict:
        """Live coordinator state: the mesh, absorbed losses, attempts and
        the last distributed fit's sweep and reduce walls.  Registered as a
        ``global_metrics()`` source for the length of each
        ``fit_streaming`` call, so a mid-fit snapshot (and the flight
        recorder's dump) shows where the fit stands."""
        return {
            "label": self._label,
            "uptime_s": time.time() - self._t0,
            "reduce": self.reduce,
            "mesh_axes": dict(self.mesh.shape),
            "width": mesh_sizes(self.mesh)[0],
            "ranks": list(self.mesh.ranks),
            "process_index": multihost.process_index(),
            "process_count": multihost.process_count(),
            "attempts": self.attempts,
            "max_losses": self.max_losses,
            "losses": [{"victim": v, "site": s, "width": w}
                       for v, s, w in self.losses],
            "last_fit": last_fit_stats(),
        }

    def fit_streaming(self, est, store, y, **kw):
        """Run ``est.fit_streaming(store, y, mesh=..., reduce=...)`` to the
        end, absorbing up to ``max_losses`` lost ranks.  Returns the fitted
        model; ``self.mesh`` ends as the mesh the fit finished on."""
        metrics = global_metrics()
        metrics.register_source(self._source_name, self.statusz)
        # a stale flow left by an abandoned fit (a loss past max_losses
        # re-raises with the id pending) must not make this fit's first
        # attempt emit a phantom rewind
        consume_rewind_flow()
        try:
            while True:
                self.attempts += 1
                try:
                    return est.fit_streaming(store, y, mesh=self.mesh,
                                             reduce=self.reduce, **kw)
                except HostLostError as e:
                    if len(self.losses) >= self.max_losses:
                        raise
                    self.mesh = survivor_mesh(self.mesh, e.victim)
                    self.losses.append((e.victim, e.site, mesh_sizes(self.mesh)[0]))
                    self.verdicts.append(e.t_verdict)
        finally:
            metrics.unregister_source(self._source_name)
            consume_rewind_flow()  # never leak into a later fit
