"""Device meshes for the two parallel axes of a fit (PyTorch port of
``parallel/mesh.py``).

The reference's parallel axes are rows (RDD partitions over executors,
reduced with ``treeAggregate``) and ensemble members / class dims (driver
thread pools).  The JAX package maps them onto a ``("data", "member")``
``jax.sharding.Mesh``, or ``("dcn_data", "data", "member")`` across
slices; the port onto one process per device (``parallel/multihost.py``),
a :class:`Mesh` of ``torch.distributed`` process groups with the same axis
names.  Ranks fill the mesh in row-major order, as the
JAX package reshapes its device list.

Each rank keeps the contiguous block of rows that ``NamedSharding(mesh,
P("data"))`` (``P(("dcn_data", "data"))`` on the hybrid mesh) places on its
device: rows are padded with zero-weight rows to a multiple of the row
axes' size (:func:`pad_rows`) and rank ``r`` keeps block ``row_index``
(:func:`row_block`, :func:`shard_rows`, :func:`shard_ctx_rows` and
:func:`setup_row_sharding`, which stand in for the JAX package's
``shard_put``, ``shard_ctx_rows``, ``shard_fit_rows``,
``setup_row_sharding`` and ``shard_validation_rows``).
A mesh carries two reduction axes (``ops/collective.Axis``): ``row_axis``,
the ranks that hold the other row blocks of this rank's member block, and
``member_axis``, the ranks that hold the other member blocks of its rows
(None without a "member" axis).
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spark_ensemble_tpu_torch.ops.collective import Axis, pgather


def _default_device(device):
    if device is not None:
        return torch.device(device)
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans a torch.distributed process group: call "
            "parallel.multihost.initialize(...) first"
        )


class Mesh:
    """A mesh over the ranks of the default process group: ``axis_names``,
    ``shape`` (``{name: size}``), this rank's ``device``, its ``rank``
    within the mesh and mesh coordinates, the reduction axes ``row_axis``
    / ``member_axis``, ``all_axis`` (every rank of the mesh) and ``ranks``
    (the global ranks, in mesh order).  By default the mesh spans every
    rank and every rank builds it, collectively: ``all_axis`` is the
    default group and each row / member group is created on it.

    ``ranks=`` builds a mesh over a subset: the survivors of a lost rank
    (``parallel/elastic.survivor_mesh``).  Only those ranks build it, and
    each creates just the groups it belongs to with
    ``use_local_synchronization=True``, so a rank outside the subset is
    never waited for."""

    def __init__(self, axis_sizes: dict, device=None, ranks=None):
        _require_group()
        self.axis_names = tuple(axis_sizes.keys())
        self.shape = {k: int(v) for k, v in axis_sizes.items()}
        dims = tuple(self.shape.values())
        world = dist.get_world_size()
        local = ranks is not None
        self.ranks = tuple(range(world)) if not local else tuple(int(r) for r in ranks)
        if int(np.prod(dims)) != len(self.ranks):
            raise ValueError(
                f"mesh {axis_sizes} needs {int(np.prod(dims))} devices, "
                f"have {len(self.ranks)}"
            )
        if len(set(self.ranks)) != len(self.ranks) or not all(
                0 <= r < world for r in self.ranks):
            raise ValueError(f"mesh ranks {self.ranks} are not distinct ranks of {world}")
        if dist.get_rank() not in self.ranks:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh's ranks {self.ranks}")
        self.device = _default_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self._local = local
        self.rank = self.ranks.index(dist.get_rank())
        grid = np.asarray(self.ranks).reshape(dims)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, dims))))
        group = (dist.new_group(list(self.ranks), use_local_synchronization=True)
                 if local else dist.group.WORLD)
        self.all_axis = Axis(group, self.ranks, self.axis_names, coords=self.coords)
        self.row_axis = self.member_axis = None
        rows = mesh_row_axes(self) if "data" in self.shape else ()
        # on a full mesh every rank creates every group, in one order
        # (new_group is collective over the default group)
        if rows:
            self.row_axis = self._axis_groups(grid, rows)
        if "member" in self.shape:
            self.member_axis = self._axis_groups(grid, ("member",))
        self.row_index = 0
        for a in rows:
            self.row_index = self.row_index * self.shape[a] + self.coords[a]
        self.member_index = self.coords.get("member", 0)

    def _axis_groups(self, grid, names):
        """The groups along ``names`` (one per setting of the other axes)
        -> this rank's :class:`Axis`.  A line that spans the whole mesh
        reuses ``all_axis``'s group."""
        order = [self.axis_names.index(a) for a in names]
        rest = [i for i in range(grid.ndim) if i not in order]
        lines = np.transpose(grid, rest + order).reshape(-1, int(np.prod(
            [grid.shape[i] for i in order])))
        me = dist.get_rank()
        mine = None
        for line in lines:
            ranks = [int(r) for r in line]
            if tuple(ranks) == self.ranks:
                group = self.all_axis.group
            elif self._local:
                if me not in ranks:
                    continue
                group = dist.new_group(ranks, use_local_synchronization=True)
            else:
                group = dist.new_group(ranks)
            if me in ranks:
                mine = Axis(group, ranks, names,
                            coords={a: self.coords[a] for a in names})
        return mine

    def __repr__(self):
        extra = "" if not self._local else f", ranks={self.ranks}"
        return f"Mesh({self.shape}, device={self.device}{extra})"


def create_mesh(axis_sizes: dict, device=None, ranks=None) -> Mesh:
    """Mesh from ``{axis_name: size}``; sizes must multiply to the world
    (to ``len(ranks)`` over a subset of ranks, see :class:`Mesh`)."""
    return Mesh(dict(axis_sizes), device=device, ranks=ranks)


def data_member_mesh(n_devices: Optional[int] = None, member: int = 1,
                     device=None) -> Mesh:
    """The standard ("data", "member") mesh; ``member`` divides the count,
    which must be the world size."""
    n = n_devices or dist.get_world_size()
    if n % member != 0:
        raise ValueError(f"member axis {member} must divide device count {n}")
    return create_mesh({"data": n // member, "member": member}, device=device)


def hybrid_data_member_mesh(dcn_data=1, member: int = 1, device=None) -> Mesh:
    """The multi-host mesh ``("dcn_data", "data", "member")``: rows over
    both data axes (``dcn_data`` across hosts), members within a host.
    ``dcn_data="auto"`` takes the host count (``multihost.slice_count``).
    Ranks fill it in row-major order: torchrun numbers ranks host by host,
    so each ``dcn_data`` index is one host's ranks."""
    _require_group()
    n = dist.get_world_size()
    if dcn_data == "auto":
        from spark_ensemble_tpu_torch.parallel.multihost import slice_count

        dcn_data = slice_count()
    dcn_data = int(dcn_data)
    if n % (dcn_data * member) != 0:
        raise ValueError(
            f"dcn_data={dcn_data} * member={member} must divide {n} devices"
        )
    return create_mesh(
        {"dcn_data": dcn_data, "data": n // (dcn_data * member), "member": member},
        device=device,
    )


def pad_to_multiple(x, multiple: int, axis: int = 0, fill=0.0):
    """Pad ``axis`` so it divides ``multiple`` -> ``(padded, n)``.  Padding
    rows get weight 0 downstream, so statistics are unchanged."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = rem
        return torch.cat([x, x.new_full(shape, fill)], dim=axis), n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width, constant_values=fill), n


def pad_rows(arr, n_pad: int):
    """Zero-pad axis 0 to ``n_pad`` rows."""
    rem = n_pad - arr.shape[0]
    if rem == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros((rem,) + tuple(arr.shape[1:]))])
    return np.pad(arr, [(0, rem)] + [(0, 0)] * (arr.ndim - 1))


def mesh_row_axes(mesh: Mesh):
    """The axes rows shard over: ("dcn_data", "data") on the hybrid mesh,
    else ("data",)."""
    if "dcn_data" in mesh.axis_names:
        return ("dcn_data", "data")
    return ("data",)


def mesh_sizes(mesh: Mesh):
    """``(row ranks, member ranks)``; raises without a "data" axis."""
    if "data" not in mesh.axis_names:
        raise ValueError(f"mesh must have a 'data' axis; got axes {mesh.axis_names}")
    data = 1
    for a in mesh_row_axes(mesh):
        data *= int(mesh.shape[a])
    return data, int(mesh.shape.get("member", 1))


def mesh_row_spec(mesh: Mesh):
    """The row axes as the JAX package's PartitionSpec entry names them: the
    string "data", or the ("dcn_data", "data") tuple."""
    axes = mesh_row_axes(mesh)
    return axes if len(axes) > 1 else "data"


def row_block(mesh: Mesh, n: int):
    """``(n_pad, lo, hi)``: ``n`` rows padded to a multiple of the row
    ranks, and this rank's block ``[lo, hi)`` of them."""
    data_size, _ = mesh_sizes(mesh)
    n_pad = n + (-n) % data_size
    per = n_pad // data_size
    return n_pad, mesh.row_index * per, (mesh.row_index + 1) * per


def shard_rows(mesh: Mesh, x, n: int, dim: int = 0):
    """This rank's block of ``x``'s ``n`` rows along ``dim`` (zero padding
    included), as ``NamedSharding(mesh, P(row axes))`` places it."""
    n_pad, lo, hi = row_block(mesh, n)
    if dim == 0:
        return pad_rows(x, n_pad)[lo:hi]
    return pad_rows(x.movedim(dim, 0), n_pad)[lo:hi].movedim(0, dim)


def pad_ctx_rows(ctx, base, n_pad: int):
    """The fit ctx with every row-indexed leaf (``base.ctx_row_leaves``, the
    JAX package's ``ctx_specs``) zero-padded to ``n_pad`` rows."""
    return _map2(lambda leaf, rows: pad_rows(leaf, n_pad) if rows else leaf,
                 ctx, base.ctx_row_leaves(ctx))


def shard_ctx_rows(mesh: Mesh, base, ctx, n: int):
    """The fit ctx with every row-indexed leaf padded and cut to this
    rank's block; the rest stays whole."""
    n_pad, lo, hi = row_block(mesh, n)
    return _map2(lambda leaf, rows: leaf[lo:hi] if rows else leaf,
                 pad_ctx_rows(ctx, base, n_pad), base.ctx_row_leaves(ctx))


def setup_row_sharding(mesh: Mesh, base, ctx, X, n: int, row_vectors=()):
    """The row-sharding preamble of every mesh fit: this rank's block of
    the fit ctx, of ``X`` and of each per-row vector (labels, weights,
    validity masks), zero padding included -> ``(ctx, X, row_axis, n_pad,
    vectors)``."""
    n_pad, _, _ = row_block(mesh, n)
    return (shard_ctx_rows(mesh, base, ctx, n), shard_rows(mesh, X, n),
            mesh.row_axis, n_pad, tuple(shard_rows(mesh, v, n) for v in row_vectors))


class CheckpointBlocks:
    """The per-row carry of a checkpoint under a mesh (GBM's ``pred`` and
    ``pred_val``, Boosting's ``bw``).  A checkpoint holds the global,
    zero-padded arrays ([n_pad, ...], [nv_pad, ...]): the save gathers every
    rank's block over the row axis in rank order, and a resume takes this
    rank's block back out.  ``n_pad``
    and ``nv_pad`` enter the fingerprint, so a checkpoint padded for
    another row count starts a fresh fit instead of a wrong-length carry;
    without a mesh they are ``n`` and ``nv``, so a single-device checkpoint
    resumes under a mesh whose padding matches.  ``axis`` (every rank of
    the mesh, or of a distributed shard sweep's ``trees``) is where the
    ranks agree on the resume; a streaming fit's carry is whole on every
    rank, so its checkpoint has no mesh component at all and an elastic
    rewind resumes at another width."""

    def __init__(self, mesh, n, nv=0, trees=None):
        self.mesh = mesh
        self.n, self.nv = n, nv
        self.n_pad, self.nv_pad = n, nv
        self.axis = getattr(trees, "agree_axis", None)
        if mesh is not None:
            self.n_pad = row_block(mesh, n)[0]
            self.nv_pad = row_block(mesh, nv)[0] if nv else 0
            self.axis = mesh.all_axis

    def whole(self, t):
        """The global padded array of this rank's block (a collective over
        the row axis; identity without a mesh)."""
        if t is None or self.mesh is None:
            return t
        return pgather(t, self.mesh.row_axis, dim=0)

    def own(self, t, val=False):
        """This rank's block of a checkpoint's global padded array."""
        if self.mesh is None:
            return t
        _, lo, hi = row_block(self.mesh, self.nv if val else self.n)
        return t[lo:hi]


def _map2(fn, tree, flags):
    """``fn(leaf, flag)`` over a ctx and its row-leaf flags (same shape;
    non-tensor leaves such as ``num_classes``, and a None ctx, pass
    through)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], flags[k]) for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map2(fn, t, f) for t, f in zip(tree, flags))
    if isinstance(tree, torch.Tensor):
        return fn(tree, flags)
    return tree


def params_digest(params) -> str:
    """sha256 of a params tree's tensors (dtype, shape and bytes, in
    ``tree_map`` order): equal digests mean bit-identical params."""
    from spark_ensemble_tpu_torch.models.base import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(params):
        if isinstance(t, torch.Tensor):
            a = t.detach().cpu().contiguous().reshape(-1)
            h.update(f"{a.dtype}{tuple(t.shape)}".encode())
            h.update(a.view(torch.uint8).numpy().tobytes())
        elif t is not None:
            a = np.ascontiguousarray(np.asarray(t))
            h.update(f"{a.dtype}{a.shape}".encode() + a.tobytes())
    return h.hexdigest()


def replica_digests(model) -> list:
    """Every rank's :func:`params_digest` of its fitted ``model``, in rank
    order (a collective: every rank calls it).  A mesh fit returns the same
    model on every rank, so the list holds one value."""
    mine = params_digest(model.params)
    if not dist.is_initialized():
        return [mine]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out
