"""Device meshes for the two parallel axes of a fit (PyTorch port of
``parallel/mesh.py``).

The reference's parallel axes are rows (RDD partitions over executors,
reduced with ``treeAggregate``) and ensemble members / class dims (driver
thread pools).  The JAX package maps them onto a ``("data", "member")``
``jax.sharding.Mesh``, or ``("dcn_data", "data", "member")`` across
slices; the port onto one process per device (``parallel/multihost.py``),
a :class:`Mesh` over ``torch.distributed.device_mesh.init_device_mesh``
with the same axis names.  Ranks fill the mesh in row-major order, as the
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

from spark_ensemble_tpu_torch.ops.collective import Axis


def _default_device(device):
    if device is not None:
        return torch.device(device)
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """A mesh over every rank of the default process group: ``axis_names``,
    ``shape`` (``{name: size}``), this rank's ``device`` and mesh
    coordinates, the reduction axes ``row_axis`` / ``member_axis`` and the
    torch ``device_mesh``.  Every rank builds it, collectively."""

    def __init__(self, axis_sizes: dict, device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh spans a torch.distributed process group: call "
                "parallel.multihost.initialize(...) first"
            )
        from torch.distributed.device_mesh import init_device_mesh

        self.axis_names = tuple(axis_sizes.keys())
        self.shape = {k: int(v) for k, v in axis_sizes.items()}
        dims = tuple(self.shape.values())
        world = dist.get_world_size()
        if int(np.prod(dims)) != world:
            raise ValueError(
                f"mesh {axis_sizes} needs {int(np.prod(dims))} devices, have {world}"
            )
        self.device = _default_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.device_mesh = init_device_mesh(
            self.device.type, dims, mesh_dim_names=self.axis_names
        )
        self.rank = dist.get_rank()
        grid = np.arange(world).reshape(dims)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, dims))))
        self.row_axis = self.member_axis = None
        rows = mesh_row_axes(self) if "data" in self.shape else ()
        # every rank creates every group, in one order (new_group is
        # collective over the default group)
        if rows:
            self.row_axis = self._axis_groups(grid, rows)
        if "member" in self.shape:
            self.member_axis = self._axis_groups(grid, ("member",))
        self.row_index = 0
        for a in rows:
            self.row_index = self.row_index * self.shape[a] + self.coords[a]
        self.member_index = self.coords.get("member", 0)

    def _axis_groups(self, grid, names):
        """The groups along ``names`` (one per setting of the other axes),
        created on every rank -> this rank's :class:`Axis`."""
        order = [self.axis_names.index(a) for a in names]
        rest = [i for i in range(grid.ndim) if i not in order]
        lines = np.transpose(grid, rest + order).reshape(-1, int(np.prod(
            [grid.shape[i] for i in order])))
        mine = None
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = Axis(group, ranks, names,
                            coords={a: self.coords[a] for a in names})
        return mine

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def create_mesh(axis_sizes: dict, device=None) -> Mesh:
    """Mesh from ``{axis_name: size}``; sizes must multiply to the world."""
    return Mesh(dict(axis_sizes), device=device)


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
