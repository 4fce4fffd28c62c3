"""Multi-process initialization: the connect-to-cluster step (PyTorch port
of ``parallel/multihost.py``).

The JAX package is single-controller per host: one process drives every
device of a ``Mesh``.  The port uses PyTorch's own idiom, one process per
device joined by ``torch.distributed``: every process calls
:func:`initialize` once, builds the same mesh (``parallel/mesh.py``) and
calls ``fit(X, y, mesh=mesh)`` with the same global arrays; each keeps its
own block of rows and every one returns the same fitted model.

Typical use (the same program in every process, e.g. under ``torchrun``):

    from spark_ensemble_tpu_torch.parallel import mesh, multihost

    multihost.initialize()                  # torchrun's environment
    m = mesh.data_member_mesh(member=1)     # one rank per device
    model = GBMClassifier(...).fit(X, y, mesh=m)

NCCL carries CUDA tensors; gloo serves ``device="cpu"`` (the tests' ranks)
and two ranks that share one card (``chip_smoke.py``), which build their
process group themselves.  A finite ``timeout`` makes a rank whose peer
died fail instead of hang.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

#: default time a collective may wait for its peers
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group (idempotent; a single process may skip it
    and build a one-rank mesh after a one-rank ``initialize``).

    ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` go together, or all three are omitted and torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` are read.
    ``device="cuda"`` joins over NCCL and selects ``cuda:{LOCAL_RANK}``
    (``rank % device_count`` without the variable); ``"cpu"`` over gloo."""
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit) and any(v is None for v in explicit):
        raise ValueError(
            "coordinator_address, num_processes, and process_id must be "
            "passed together (or all omitted for auto-detection)"
        )
    if dist.is_initialized():
        return
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
    if coordinator_address is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        rank, world = int(process_id), int(num_processes)
        addr = str(coordinator_address)
        init_method = addr if "://" in addr else f"tcp://{addr}"
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "multihost.initialize(device='cuda') needs CUDA; pass "
                "device='cpu' for a gloo group on the CPU"
            )
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo", init_method=init_method,
        world_size=world, rank=rank, timeout=timeout,
    )


def process_count() -> int:
    """Processes in the group (1 when not initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 when not initialized)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device_count() -> int:
    """Cards attached to this host (1 on a CPU-only host: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def slice_count() -> int:
    """The number of distinct hosts in the group: the port's slices, and the
    ``dcn_data`` size of ``mesh.hybrid_data_member_mesh(dcn_data="auto")``
    (the cross-host axis).  A collective when initialized: every rank
    calls it."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 1
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return max(len(set(names)), 1)
