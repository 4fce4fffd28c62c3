"""Distribution over ``torch.distributed``: one process per device, meshes
with the JAX package's axis names, and the rows each rank keeps
(``parallel/mesh.py``, ``parallel/multihost.py``).  ``DistributedSweep``,
``ElasticCoordinator``, ``HostLostError`` and ``survivor_mesh``
(``parallel/elastic.py``) wait in ROADMAP queue 1, item 29."""

from spark_ensemble_tpu_torch.parallel import multihost
from spark_ensemble_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    data_member_mesh,
    hybrid_data_member_mesh,
)
from spark_ensemble_tpu_torch.parallel.multihost import slice_count

__all__ = [
    "Mesh",
    "create_mesh",
    "data_member_mesh",
    "hybrid_data_member_mesh",
    "multihost",
    "slice_count",
]
