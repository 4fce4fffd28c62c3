"""Out-of-core data plane (PyTorch port of ``data/``): bit-packed shard
stores and streaming fits.

``write_shards`` seals a binned, bit-packed dataset into a sha256-
manifested shard directory (the JAX package's format, so a store written
by either package opens in the other); ``ShardStore`` is the verified
read handle; ``ShardPrefetcher`` streams shards ahead of the device; the
``fit_streaming`` methods on ``GBMRegressor`` / ``GBMClassifier``
(``models/gbm.py``) train over a store without ever holding the bin
matrix on the device at once, bit-identically to a resident
``hist="stream"`` fit at matched chunk rows.
"""

from spark_ensemble_tpu_torch.data.partition import (
    PartitionedShardReader,
    ShardPartition,
    manifest_digest,
    partition_shards,
)
from spark_ensemble_tpu_torch.data.prefetch import (
    DEFAULT_PREFETCH_DEPTH,
    ShardLoadError,
    ShardPrefetcher,
)
from spark_ensemble_tpu_torch.data.shards import (
    DEFAULT_SHARD_ROWS,
    SHARD_FORMAT,
    ShardStore,
    write_shards,
)

__all__ = [
    "DEFAULT_PREFETCH_DEPTH",
    "DEFAULT_SHARD_ROWS",
    "PartitionedShardReader",
    "SHARD_FORMAT",
    "ShardLoadError",
    "ShardPartition",
    "ShardPrefetcher",
    "ShardStore",
    "manifest_digest",
    "partition_shards",
    "write_shards",
]
