"""Deterministic manifest partitioning: the multi-host shard layout (a
copy of the JAX package's numpy-only ``data/partition.py``; the port
imports nothing of that package).

A multi-host streaming fit assigns every shard of a sealed ``ShardStore``
to exactly one *row position* of the training mesh.  The assignment is
round-robin -- shard ``s`` belongs to position ``s % W`` at local step
``s // W`` -- and is a pure function of ``(num_shards, W)``, so every host
derives the same global layout from the manifest alone, with no
coordination traffic.  ``manifest_digest`` seals the agreement: hosts
compare the digest once per fit and refuse to train against diverging
manifests.

The round-robin layout is what makes a distributed sweep *ordered*: at
step ``k`` the mesh holds shards ``k*W .. k*W+W-1``, one per position, and
folding their contributions in position order is exactly the global shard
order ``0..S-1`` of the single-host sweep.  (The port's distributed sweep
is ROADMAP queue 1, item 18; this module is its layout.)

``PartitionedShardReader`` adapts a host's slice of the layout to the
``ShardPrefetcher`` duck-type (``num_shards`` / ``load_shard`` / ``n``),
yielding blocks in step-major order.  Steps past the end of the manifest
read as all-zero blocks: zero words unpack to bin-0 rows that every
consumer pairs with all-zero value channels, so ragged tails contribute
exactly ``0.0`` -- the same padding rule as ``ShardStore.load_shard``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def partition_shards(num_shards: int, num_parts: int, part: int) -> Tuple[int, ...]:
    """Shard indices owned by ``part`` of ``num_parts`` (round-robin).

    Deterministic and total: every shard in ``range(num_shards)`` lands
    in exactly one part.  A part may be empty when ``num_shards <
    num_parts`` — its positions then sweep only zero blocks.
    """
    if num_parts <= 0:
        raise ValueError(f"num_parts must be positive, got {num_parts}")
    if not 0 <= part < num_parts:
        raise ValueError(f"part {part} out of range for {num_parts} parts")
    return tuple(range(part, int(num_shards), num_parts))


def partition_steps(num_shards: int, num_parts: int) -> int:
    """Number of sweep steps ``K = ceil(num_shards / num_parts)`` — the
    global step count every position executes, full or not."""
    if num_parts <= 0:
        raise ValueError(f"num_parts must be positive, got {num_parts}")
    return max(1, -(-int(num_shards) // num_parts))


def manifest_digest(store) -> str:
    """sha256 hex digest of the store's canonical manifest.

    Covers the full geometry (``n``, ``d``, ``max_bins``, ``bits``,
    ``shard_rows``) plus every shard's and the thresholds file's own
    sha256 -- two stores share a digest iff they describe the same binned
    dataset byte-for-byte.  This is what hosts compare before a
    distributed fit: digest agreement implies agreement on the global
    row count and bin thresholds.  Both packages write the same manifest
    keys, so a store's digest is the same whichever package reads it.
    """
    canon = json.dumps(store._manifest, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def digest_words(digest: str) -> np.ndarray:
    """A sha256 hex digest as ``u32[8]`` — the wire form the agreement
    check all-gathers across the mesh (collectives move arrays, not
    strings)."""
    return np.frombuffer(bytes.fromhex(digest), dtype=np.uint32).copy()


@dataclass(frozen=True)
class ShardPartition:
    """One part's view of a partitioned manifest (pure metadata)."""

    part: int
    num_parts: int
    shards: Tuple[int, ...]
    total_shards: int
    n: int
    digest: str

    @classmethod
    def from_store(cls, store, num_parts: int, part: int) -> "ShardPartition":
        return cls(
            part=part,
            num_parts=num_parts,
            shards=partition_shards(store.num_shards, num_parts, part),
            total_shards=store.num_shards,
            n=store.n,
            digest=manifest_digest(store),
        )

    @property
    def steps(self) -> int:
        return partition_steps(self.total_shards, self.num_parts)


class PartitionedShardReader:
    """A host's slice of a partitioned store, as a prefetchable store.

    Duck-types the ``ShardStore`` surface ``ShardPrefetcher`` consumes
    (``num_shards``, ``load_shard``, ``n``).  ``positions`` are the mesh
    row positions this process owns (each one a part of the ``W``-way
    round-robin layout); blocks come out in step-major order — local
    index ``j`` maps to step ``k = j // P``, position ``positions[j % P]``
    and thus global shard ``k * W + positions[j % P]`` — which is exactly
    the order the distributed sweep feeds positions each step.  Global
    indices past the manifest end read as zero blocks (exact ``+0.0``
    contributions, see module docstring).
    """

    def __init__(self, store, positions: Sequence[int], num_parts: int):
        positions = tuple(int(p) for p in positions)
        if not positions:
            raise ValueError("PartitionedShardReader needs >= 1 position")
        for p in positions:
            if not 0 <= p < num_parts:
                raise ValueError(f"position {p} out of range for W={num_parts}")
        if len(set(positions)) != len(positions):
            raise ValueError(f"duplicate positions: {positions}")
        self.store = store
        self.positions = positions
        self.num_parts = int(num_parts)
        self.steps = partition_steps(store.num_shards, num_parts)
        #: local block count — K steps x P owned positions
        self.num_shards = self.steps * len(positions)
        #: resident-vector length: prefetch depth heuristics key on it
        self.n = store.n
        self.shard_rows = store.shard_rows
        self.words_per_row = store.words_per_row

    def global_index(self, j: int) -> int:
        """Local block ``j`` -> global shard index (may be >= the
        manifest's shard count for ragged-tail steps)."""
        k, i = divmod(int(j), len(self.positions))
        return k * self.num_parts + self.positions[i]

    def load_shard(self, j: int) -> np.ndarray:
        s = self.global_index(j)
        if s < self.store.num_shards:
            return self.store.load_shard(s)
        return np.zeros(
            (self.store.shard_rows, self.store.words_per_row), np.uint32
        )

    def local_partitions(self) -> List[ShardPartition]:
        """One ``ShardPartition`` per owned position — the metadata a
        multi-host fit logs when slices move between hosts."""
        return [
            ShardPartition.from_store(self.store, self.num_parts, p)
            for p in self.positions
        ]
