"""Vertex partition (the graph engine's shard rule).

Counterpart of the numpy half of ``repro.dist.sharding``; the logical-axis
``ShardingRules`` belong to the LM scaffolding and are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class VertexPartition(NamedTuple):
    """Contiguous-range partition of ``num_vertices`` over ``num_shards``.

    Disjoint and covering by construction; deterministic (a pure function
    of the two sizes); padded tail = divisibility fallback.
    """
    num_shards: int
    vs: int  # vertices per shard (ceil division)
    num_vertices: int  # real (unpadded) vertex count

    @property
    def padded_vertices(self) -> int:
        return self.num_shards * self.vs

    def shard_of(self, vertex_ids):
        return vertex_ids // self.vs

    def local_of(self, vertex_ids):
        return vertex_ids % self.vs

    def ranges(self) -> np.ndarray:
        """[P, 2] (lo, hi) global-id range per shard (hi exclusive, real)."""
        lo = np.arange(self.num_shards, dtype=np.int64) * self.vs
        hi = np.minimum(lo + self.vs, self.num_vertices)
        return np.stack([lo, np.maximum(hi, lo)], axis=1)

    def locate(self, vertex_ids) -> tuple[np.ndarray, np.ndarray]:
        """Batched (shard, local-slot) resolution with bounds checking —
        the point-query path (serve/store.py) resolves every lookup
        through here so queries and the engine can never disagree on
        ownership."""
        ids = np.asarray(vertex_ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_vertices):
            bad = ids[(ids < 0) | (ids >= self.num_vertices)]
            raise IndexError(
                f"vertex ids out of range [0, {self.num_vertices}): "
                f"{bad[:8].tolist()}")
        return ids // self.vs, ids % self.vs


def vertex_partition(num_vertices: int, num_shards: int) -> VertexPartition:
    if num_vertices <= 0 or num_shards <= 0:
        raise ValueError(f"need positive sizes, got num_vertices="
                         f"{num_vertices}, num_shards={num_shards}")
    vs = -(-num_vertices // num_shards)
    return VertexPartition(num_shards, vs, num_vertices)
