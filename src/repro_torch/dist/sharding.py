"""Sharding rules, the rank mesh, and the vertex partition (the counterpart
of ``repro.dist.sharding``).

Two partitioning problems share one module because they share one contract
(every element owned by exactly one shard, resolution is a pure function of
the inputs, fall back to replication/padding when sizes don't divide):

  * **parameters/activations** — :class:`ShardingRules` maps *logical* axis
    names ("batch", "mlp", "kv_heads", ...) to mesh axes, enforcing
    (a) divisibility: a dimension is only sharded if the mesh-axis product
    divides it, and (b) single use: a mesh axis consumed by an earlier
    dimension of the same tensor is unavailable to later ones.  Fallbacks
    are logged (tag, logical axis, dim, chosen, reason).  ``resolve``
    returns the spec as a plain tuple, one entry a dimension: ``None``, a
    mesh axis name, or a tuple of names (``tuple(P(...))`` of the
    reference).
  * **vertices** — :func:`vertex_partition` is the single source of truth
    for the graph engine's contiguous-range partition: vertex ``v`` lives
    on shard ``v // vs`` at local slot ``v % vs``, with the last shard
    padded (the divisibility fallback for ``n % P != 0``).

**The mesh.**  The reference lays a ``jax.sharding.Mesh`` over devices and
lets GSPMD partition global arrays.  The port has no GSPMD: a
:class:`Mesh` is one rank's view of a ``torch.distributed`` world laid
out row-major over named axes (``.shape``, axis name -> size in order, as
the JAX ``Mesh``'s), this rank's coordinates, and one process group per
set of axes (:meth:`Mesh.group`).  Under a mesh each rank already holds
its local block of every array, so :func:`shard` is the identity here;
code that needs a collective (``models/moe_a2a.py``) calls it over the
mesh's groups.  A mesh with no groups (``Mesh(shape)``) serves
``resolve``, which reads only the shape.

Layer contract: this module sits in ``repro_torch.dist``, below
``repro_torch.core`` and ``repro_torch.models``, and imports nothing from
the layers above it.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch.distributed as dist

# Default logical-axis -> candidate mesh-axes table.  Each logical name maps
# to a *preference list* of mesh-axis tuples; the first candidate that is
# present in the mesh, unused by earlier dims, and divides the dimension
# wins.  ``((),)`` means "always replicate".
Rules = dict[str, tuple[tuple[str, ...], ...]]
DEFAULT_RULES: Rules = {
    # data-parallel family
    "batch": (("pod", "data"),),
    "fsdp": (("pod", "data"),),        # ZeRO-3 param/optimizer sharding
    # model-parallel family (tensor axes)
    "seq": (("model",),),              # Megatron-SP activations
    "vocab": (("model",),),
    "mlp": (("model",),),
    "heads": (("model",),),
    "act_heads": (("model",),),
    "q_proj": (("model",),),
    "kv_proj": (("model",),),
    "kv_heads": (("model",),),
    "kv_seq": (("model",),),
    "experts": (("model",),),
    "ssm_heads": (("model",),),
    "ssm_inner": (("model",),),
    # always-replicated leaves
    "embed": ((),),
    "lora": ((),),
}


class ShardingRules:
    """Logical-axis resolver with divisibility fallback and fallback log."""

    def __init__(self, rules: Optional[Rules] = None,
                 log: Optional[list] = None):
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        # (tag, logical_axis, dim_size, chosen, reason) tuples
        self.log: list[tuple] = log if log is not None else []

    def override(self, **overrides) -> "ShardingRules":
        """New rules with per-logical-axis candidate lists replaced.

        Values are candidate lists (e.g. ``((),)`` to force replication).
        The fallback log is shared so callers can read one stream.
        """
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(rules=merged, log=self.log)

    def resolve(self, mesh, axes: Sequence[Optional[str]],
                shape: Sequence[int], tag: str = "") -> tuple:
        """(logical axes, shape) -> the spec on ``mesh``, a tuple of
        ``None`` / axis name / tuple of names, one a dimension.

        Guarantees: each mesh axis appears at most once in the result, and
        a dimension is only sharded when the mesh-axis product divides it.
        """
        assert len(axes) == len(shape), (tag, axes, shape)
        used: set[str] = set()
        entries: list = []
        for name, dim in zip(axes, shape):
            chosen: tuple[str, ...] = ()
            reason = ""
            if name:
                candidates = self.rules.get(name)
                if candidates is None:
                    reason = f"unknown logical axis {name!r}"
                    candidates = ()
                for cand in candidates:
                    if cand == ():  # replicate *by rule* — not a fallback
                        reason = ""
                        break
                    avail = tuple(a for a in cand
                                  if a in mesh.shape and a not in used)
                    if not avail:
                        reason = reason or f"{cand} unavailable/used"
                        continue
                    size = math.prod(mesh.shape[a] for a in avail)
                    if dim % size != 0:
                        reason = f"{dim} %% {avail}={size}"
                        continue
                    chosen = avail
                    reason = ""
                    break
                if not chosen and reason:
                    self.log.append((tag, name, dim, (), reason))
            if not chosen:
                entries.append(None)
            else:
                entries.append(chosen[0] if len(chosen) == 1 else chosen)
                used.update(chosen)
        return tuple(entries)


def block_shape(mesh, spec: Sequence, shape: Sequence[int]) -> tuple:
    """One rank's block of a ``shape`` laid out as ``spec`` (what
    ``resolve`` returns) on ``mesh``: each dimension divided by the
    product of its mesh axes (``NamedSharding.shard_shape``)."""
    out = []
    for entry, dim in zip(spec, shape):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(dim // math.prod(mesh.shape[a] for a in names))
    return tuple(out)


# ======================================================================
# The rank mesh
# ======================================================================
class Mesh:
    """One rank's view of a world laid out row-major over named axes.

    ``shape`` is axis name -> size in the reference ``Mesh``'s order;
    ``coords`` is the coordinate on each axis of ``rank``, this process's
    rank in the world.  ``groups`` maps each non-empty tuple of axis
    names (in mesh order) to the process group of the ranks that share
    this rank's coordinates on every other axis; group rank order is the
    row-major order of the named axes' coordinates, as a JAX collective
    over those axes orders its operands.  :meth:`build` makes them."""

    def __init__(self, shape: dict, rank: int = 0,
                 groups: Optional[dict] = None):
        self.shape = dict(shape)
        self.coords = {a: int(c) for a, c in zip(self.shape, np.unravel_index(
            rank, tuple(self.shape.values())))}
        self.groups = groups or {}

    @classmethod
    def build(cls, shape: dict, rank: int) -> Optional["Mesh"]:
        """The mesh of this rank in the initialised default process group,
        laid over its first ``prod(shape)`` ranks.  Every rank of the world
        calls it with the same ``shape``: each call creates every group, in
        the same order on every rank (``torch.distributed.new_group`` is
        collective); a rank past the mesh gets ``None``."""
        names = list(shape)
        sizes = tuple(shape.values())
        if dist.get_world_size() < math.prod(sizes):
            raise ValueError(f"mesh {shape} needs {math.prod(sizes)} ranks, "
                             f"the world has {dist.get_world_size()}")
        grid = np.arange(math.prod(sizes)).reshape(sizes)
        outside = rank >= grid.size
        mine = np.unravel_index(0 if outside else rank, sizes)
        groups = {}
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                free = [names.index(a) for a in axes]
                # every group of this axis set: one for each coordinate of
                # the other axes; this rank keeps the one it belongs to
                fixed = [i for i in range(len(names)) if i not in free]
                for other in itertools.product(*(range(sizes[i])
                                                 for i in fixed)):
                    idx: list = [slice(None)] * len(names)
                    for i, c in zip(fixed, other):
                        idx[i] = c
                    ranks = sorted(int(r) for r in grid[tuple(idx)].ravel())
                    group = dist.new_group(ranks)
                    if all(mine[i] == c for i, c in zip(fixed, other)):
                        groups[axes] = group
        return None if outside else cls(shape, rank, groups)

    def group(self, axes) -> Any:
        """The process group over ``axes`` (a name or a tuple of names)."""
        if isinstance(axes, str):
            axes = (axes,)
        key = tuple(a for a in self.shape if a in axes)
        if key not in self.groups:
            raise KeyError(f"no group over {axes} on mesh {self.shape}")
        return self.groups[key]

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (its position in
        :meth:`group`)."""
        if isinstance(axes, str):
            axes = (axes,)
        idx = 0
        for a in self.shape:
            if a in axes:
                idx = idx * self.shape[a] + self.coords[a]
        return idx


# ======================================================================
# Mesh + rules context (thread of execution scoped, nestable)
# ======================================================================
_CONTEXT: list[tuple[Any, ShardingRules]] = []


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[ShardingRules] = None):
    """Activate (mesh, rules) for ``shard``/``current_mesh`` in this block."""
    _CONTEXT.append((mesh, rules or ShardingRules()))
    try:
        yield
    finally:
        _CONTEXT.pop()


def current_mesh():
    return _CONTEXT[-1][0] if _CONTEXT else None


def current_rules() -> Optional[ShardingRules]:
    return _CONTEXT[-1][1] if _CONTEXT else None


def shard(x, *axes: Optional[str], tag: str = ""):
    """The reference's sharding constraint by logical axis names.  The
    identity in the port: under a mesh each rank already holds its local
    block (there is no GSPMD to constrain)."""
    return x


# ======================================================================
# Vertex partition (the graph engine's shard rule)
# ======================================================================
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
