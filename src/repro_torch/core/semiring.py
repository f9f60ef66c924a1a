"""Aggregation semirings: the pluggable receive-side reduce contract.

Counterpart of ``repro.core.semiring``.  ASYMP's correctness (paper §3.3)
rests only on the receive-side reduce being commutative, associative and
idempotent, so that message order, duplication and replay leave the
fixpoint unchanged.  ``Aggregator`` makes that contract an object: the
engine's scatter and activation, the priority key, the wire codec's
rounding direction and the SpMV kernel's reduce all derive from it.

  * ``MIN`` — min-monotone programs (CC, SSSP, BFS);
  * ``MAX`` — max-monotone programs (widest-path, max-label propagation);
    payloads are non-negative, so the identity is ``-1`` / ``0.0``;
  * ``OR``  — boolean saturation (reachability): ``max`` over {0, 1};
  * ``SUM`` — scatter-add (the ``plus_times`` kernel form and push-mode
    pagerank).  Not idempotent: a duplicated or replayed message changes
    the sum, so its programs recover by a global checkpoint restore.

Every ``scatter`` and ``segment_reduce`` here works along the LAST axis
with any number of leading batch axes, so the engine scatters all shards
at once (``[P, vs]``).  Index rows at or past the end are dropped, as
JAX's ``mode="drop"`` drops them: torch raises on such indices, so the
scatter goes into a buffer one slot wider and the slot is cut off.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

INT_INF = 2 ** 31 - 1  # int32 max: the MIN identity for int payloads


def _scatter(reduce: str) -> Callable:
    def scatter(values: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
        n = values.shape[-1]
        buf = torch.cat([values, values[..., :1]], dim=-1)
        idx = torch.where((idx >= 0) & (idx < n), idx, n).to(torch.int64)
        buf.scatter_reduce_(-1, idx, vals.to(values.dtype), reduce=reduce,
                            include_self=True)
        return buf[..., :n]
    return scatter


def _segment_reduce(reduce: str, empty: Callable) -> Callable:
    """``segment_reduce(data [N, ...], segment_ids [N], num_segments)`` ->
    ``[num_segments, ...]``, empty segments filled as ``jax.ops.segment_*``
    fills them (the dtype's extreme for min/max, 0 for sum)."""
    def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
        out = torch.full((num_segments + 1,) + tuple(data.shape[1:]),
                         empty(data.dtype), dtype=data.dtype,
                         device=data.device)
        seg = torch.where((segment_ids >= 0) & (segment_ids < num_segments),
                          segment_ids, num_segments).to(torch.int64)
        seg = seg.reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
        out.scatter_reduce_(0, seg, data, reduce=reduce, include_self=True)
        return out[:num_segments]
    return segment_reduce


def _dtype_max(dtype: torch.dtype):
    return (float("inf") if dtype.is_floating_point
            else torch.iinfo(dtype).max)


def _dtype_min(dtype: torch.dtype):
    return (float("-inf") if dtype.is_floating_point
            else torch.iinfo(dtype).min)


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """One commutative reduce ⊕ and everything derived from it."""

    name: str
    # identity(dtype: "int32" | "float32") -> the ⊕-identity scalar
    identity: Callable[[str], float]
    # scatter(values [..., vs], idx [..., n], vals [..., n]) -> values
    # (scatter-⊕ along the last axis; idx >= vs drops)
    scatter: Callable
    # improves(new, old) -> bool mask: does `new` strictly improve `old`?
    improves: Callable
    # lossy float wire rounding: "up" | "down" | "none"
    quantize_direction: str
    # reduce(x, dim) -> the dense ⊕-reduce along one axis
    reduce: Callable
    # segment_reduce(data, segment_ids, num_segments) for the oracles and
    # the cross-block combine of the pull step
    segment_reduce: Callable
    # elementwise merge of two value arrays
    tie: Callable
    # priority_key(pv, scale) -> f32 where LOWER = propagate sooner
    priority_key: Callable
    idempotent: bool = True


MIN = Aggregator(
    name="min",
    identity=lambda dtype: INT_INF if dtype == "int32" else float("inf"),
    scatter=_scatter("amin"),
    improves=lambda new, old: new < old,
    quantize_direction="up",
    reduce=lambda x, dim: torch.amin(x, dim=dim),
    segment_reduce=_segment_reduce("amin", _dtype_max),
    tie=torch.minimum,
    priority_key=lambda pv, scale: pv,
    idempotent=True,
)

MAX = Aggregator(
    name="max",
    identity=lambda dtype: -1 if dtype == "int32" else 0.0,
    scatter=_scatter("amax"),
    improves=lambda new, old: new > old,
    quantize_direction="down",
    reduce=lambda x, dim: torch.amax(x, dim=dim),
    segment_reduce=_segment_reduce("amax", _dtype_min),
    tie=torch.maximum,
    priority_key=lambda pv, scale: scale - pv,
    idempotent=True,
)

OR = Aggregator(
    name="or",
    identity=lambda dtype: 0,
    scatter=_scatter("amax"),
    improves=lambda new, old: new > old,
    quantize_direction="down",
    reduce=lambda x, dim: torch.amax(x, dim=dim),
    segment_reduce=_segment_reduce("amax", _dtype_min),
    tie=torch.maximum,
    priority_key=lambda pv, scale: scale - pv,
    idempotent=True,
)

SUM = Aggregator(
    name="sum",
    identity=lambda dtype: 0 if dtype == "int32" else 0.0,
    scatter=_scatter("sum"),
    # (+) has no absorbing order, so "improves" degenerates to "changed"
    improves=lambda new, old: new != old,
    # no safe rounding direction exists for an accumulating reduce
    quantize_direction="none",
    reduce=lambda x, dim: torch.sum(x, dim=dim, dtype=x.dtype),
    segment_reduce=_segment_reduce("sum", lambda dtype: 0),
    # a fresh pull-mode recomputation carries absolute sums that
    # supersede the current state — never ⊕-merged against it
    tie=lambda new, cur: new,
    priority_key=lambda pv, scale: pv,
    idempotent=False,
)

AGGREGATORS: dict[str, Aggregator] = {a.name: a for a in (MIN, MAX, OR, SUM)}

# The kernel-layer semiring names (kernels/semiring_spmv.py) and the
# aggregator each one's reduce is an instance of.
SEMIRING_AGGREGATOR: dict[str, str] = {
    "min": "min",
    "min_plus": "min",
    "max": "max",
    "max_min": "max",
    "or": "or",
    "plus_times": "sum",
}


def for_semiring(semiring: str) -> Aggregator:
    """The Aggregator behind a kernel semiring name."""
    return AGGREGATORS[SEMIRING_AGGREGATOR[semiring]]
