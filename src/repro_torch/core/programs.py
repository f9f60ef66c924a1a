"""Vertex programs (the paper's user API: Init / CreateMessage /
ReceiveMessage / GetOutputString, §4) over pluggable aggregation semirings.

Counterpart of ``repro.core.programs``.  The six idempotent programs —
cc, sssp, bfs, reachability, widest_path and labelprop — reduce with an
idempotent :class:`~repro_torch.core.semiring.Aggregator`, so they
tolerate arbitrary message order, duplication and replay (§3.3).
``pagerank`` reduces with SUM, which is not idempotent: it sets
``self_stabilizing=False`` (recovery takes a global checkpoint restore)
and runs the engine's push mode, with ``aux_channels`` sidecar planes
beside ``values`` (channel 0 the residual, channel 1 the push latch).

The registry is parameterized: ``get_program("sssp", source=5)`` or
``get_program(cfg)`` (which forwards ``cfg.source`` / ``cfg.damping`` to
programs that take them).
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Optional

import torch

from repro_torch.core.semiring import INT_INF, MAX, MIN, OR, SUM, Aggregator

F32_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    name: str
    dtype: str  # "int32" | "float32"
    aggregator: Aggregator  # the receive-side reduce ⊕ (ReceiveMessage)
    weighted: bool
    # init(global_ids [.., vs] int32, valid [.., vs] bool) -> (values, active)
    init: Callable
    # combine(src_value [.., M, 1], weight [.., M, D] | None) -> messages;
    # push-mode programs take a third argument, the degrees [.., M, 1]
    combine: Callable
    # priority_value(values) -> f32 raw potential metric; the aggregator's
    # priority_key orients it
    priority_value: Callable
    # output(values) -> final per-vertex output
    output: Callable = staticmethod(lambda v: v)
    # §3.3: update is idempotent+commutative => replay/duplication safe
    self_stabilizing: bool = True
    # wire gate: tightest bound B such that every int payload < B
    # (None -> num_vertices, the label-valued default)
    value_bound: Optional[Callable] = None
    # priority normalization hint (None -> num_vertices)
    priority_scale: Optional[float] = None
    # push-mode sidecar planes riding EngineState.aux as [P, channels, vs]
    # (0 = none; pagerank has 2: the residual and the push latch)
    aux_channels: int = 0
    # init_aux(global_ids [.., vs], valid) -> aux [.., aux_channels, vs]
    init_aux: Optional[Callable] = None
    # push-mode activation threshold on |residual|
    push_eps: float = 0.0
    # bucketize(pending, strategy, scale) -> int32 buckets: when set, the
    # engine buckets push-mode pending mass with it instead of
    # priority_buckets(priority_key(priority_value(pending)))
    bucketize: Optional[Callable] = None

    @property
    def tdtype(self) -> torch.dtype:
        return torch.int32 if self.dtype == "int32" else torch.float32

    @property
    def identity(self):
        """The aggregation identity in this program's dtype (empty wire
        slots)."""
        return self.aggregator.identity(self.dtype)

    def wire_bound(self, num_vertices: int) -> int:
        """Int-payload bound gating lossless wire narrowing."""
        return (self.value_bound(num_vertices) if self.value_bound
                else num_vertices)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def connected_components() -> VertexProgram:
    """Fig 3: state = cluster_id (min vertex id in component)."""

    def init(global_ids, valid):
        return _i32(torch.where(valid, global_ids, INT_INF)), valid

    def combine(src_values, weights):
        del weights
        return src_values

    def priority_value(values):
        # low cluster ids have the greatest potential (paper §5.6)
        return _f32(values)

    return VertexProgram("cc", "int32", MIN, False, init, combine,
                         priority_value)


def sssp(source: int = 0) -> VertexProgram:
    """Fig 4: state = distance from source; relax on receive."""

    def init(global_ids, valid):
        values = _f32(torch.where(global_ids == source, 0.0, F32_INF))
        return values, valid & (global_ids == source)

    def combine(src_values, weights):
        w = weights if weights is not None else 1.0
        return src_values + w

    def priority_value(values):
        return values  # small distances first (asynchronous Dijkstra)

    return VertexProgram("sssp", "float32", MIN, True, init, combine,
                         priority_value)


def bfs(source: int = 0) -> VertexProgram:
    """Hop counts = SSSP with unit weights."""

    def init(global_ids, valid):
        values = _i32(torch.where(global_ids == source, 0, INT_INF))
        return values, valid & (global_ids == source)

    def combine(src_values, weights):
        del weights
        return src_values + 1

    def priority_value(values):
        return _f32(values)

    return VertexProgram("bfs", "int32", MIN, False, init, combine,
                         priority_value)


def reachability(source: int = 0) -> VertexProgram:
    """Or-semiring saturation: value = 1 iff reachable from ``source``."""

    def init(global_ids, valid):
        hit = valid & (global_ids == source)
        return _i32(torch.where(hit, 1, 0)), hit

    def combine(src_values, weights):
        del weights
        return src_values  # propagate the saturated bit

    def priority_value(values):
        return _f32(values)  # frontier is uniform anyway

    return VertexProgram("reachability", "int32", OR, False, init, combine,
                         priority_value, value_bound=lambda n: 2)


def widest_path(source: int = 0) -> VertexProgram:
    """Max-min semiring: state = widest bottleneck width from ``source``."""

    def init(global_ids, valid):
        hit = valid & (global_ids == source)
        return _f32(torch.where(hit, F32_INF, 0.0)), hit

    def combine(src_values, weights):
        if weights is None:
            return torch.clamp(src_values, max=1.0)  # min(v, 1.0)
        return torch.minimum(src_values, weights)  # path bottleneck

    def priority_value(values):
        return values  # wide paths first (priority_key inverts: scale - v)

    return VertexProgram("widest_path", "float32", MAX, True, init, combine,
                         priority_value, priority_scale=1.0)


def labelprop() -> VertexProgram:
    """Max-label propagation: every vertex converges to the maximum vertex
    id in its component (the max-aggregator mirror of CC)."""

    def init(global_ids, valid):
        return _i32(torch.where(valid, global_ids, -1)), valid

    def combine(src_values, weights):
        del weights
        return src_values

    def priority_value(values):
        # high labels have the greatest potential (priority_key: scale - v)
        return _f32(values)

    return VertexProgram("labelprop", "int32", MAX, False, init, combine,
                         priority_value)


# pagerank's priority buckets as float32 thresholds on |pending mass|.
# The reference buckets -log2(max(|pending|, 2**-24)) at scale 24, with
# XLA's float32 log, which is not correctly rounded: a torch.log2
# transcription moves 5 log buckets and 66 linear buckets over the float32
# range.  The composed map from |pending| to its bucket is monotone
# (non-increasing), so it is fixed by 31 thresholds per strategy:
# _PAGERANK_BUCKET_EDGES[strategy][k - 1] is the largest float32 (as
# bits) that the reference puts in bucket >= k.  tests/test_torch_pagerank.py
# re-derives both tables from the JAX package by bisection.
_PAGERANK_SCALE = 24.0
_PAGERANK_BUCKET_EDGES = {
    "log": (
        0x3f7fffff, 0x3f7fffff, 0x3f7fffff, 0x3f7fffff, 0x3f7ffffd,
        0x3f7ffffb, 0x3f7ffff7, 0x3f7fffef, 0x3f7fffde, 0x3f7fffbd,
        0x3f7fff7a, 0x3f7ffef5, 0x3f7ffdeb, 0x3f7ffbd7, 0x3f7ff7ae,
        0x3f7fef5d, 0x3f7fdebc, 0x3f7fbd7d, 0x3f7f7b0d, 0x3f7ef65f,
        0x3f7dedd1, 0x3f7bdfed, 0x3f77d0df, 0x3f6fe4ba, 0x3f60ccdf,
        0x3f456729, 0x3f1837ed, 0x3eb504ff, 0x3e000008, 0x3c7ffffb,
        0x397fffb7),
    "linear": (
        0x3f1837f0, 0x3eb504f4, 0x3e5744fd, 0x3e000000, 0x3d9837f2,
        0x3d3504f4, 0x3cd744ff, 0x3c800001, 0x3c1837f3, 0x3bb504f8,
        0x3b5744fe, 0x3b000001, 0x3a9837f3, 0x3a3504f8, 0x39d744fe,
        0x39800003, 0x391837f5, 0x38b504fb, 0x38574508, 0x38000007,
        0x379837fa, 0x373504f5, 0x36d74501, 0x36800003, 0x361837f6,
        0x35b504fb, 0x35574508, 0x35000007, 0x349837f0, 0x343504f5,
        0x33d744fa),
}


@functools.lru_cache(maxsize=None)
def _pagerank_edges(strategy: str, device: torch.device) -> torch.Tensor:
    """The thresholds in ascending order, as float32 on ``device``."""
    bits = torch.tensor(_PAGERANK_BUCKET_EDGES[strategy][::-1],
                        dtype=torch.int32)
    return bits.view(torch.float32).to(device)


def _pagerank_bucketize(pending: torch.Tensor, strategy: str,
                        scale: float) -> torch.Tensor:
    if strategy == "disabled":
        return torch.zeros(pending.shape, dtype=torch.int32,
                           device=pending.device)
    if strategy not in _PAGERANK_BUCKET_EDGES or scale != _PAGERANK_SCALE:
        raise ValueError(f"pagerank buckets exist for strategies "
                         f"{sorted(_PAGERANK_BUCKET_EDGES)} at scale "
                         f"{_PAGERANK_SCALE}, not {strategy!r} at {scale}")
    # bucket = the number of thresholds at or above |pending|
    edges = _pagerank_edges(strategy, pending.device)
    below = torch.searchsorted(edges, torch.abs(pending).contiguous())
    return (len(edges) - below).to(torch.int32)


def pagerank(damping: float = 0.85, push_eps: float = 1e-5,
             restart: Optional[int] = None,
             weighted: bool = False) -> VertexProgram:
    """Residual-push PageRank over the SUM aggregator.

    ``values`` is the banked rank, ``aux[0]`` the residual (incoming mass
    accumulates there by scatter-add) and ``aux[1]`` the push latch: a
    selected vertex latches ``m = residual``, banks ``values += m`` and
    streams ``d * m / deg`` along every edge, across ticks under
    backpressure.  It solves ``p = (1-d)·1 + d·P^T p`` (``p / n`` is the
    PageRank distribution; ``kernels/ops.pagerank`` with
    ``dangling="absorb"`` is the dense pull-mode oracle).

    ``restart`` — a personalized restart vertex: the seed residual is
    ``1-d`` there and zero elsewhere.  ``weighted`` — pushes split mass by
    transition weights, which callers pre-normalize per source vertex
    (``core.graph.normalize_weights``), so ``combine`` sends ``d·m·w``.
    """

    def init(global_ids, valid):
        del global_ids
        return torch.zeros(valid.shape, dtype=torch.float32,
                           device=valid.device), valid

    def init_aux(global_ids, valid):
        seeded = valid if restart is None else valid & (global_ids == restart)
        residual = _f32(torch.where(seeded, 1.0 - damping, 0.0))
        return torch.stack([residual, torch.zeros_like(residual)], dim=-2)

    def combine(mass, weights, degrees):
        if weighted:
            return damping * mass * weights
        # unweighted: mass splits evenly over the edges
        return damping * mass / _f32(torch.clamp(degrees, min=1))

    def priority_value(pending):
        # the reference's raw metric, -log2 of the pending mass; the engine
        # buckets it exactly through _pagerank_bucketize instead
        return -torch.log2(torch.clamp(torch.abs(pending), min=2.0 ** -24))

    return VertexProgram("pagerank", "float32", SUM, weighted, init, combine,
                         priority_value, self_stabilizing=False,
                         priority_scale=_PAGERANK_SCALE, aux_channels=2,
                         init_aux=init_aux, push_eps=push_eps,
                         bucketize=_pagerank_bucketize)


PROGRAMS: dict[str, Callable[..., VertexProgram]] = {
    "cc": connected_components,
    "sssp": sssp,
    "bfs": bfs,
    "reachability": reachability,
    "widest_path": widest_path,
    "labelprop": labelprop,
    "pagerank": pagerank,
}


def register_program(name: str, factory: Callable[..., VertexProgram]) -> None:
    """Add a user program to the registry (the paper's 'write four
    functions' extension point)."""
    PROGRAMS[name] = factory


def get_program(cfg_or_name, **params) -> VertexProgram:
    """Parameterized registry lookup.

    ``get_program("sssp", source=5)`` builds the program directly;
    ``get_program(cfg)`` resolves ``cfg.algorithm`` and forwards the config
    fields the factory accepts (``source`` and ``damping``).  Explicit
    ``params`` win over config-derived ones.
    """
    if isinstance(cfg_or_name, str):
        name, derived = cfg_or_name, {}
    else:
        cfg = cfg_or_name
        name = cfg.algorithm
        derived = {"source": getattr(cfg, "source", 0),
                   "damping": getattr(cfg, "damping", 0.85)}
    if name not in PROGRAMS:
        raise ValueError(
            f"unknown program {name!r}; registered: {sorted(PROGRAMS)}")
    factory = PROGRAMS[name]
    accepted = inspect.signature(factory).parameters
    unknown = set(params) - set(accepted)
    if unknown:
        raise TypeError(f"{name} does not take {sorted(unknown)}; "
                        f"accepts {sorted(accepted)}")
    merged = {**derived, **params}
    return factory(**{k: v for k, v in merged.items() if k in accepted})
