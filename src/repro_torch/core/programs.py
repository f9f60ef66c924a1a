"""Vertex programs (the paper's user API: Init / CreateMessage /
ReceiveMessage / GetOutputString, §4) over pluggable aggregation semirings.

Counterpart of ``repro.core.programs`` for the six idempotent programs —
cc, sssp, bfs, reachability, widest_path and labelprop.  Their receive
reduce is an idempotent :class:`~repro_torch.core.semiring.Aggregator`, so
they tolerate arbitrary message order, duplication and replay (§3.3).
Push-mode ``pagerank`` (the SUM aggregator and the ``aux`` planes) waits
for its slice: ``get_program("pagerank")`` raises ``NotImplementedError``.

The registry is parameterized: ``get_program("sssp", source=5)`` or
``get_program(cfg)`` (which forwards ``cfg.source`` / ``cfg.damping`` to
programs that take them).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional

import torch

from repro_torch.core.semiring import INT_INF, MAX, MIN, OR, Aggregator

F32_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    name: str
    dtype: str  # "int32" | "float32"
    aggregator: Aggregator  # the receive-side reduce ⊕ (ReceiveMessage)
    weighted: bool
    # init(global_ids [.., vs] int32, valid [.., vs] bool) -> (values, active)
    init: Callable
    # combine(src_value [.., M, 1], weight [.., M, D] | None) -> messages
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
    # push-mode sidecar planes (0 for every program of this package yet)
    aux_channels: int = 0
    init_aux: Optional[Callable] = None
    push_eps: float = 0.0

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


def pagerank(damping: float = 0.85, push_eps: float = 1e-5,
             restart: Optional[int] = None,
             weighted: bool = False) -> VertexProgram:
    """Residual-push PageRank: not ported yet (push-mode engine planes)."""
    raise NotImplementedError(
        "the push-mode pagerank program is not ported yet (ROADMAP queue 1, "
        "item 5: push mode); run it with the JAX package")


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
