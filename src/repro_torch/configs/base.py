"""Graph workload config (the counterpart of ``repro.configs.base.GraphConfig``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class GraphConfig:
    """ASYMP graph workload config (the paper's own configs)."""

    name: str
    # any program registered in core/programs.py:
    # "cc" | "sssp" | "bfs" | "reachability" | "widest_path" | "labelprop"
    algorithm: str
    num_vertices: int
    avg_degree: int
    generator: str = "rmat"  # rmat | er | grid | chain | star | file
    rmat_abcd: Tuple[float, float, float, float] = (0.47, 0.19, 0.19, 0.05)
    num_shards: int = 8
    # ASYMP engine knobs (paper §3.5 / §5.6)
    priority: str = "log"  # disabled | linear | log
    enforce_fraction: float = 0.1  # fraction of active frontier propagated/tick
    edge_budget: int = 0  # 0 -> auto (per-shard edges per tick)
    route_capacity: int = 0  # 0 -> auto (per dst-shard message slots)
    # wire format for the exchange substrate (dist/exchange.py):
    # "none" | "int16" | "int8" — gated down to a safe mode per program
    wire_compression: str = "none"
    # fault tolerance
    checkpoint_every: int = 8  # ticks
    replay_log_ticks: int = 8
    max_ticks: int = 100000
    seed: int = 0
    weighted: bool = False
    # crowded-cluster emulation (paper §5.4; dist/latency.py):
    # "none" | "uniform" | "stragglers" | "heavy_tail"
    latency_profile: str = "none"
    slow_fraction: float = 0.5  # fraction of shards crowded (stragglers)
    link_delay: int = 2  # wire delay (ticks) on a crowded shard's links
    slow_intensity: int = 4  # work-budget divisor for crowded shards
    latency_seed: int = 0
    # straggler-aware scheduling: bucket penalty demoting frontier work
    # that was activated over a slow link (0 = plain priority queue)
    straggler_demote: int = 8
    # execution schedule: "sync" = BSP-style global tick barrier;
    # "async" = barrier-free per-shard progress under a deterministic
    # seeded interleaving (dist/latency.py AsyncInterleaving) — throttle
    # is consumed as a firing rate instead of a budget divisor
    schedule: str = "sync"
    async_seed: int = 0
    # jitter: seeded stateless skips for rate-1 shards (never twice in a
    # row), decorrelating "healthy" shards' steps while staying replayable
    async_jitter: bool = False
    # source vertex for single-source programs (sssp/bfs/reachability/
    # widest_path); ignored by the others
    source: int = 0
    # damping factor for pagerank; ignored by the others
    damping: float = 0.85

    @property
    def num_edges(self) -> int:
        return self.num_vertices * self.avg_degree

    def reduced(self) -> "GraphConfig":
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_vertices=256, avg_degree=4,
            num_shards=4, max_ticks=4096)
