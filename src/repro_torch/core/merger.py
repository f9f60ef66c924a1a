"""Merger phase (paper §3.1 / GetOutputString, §4): extract per-vertex output
once the propagation phase converges, and the push-mode mass-balance
invariant.

Counterpart of ``repro.core.merger``.
"""
from __future__ import annotations

import numpy as np

from repro_torch import _trace
from repro_torch.core.engine import EngineState
from repro_torch.core.graph import ShardedGraph


def extract(state: EngineState, graph: ShardedGraph, prog) -> np.ndarray:
    """Returns dense per-vertex output [num_real_vertices] on the host (one
    transfer, counted in ``host_reads``)."""
    _trace.count("host_reads")
    values = prog.output(state.values).detach().cpu().numpy().reshape(-1)
    return values[: graph.num_real_vertices]


def mass_balance(state: EngineState, graph: ShardedGraph,
                 damping: float = 0.85) -> float:
    """Normalized total mass of a push-mode (pagerank) run: 1.0 (to float
    error) at every tick boundary iff delivery is exactly-once.

    Counts the four places a unit of mass can be: banked rank (times
    1-d), the residual plane, the unshipped tail of a latched push
    (``d * push * (deg - cursor) / deg``) and the mass absorbed at
    degree-0 vertices (``d * rank`` there).  Computed on the host in
    float64, as the JAX package computes it."""
    if state.aux is None:
        raise ValueError("mass_balance needs the push-mode aux planes")
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    n = graph.num_real_vertices
    d = damping
    aux = host(state.aux)
    rank = host(state.values).astype(np.float64).reshape(-1)[:n]
    res = aux[:, 0].astype(np.float64).reshape(-1)[:n]
    push = aux[:, 1].astype(np.float64).reshape(-1)[:n]
    cur = host(state.cursor).astype(np.float64).reshape(-1)[:n]
    deg = np.asarray(graph.degrees()).reshape(-1)[:n].astype(np.float64)
    inflight = d * push * (deg - cur) / np.maximum(deg, 1.0)
    leak = d * rank[deg == 0].sum()
    return float(((1 - d) * rank.sum() + res.sum() + inflight.sum() + leak)
                 / ((1 - d) * n))


def output_table(state: EngineState, graph: ShardedGraph, prog
                 ) -> list[tuple[int, str]]:
    """The paper's output SSTable analogue: (vertex id, output string)."""
    vals = extract(state, graph, prog)
    return [(i, str(v)) for i, v in enumerate(vals)]
