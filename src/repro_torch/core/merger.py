"""Merger phase (paper §3.1 / GetOutputString, §4): extract per-vertex output
once the propagation phase converges.

Counterpart of ``repro.core.merger``; ``mass_balance`` (the push-mode
invariant) waits for the pagerank slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import EngineState
from repro_torch.core.graph import ShardedGraph


def extract(state: EngineState, graph: ShardedGraph, prog) -> np.ndarray:
    """Returns dense per-vertex output [num_real_vertices] on the host."""
    values = prog.output(state.values).detach().cpu().numpy().reshape(-1)
    return values[: graph.num_real_vertices]


def output_table(state: EngineState, graph: ShardedGraph, prog
                 ) -> list[tuple[int, str]]:
    """The paper's output SSTable analogue: (vertex id, output string)."""
    vals = extract(state, graph, prog)
    return [(i, str(v)) for i, v in enumerate(vals)]
