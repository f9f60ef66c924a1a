"""Elastic resizing: restore engine state onto a different shard count.

Counterpart of ``repro.ft.elastic`` (the engine half; the trainer half
waits for the LM scaffolding).  Vertex-partitioned state is re-split:
the ``[P, vs]`` rows are flattened in global vertex order and cut again
into ``[P', vs']`` under the same ``dist.sharding.vertex_partition`` rule
(vertex ids are global, so values move verbatim and the frontier is kept
bit for bit).

The engine is self-stabilizing, so a resize mid-run is a restore: the
re-activated boundary covers any message in flight at the resize.  Only
a vertex with an edge into another OLD shard (``old_graph.boundary``) can
have had one, so only those re-activate; re-activating the whole graph
would re-propagate everything.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import EngineState
from repro_torch.dist.sharding import vertex_partition


def repartition_state(state: EngineState, old_graph, new_graph) -> EngineState:
    """Re-split engine state from old_graph's (P, vs) onto new_graph's.

    Host numpy, bitwise the JAX package's result, then one upload of each
    plane to the state's device.  Values past the real vertices fill with
    the largest value, cursors reset to 0 (they are CSR-relative).  A
    push-mode state must be quiescent: with a push latched (``aux[:, 1]``
    non-zero) the cursor reset would re-ship a delivered prefix and count
    its mass twice, so that raises ``ValueError``."""
    dev = state.values.device
    old_p = vertex_partition(old_graph.num_real_vertices, old_graph.num_shards)
    new_p = vertex_partition(new_graph.num_real_vertices, new_graph.num_shards)
    if (old_p.vs, new_p.vs) != (old_graph.vs, new_graph.vs):
        raise ValueError("graph layout diverged from the dist.sharding "
                         "partition rule")

    def host(x) -> np.ndarray:
        return x.detach().cpu().numpy()

    def resplit(arr: np.ndarray, fill) -> np.ndarray:
        flat = arr.reshape(-1)[: old_p.num_vertices]
        out = np.full((new_p.padded_vertices,), fill, dtype=flat.dtype)
        out[: flat.shape[0]] = flat
        return out.reshape(new_p.num_shards, new_p.vs)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    aux = None
    if state.aux is not None:
        host_aux = host(state.aux)
        if host_aux.shape[1] > 1 and np.any(host_aux[:, 1] != 0):
            raise ValueError(
                "repartition_state: push-mode program has latched pushes "
                "in flight (aux[:, 1] != 0); resize only at a quiescent "
                "point (drain the frontier first) — the cursor reset "
                "would re-ship already-delivered message prefixes")
        aux = put(np.stack([resplit(host_aux[:, ch], 0)
                            for ch in range(host_aux.shape[1])], axis=1))

    # the old partition's cut-crossing vertices: the only possible senders
    # of a message in flight at the resize
    cut = np.array(old_graph.boundary, bool)  # [P, P, vs]
    cut[np.arange(old_p.num_shards), np.arange(old_p.num_shards), :] = False
    cut_v = resplit(cut.any(axis=1), False)

    values = host(state.values)
    return EngineState(
        values=put(resplit(values, values.max())),
        active=put(resplit(host(state.active), False) | cut_v),
        cursor=put(resplit(host(state.cursor), 0) * 0),
        tick=state.tick,
        aux=aux,
    )
