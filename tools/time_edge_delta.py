"""Host seconds of one streaming edge delta, three ways, on one graph.

    PYTHONPATH=src python tools/time_edge_delta.py --log2n 16 [--reps 3]

Builds ``asymp_cc_large``'s RMAT config at ``2^log2n`` vertices (8
shards) and times a one-edge insertion through:

  * ``rebuild``: the whole edge list merged and re-assembled through the
    port's ``_assemble_csr`` (what the port did before it spliced);
  * ``splice``: ``repro_torch.core.graph.apply_edge_delta``, which splices
    only the shards the delta touches;
  * ``jax_package``: ``repro.core.graph.apply_edge_delta`` (numpy only:
    list, lexsort, re-assemble), when the JAX package is importable.

All three must give the same arrays.  Prints one JSON line of the best
of ``--reps`` seconds each, with the host's processor count.  The times
are host (numpy) times, not device times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from repro_torch.configs import get_graph_config
from repro_torch.core import graph as G


def rebuild(graph, insertions):
    """The whole-list patch: list every edge, merge the fresh ones in, and
    re-assemble the CSR (insertions only)."""
    edges, w = (G.edge_list(graph, with_weights=True)
                if graph.weights is not None else (G.edge_list(graph), None))
    ins = G._canonical_pairs(insertions)
    stride = np.int64(graph.num_vertices)
    ek = edges[:, 0] * stride + edges[:, 1]
    ins = ins[~np.isin(ins[:, 0] * stride + ins[:, 1], ek)]
    at = np.searchsorted(ek, ins[:, 0] * stride + ins[:, 1])
    new = np.insert(edges, at, ins, axis=0)
    w_new = None
    if w is not None:
        iw = np.random.default_rng(0).uniform(0.1, 1.0, len(ins))
        w_new = np.insert(w, at, iw.astype(np.float32))
    return G._assemble_csr(graph.num_real_vertices, graph.num_shards,
                           new[:, 0], new[:, 1], w_new)


def best(fn, reps):
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return min(times), out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    cfg = dataclasses.replace(get_graph_config("asymp_cc_large"),
                              num_vertices=1 << args.log2n)
    g = G.build_sharded_graph(cfg)
    n = g.num_real_vertices
    ins = [(5, n - 7)]
    out = {"log2n": args.log2n, "directed_edges": g.num_edges,
           "host_cpus": os.cpu_count()}
    out["rebuild_s"], a = best(lambda: rebuild(g, ins), args.reps)
    out["splice_s"], (b, _) = best(lambda: G.apply_edge_delta(g, ins),
                                    args.reps)
    graphs = [a, b]
    try:
        from repro.core import graph as JG
    except ImportError:
        out["jax_package_s"] = None
    else:
        out["jax_package_s"], (c, _) = best(
            lambda: JG.apply_edge_delta(g, ins), args.reps)
        graphs.append(c)
    for f in ("row_ptr", "col_idx", "edge_counts", "boundary"):
        ref = getattr(graphs[0], f)
        assert all(np.array_equal(getattr(x, f), ref) for x in graphs), f
    out["rebuild_over_splice"] = out["rebuild_s"] / out["splice_s"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
