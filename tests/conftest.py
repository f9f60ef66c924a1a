import numpy as np
import pytest


def csr_edges(g, with_weights=False):
    """Recover the (already symmetrized) edge list from a ShardedGraph."""
    srcs, dsts, ws = [], [], []
    for p in range(g.num_shards):
        deg = g.row_ptr[p, 1:] - g.row_ptr[p, :-1]
        cnt = int(g.edge_counts[p])
        src_local = np.repeat(np.arange(g.vs), deg)[:cnt]
        srcs.append(src_local + p * g.vs)
        dsts.append(g.col_idx[p, :cnt])
        if with_weights:
            ws.append(g.weights[p, :cnt])
    edges = np.stack([np.concatenate(srcs), np.concatenate(dsts)], axis=1)
    if with_weights:
        return edges, np.concatenate(ws)
    return edges


def dijkstra_directed(n, src_arr, dst_arr, w_arr, source=0):
    import heapq
    adj = [[] for _ in range(n)]
    for s, d, w in zip(src_arr, dst_arr, w_arr):
        adj[int(s)].append((int(d), float(w)))
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    pq = [(0.0, source)]
    while pq:
        du, u = heapq.heappop(pq)
        if du > dist[u]:
            continue
        for v, wt in adj[u]:
            if du + wt < dist[v]:
                dist[v] = du + wt
                heapq.heappush(pq, (dist[v], v))
    return dist


@pytest.fixture(scope="session")
def rmat_cc_graph():
    from repro.configs.base import GraphConfig
    from repro.core.graph import build_sharded_graph
    cfg = GraphConfig(name="t", algorithm="cc", num_vertices=1024,
                      avg_degree=8, generator="rmat", num_shards=4,
                      priority="log", enforce_fraction=0.5)
    return cfg, build_sharded_graph(cfg)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips on a host without one)")
