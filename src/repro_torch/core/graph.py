"""Sharded CSR graphs + generators (RMAT per the paper, ER, grid, chain, star).

Counterpart of ``repro.core.graph``: host-side numpy, byte-identical to it
for the same config (the parity tests compare every array) under the
default ``weight_rule`` (the port's own ``"undirected"`` rule is Graph500
kernel 3's, see :func:`edge_weights`), and so is
the streaming delta patch ``apply_edge_delta`` that the serving plane
(``serve/graph.py``) applies.

Vertices are partitioned into P contiguous ranges ("workers"); each shard
holds the out-edges of its vertices in CSR form, padded to the max per-shard
edge count so every shard array has identical shape (SPMD requirement).
Boundary maps (which local vertices have edges into shard q) are precomputed
for the fault-recovery fallback path (DESIGN.md C3).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.configs.base import GraphConfig
from repro_torch.dist.sharding import vertex_partition


@dataclasses.dataclass
class ShardedGraph:
    """P-way vertex-partitioned CSR (host arrays; the engine moves them to
    the device)."""

    num_vertices: int  # global, includes padding to P*vs
    num_real_vertices: int
    num_edges: int
    num_shards: int
    vs: int  # vertices per shard
    row_ptr: np.ndarray  # [P, vs+1] int64 (local edge offsets)
    col_idx: np.ndarray  # [P, es] int32 global dst ids (padded with -1)
    weights: Optional[np.ndarray]  # [P, es] f32 or None
    edge_counts: np.ndarray  # [P] real edges per shard
    boundary: np.ndarray  # [P, P, vs] bool: boundary[p, q, v] = v has edge -> q

    @property
    def es(self) -> int:
        return self.col_idx.shape[1]

    def degrees(self) -> np.ndarray:
        return self.row_ptr[:, 1:] - self.row_ptr[:, :-1]  # [P, vs]

    @classmethod
    def from_arrays(cls, row_ptr, col_idx, weights, edge_counts, boundary, *,
                    num_real_vertices: int) -> "ShardedGraph":
        """Adopt host arrays built elsewhere (e.g. by the JAX package's
        builder) as a graph of this package; sizes follow from the shapes.
        The arrays are copied, so the two graphs never alias."""
        row_ptr = np.array(row_ptr, np.int64)
        col_idx = np.array(col_idx, np.int64)
        edge_counts = np.array(edge_counts)
        boundary = np.array(boundary, bool)
        P, vs = row_ptr.shape[0], row_ptr.shape[1] - 1
        if col_idx.shape[0] != P or edge_counts.shape != (P,) or \
                boundary.shape != (P, P, vs):
            raise ValueError(
                f"inconsistent shapes: row_ptr {row_ptr.shape}, col_idx "
                f"{col_idx.shape}, edge_counts {edge_counts.shape}, "
                f"boundary {boundary.shape}")
        if weights is not None:
            weights = np.array(weights, np.float32)
            if weights.shape != col_idx.shape:
                raise ValueError(f"weights {weights.shape} != col_idx "
                                 f"{col_idx.shape}")
        return cls(num_vertices=P * vs, num_real_vertices=num_real_vertices,
                   num_edges=int(edge_counts.sum()), num_shards=P, vs=vs,
                   row_ptr=row_ptr, col_idx=col_idx, weights=weights,
                   edge_counts=edge_counts, boundary=boundary)


# ======================================================================
# Generators (host-side numpy; deterministic per seed)
# ======================================================================
def rmat_edges(log2_n: int, avg_degree: int, abcd, seed: int) -> np.ndarray:
    """R-MAT edge list [(src, dst)] (paper §5.1: recursive quadrant model)."""
    n_bits = log2_n
    m = (1 << log2_n) * avg_degree
    rng = np.random.default_rng(seed)
    a, b, c, d = abcd
    # per-bit quadrant choice for all edges at once
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(n_bits):
        r = rng.random(m)
        # quadrant probabilities with slight noise (standard RMAT smoothing)
        right = r < (b + d)
        r2 = rng.random(m)
        down_given_right = r2 < (d / max(b + d, 1e-9))
        down_given_left = r2 < (c / max(a + c, 1e-9))
        down = np.where(right, down_given_right, down_given_left)
        src = (src << 1) | down.astype(np.int64)
        dst = (dst << 1) | right.astype(np.int64)
    edges = np.stack([src, dst], axis=1)
    return edges


def er_edges(n: int, avg_degree: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = n * avg_degree
    return rng.integers(0, n, size=(m, 2), dtype=np.int64)


def grid_edges(n: int) -> np.ndarray:
    side = int(np.sqrt(n))
    idx = np.arange(side * side).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([right, down], axis=0)


def chain_edges(n: int) -> np.ndarray:
    v = np.arange(n - 1)
    return np.stack([v, v + 1], axis=1)


def star_edges(n: int) -> np.ndarray:
    v = np.arange(1, n)
    return np.stack([np.zeros(n - 1, np.int64), v], axis=1)


def generate_edges(cfg: GraphConfig) -> np.ndarray:
    n = cfg.num_vertices
    if cfg.generator == "rmat":
        log2n = int(np.log2(n))
        return rmat_edges(log2n, cfg.avg_degree, cfg.rmat_abcd, cfg.seed)
    if cfg.generator == "er":
        return er_edges(n, cfg.avg_degree, cfg.seed)
    if cfg.generator == "grid":
        return grid_edges(n)
    if cfg.generator == "chain":
        return chain_edges(n)
    if cfg.generator == "star":
        return star_edges(n)
    raise ValueError(cfg.generator)


# ======================================================================
def _assemble_csr(n: int, P: int, src: np.ndarray, dst: np.ndarray,
                  w_all: Optional[np.ndarray]) -> ShardedGraph:
    """Sorted directed edge arrays -> P-way padded CSR.  ``src``/``dst``
    (and ``w_all``, row-aligned) must already be lexsorted by (src, dst)
    with self-loops dropped."""
    part = vertex_partition(n, P)  # the engine's shard rule (dist/sharding)
    vs = part.vs
    n_pad = part.padded_vertices
    shard = part.shard_of(src)

    counts = np.bincount(shard, minlength=P)
    es = max(int(counts.max()), 1)
    row_ptr = np.zeros((P, vs + 1), dtype=np.int64)
    col_idx = np.full((P, es), -1, dtype=np.int64)
    weights = (np.zeros((P, es), dtype=np.float32)
               if w_all is not None else None)

    start = 0
    for p in range(P):
        cnt = int(counts[p])
        s_loc = src[start: start + cnt] - p * vs
        col_idx[p, :cnt] = dst[start: start + cnt]
        if weights is not None:
            weights[p, :cnt] = w_all[start: start + cnt]
        row_ptr[p] = np.searchsorted(s_loc, np.arange(vs + 1))
        start += cnt

    boundary = np.zeros((P, P, vs), dtype=bool)
    start = 0
    for p in range(P):
        cnt = int(counts[p])
        s_loc = src[start: start + cnt] - p * vs
        d_shard = dst[start: start + cnt] // vs
        boundary[p, d_shard, s_loc] = True
        start += cnt

    return ShardedGraph(
        num_vertices=n_pad, num_real_vertices=n, num_edges=len(src),
        num_shards=P, vs=vs, row_ptr=row_ptr, col_idx=col_idx,
        weights=weights, edge_counts=counts, boundary=boundary)


def build_sharded_graph(cfg: GraphConfig,
                        edges: Optional[np.ndarray] = None,
                        symmetrize: bool = True) -> ShardedGraph:
    """Edge list -> P-way padded CSR (+ reverse edges for undirected algos);
    a weighted config's weights by its ``weight_rule``
    (:func:`edge_weights`)."""
    P = cfg.num_shards
    if edges is None:
        edges = generate_edges(cfg)
    n = int(cfg.num_vertices)
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    # drop self-loops, dedup.  One sort of the packed (src, dst) key gives
    # the rows of np.unique(edges, axis=0) in the same lexicographic
    # order, several times faster than a row-wise unique + lexsort
    edges = np.asarray(edges, np.int64)
    edges = edges[edges[:, 0] != edges[:, 1]]
    stride = np.int64(max(n, int(edges.max(initial=0)) + 1))
    key = np.unique(edges[:, 0] * stride + edges[:, 1])
    src, dst = key // stride, key % stride
    w_all = None
    if cfg.weighted:
        w_all = edge_weights(cfg, key, src, dst, stride)
    return _assemble_csr(n, P, src, dst, w_all)


WEIGHT_RULES = ("directed", "undirected")


def edge_weights(cfg: GraphConfig, key: np.ndarray, src: np.ndarray,
                 dst: np.ndarray, stride: np.int64) -> np.ndarray:
    """float32 weights of the sorted, deduplicated directed edges ``key =
    src * stride + dst``, by ``cfg.weight_rule``, from
    ``default_rng(s + 7)``, ``s`` the config's ``weight_seed``, or its
    ``seed`` where that is None:

      * ``"directed"`` (the JAX package's rule): one ``uniform(0.1, 1.0)``
        a directed edge, in ``(src, dst)`` order;
      * ``"undirected"`` (Graph500 kernel 3's): the i-th undirected edge
        ``(lo, hi)``, ``lo < hi``, in ascending order, takes the i-th draw
        of ``random(E, dtype=float32)``, exactly in [0, 1), and both of its
        directions carry it.  Every edge needs its reverse.

    ``apply_edge_delta`` (and the serving plane that calls it) draws an
    inserted edge's weight by the directed rule whatever the config says.
    """
    seed = cfg.seed if cfg.weight_seed is None else cfg.weight_seed
    rng = np.random.default_rng(seed + 7)
    if cfg.weight_rule == "directed":
        return rng.uniform(0.1, 1.0, size=len(key)).astype(np.float32)
    if cfg.weight_rule != "undirected":
        raise ValueError(f"unknown weight_rule {cfg.weight_rule!r}; "
                         f"valid: {WEIGHT_RULES}")
    forward = src < dst
    undirected = key[forward]  # already in ascending (lo, hi) order
    draws = rng.random(len(undirected), dtype=np.float32)
    # the reverse edges (hi, lo), sorted by their canonical key
    # lo * stride + hi, are the undirected list again.  One argsort puts
    # them there, several times faster than a searchsorted of each at
    # random (9.5-11 s at Graph500 scale 20 on an H100 machine's host)
    backward = ~forward
    canon = dst[backward] * stride + src[backward]
    order = np.argsort(canon)
    if len(canon) != len(undirected) or not np.array_equal(canon[order],
                                                           undirected):
        raise ValueError("the undirected weight rule needs both directions "
                         "of every edge")
    w_back = np.empty(len(canon), np.float32)
    w_back[order] = draws
    w_all = np.empty(len(key), np.float32)
    w_all[forward] = draws
    w_all[backward] = w_back
    return w_all


def normalize_weights(graph: ShardedGraph) -> ShardedGraph:
    """Per-source transition normalization for weighted pagerank: every
    edge weight becomes ``w_e / strength(src)`` (strength = summed outgoing
    weight, in float64), so a push of mass ``m`` sends ``d·m·w_e`` and
    its edges carry exactly ``d·m`` together.  Unweighted graphs get
    uniform ``1/deg`` weights.

    Byte-identical to the JAX package's per-shard ``np.add.at`` loop: one
    ``np.bincount`` over all shards adds each vertex's weights in the same
    (edge) order."""
    P, vs, es = graph.num_shards, graph.vs, graph.es
    counts = np.asarray(graph.edge_counts, np.int64)
    deg = (graph.row_ptr[:, 1:] - graph.row_ptr[:, :-1]).astype(np.int64)
    # each real edge's global source slot p * vs + local source
    src = np.repeat(np.arange(P * vs), deg.reshape(-1))
    real = np.arange(es)[None, :] < counts[:, None]  # [P, es]
    we = (graph.weights[real] if graph.weights is not None
          else np.ones(int(counts.sum()), np.float32))
    strength = np.bincount(src, weights=we.astype(np.float64),
                           minlength=P * vs)
    out = np.zeros((P, es), dtype=np.float32)
    out[real] = (we / np.maximum(strength[src], 1e-30)).astype(np.float32)
    return dataclasses.replace(graph, weights=out)


def edge_list(graph: ShardedGraph, with_weights: bool = False):
    """Recover the exact directed edge list (lexsorted by (src, dst))
    from a sharded CSR — the inverse of :func:`_assemble_csr`.  Returns
    ``edges [E, 2]`` (or ``(edges, weights)``): the input to oracles."""
    srcs, dsts, ws = [], [], []
    for p in range(graph.num_shards):
        cnt = int(graph.edge_counts[p])
        deg = (graph.row_ptr[p, 1:] - graph.row_ptr[p, :-1]).astype(np.int64)
        srcs.append(p * graph.vs + np.repeat(np.arange(graph.vs), deg))
        dsts.append(graph.col_idx[p, :cnt])
        if with_weights and graph.weights is not None:
            ws.append(graph.weights[p, :cnt])
    edges = np.stack([np.concatenate(srcs), np.concatenate(dsts)],
                     axis=1).astype(np.int64)
    if with_weights:
        return edges, (np.concatenate(ws).astype(np.float32)
                       if ws else np.ones(len(edges), np.float32))
    return edges


# ======================================================================
# Streaming edge deltas (the serving plane's mutation path)
# ======================================================================
class EdgeDelta(NamedTuple):
    """What :func:`apply_edge_delta` actually changed (directed,
    post-symmetrization, deduplicated against the existing edge set)."""
    inserted: np.ndarray  # [ki, 2] directed edges added
    deleted: np.ndarray  # [kd, 2] directed edges removed
    endpoints: np.ndarray  # unique vertex ids touched by either


def _canonical_pairs(pairs) -> np.ndarray:
    """Undirected pairs -> both directions, self-loops dropped, unique
    rows in (src, dst) order."""
    pairs = np.asarray(list(pairs), np.int64).reshape(-1, 2)
    if len(pairs):
        pairs = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        pairs = np.unique(pairs, axis=0)
    return pairs


def _edge_slots(graph: ShardedGraph, pairs: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """Where each directed pair (src, dst) sits in its source shard's edge
    array: ``(present [k] bool, slot [k])``, with ``slot`` the position the
    pair has, or would be inserted at, in the (src, dst)-sorted row."""
    present = np.zeros(len(pairs), bool)
    slot = np.zeros(len(pairs), np.int64)
    for i, (u, v) in enumerate(pairs):
        p, l = int(u) // graph.vs, int(u) % graph.vs
        lo, hi = int(graph.row_ptr[p, l]), int(graph.row_ptr[p, l + 1])
        at = lo + int(np.searchsorted(graph.col_idx[p, lo:hi], v))
        present[i] = at < hi and int(graph.col_idx[p, at]) == int(v)
        slot[i] = at
    return present, slot


def apply_edge_delta(graph: ShardedGraph, insertions=(), deletions=(),
                     *, insert_weights: Optional[np.ndarray] = None,
                     seed: int = 0) -> tuple[ShardedGraph, EdgeDelta]:
    """Patch the sharded CSR with a streaming delta; byte-identical to the
    JAX package's patch (and so to a rebuild from the patched edge list).

    ``insertions`` / ``deletions`` are undirected vertex pairs, both
    symmetrized with self-loops dropped.  Deleting an absent edge or
    inserting a present one is skipped (``EdgeDelta`` reports what changed);
    an edge in both lists ends up present.  A weighted graph keeps every
    surviving edge's weight, and an inserted directed edge draws a fresh
    weight, ``default_rng(seed).uniform(0.1, 1.0)`` in (src, dst) order,
    unless ``insert_weights`` gives one per canonical inserted edge (the
    directed rule, whatever ``weight_rule`` built the graph).  The
    padded width ``es`` is recomputed.

    The JAX package lists, sorts and re-assembles every edge.  Here each
    delta edge is looked up in its sorted CSR row, only the shards the
    delta touches are spliced, and the rest are copied as they are: the
    result is the same arrays, without a sort of the whole edge list."""
    n, P, vs = graph.num_real_vertices, graph.num_shards, graph.vs
    ins = _canonical_pairs(insertions)
    dele = _canonical_pairs(deletions)
    if (len(ins) and int(ins.max()) >= n) or \
            (len(dele) and int(dele.max()) >= n):
        raise ValueError("delta touches vertex ids outside the graph")

    stride = np.int64(graph.num_vertices)
    key = lambda e: e[:, 0] * stride + e[:, 1]  # noqa: E731
    present, del_slot = _edge_slots(graph, dele)
    deleted, del_slot = dele[present], del_slot[present]
    present, _ = _edge_slots(graph, ins)
    fresh = ~present | np.isin(key(ins), key(deleted))
    ins_new = ins[fresh]
    iw = None
    if graph.weights is not None:
        if insert_weights is not None:
            iw = np.asarray(insert_weights, np.float32)[fresh]
        else:
            rng = np.random.default_rng(seed)
            iw = rng.uniform(0.1, 1.0, size=len(ins_new)).astype(np.float32)

    # splice the touched shards: drop the deleted slots, then insert the
    # fresh edges at their places in the (src, dst) order
    old_counts = np.asarray(graph.edge_counts, np.int64)
    rows: dict[int, tuple] = {}
    for p in np.unique(np.concatenate([deleted[:, 0], ins_new[:, 0]]) // vs):
        p = int(p)
        cnt = int(old_counts[p])
        src = np.repeat(np.arange(vs, dtype=np.int64),
                        graph.row_ptr[p, 1:] - graph.row_ptr[p, :-1])
        dst = graph.col_idx[p, :cnt]
        w = graph.weights[p, :cnt] if graph.weights is not None else None
        gone = del_slot[deleted[:, 0] // vs == p]
        src, dst = np.delete(src, gone), np.delete(dst, gone)
        w = np.delete(w, gone) if w is not None else None
        mine = ins_new[:, 0] // vs == p
        add = ins_new[mine]
        at = np.searchsorted(src * stride + dst,
                             (add[:, 0] - p * vs) * stride + add[:, 1])
        src = np.insert(src, at, add[:, 0] - p * vs)
        dst = np.insert(dst, at, add[:, 1])
        if w is not None:
            w = np.insert(w, at, iw[mine])
        rows[p] = (src, dst, w)

    counts = old_counts.copy()
    for p, (src, _, _) in rows.items():
        counts[p] = len(src)
    es = max(int(counts.max()), 1)
    row_ptr = np.array(graph.row_ptr, np.int64)
    col_idx = np.full((P, es), -1, dtype=np.int64)
    weights = (np.zeros((P, es), dtype=np.float32)
               if graph.weights is not None else None)
    boundary = np.array(graph.boundary, bool)
    for p in range(P):
        if p not in rows:
            cnt = int(counts[p])
            col_idx[p, :cnt] = graph.col_idx[p, :cnt]
            if weights is not None:
                weights[p, :cnt] = graph.weights[p, :cnt]
            continue
        src, dst, w = rows[p]
        col_idx[p, :len(dst)] = dst
        if weights is not None:
            weights[p, :len(w)] = w
        row_ptr[p] = np.searchsorted(src, np.arange(vs + 1))
        # the boundary bits of every source row the delta touched
        srcs = np.unique(np.concatenate([deleted[:, 0], ins_new[:, 0]]))
        srcs = srcs[srcs // vs == p] - p * vs
        boundary[p][:, srcs] = False
        hit = np.isin(src, srcs)
        boundary[p, dst[hit] // vs, src[hit]] = True

    new_graph = ShardedGraph(
        num_vertices=graph.num_vertices, num_real_vertices=n,
        num_edges=int(counts.sum()), num_shards=P, vs=vs, row_ptr=row_ptr,
        col_idx=col_idx, weights=weights, edge_counts=counts,
        boundary=boundary)
    touched = (np.unique(np.concatenate([ins_new.ravel(), deleted.ravel()]))
               if len(ins_new) + len(deleted)
               else np.zeros(0, np.int64))
    return new_graph, EdgeDelta(ins_new, deleted, touched)


# ======================================================================
# Host-side oracles for tests/benchmarks
# ======================================================================
def cc_oracle(n: int, edges: np.ndarray) -> np.ndarray:
    """Union-find min-label connected components."""
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for s, d in edges:
        rs, rd = find(int(s)), find(int(d))
        if rs != rd:
            parent[max(rs, rd)] = min(rs, rd)
    return np.array([find(i) for i in range(n)], dtype=np.int64)


def reachability_oracle(n: int, edges: np.ndarray,
                        source: int = 0) -> np.ndarray:
    """1 iff reachable from ``source`` (on the symmetrized graph the
    reachable set is exactly the source's connected component)."""
    comp = cc_oracle(n, edges)
    return (comp == comp[source]).astype(np.int64)


def labelprop_oracle(n: int, edges: Optional[np.ndarray] = None,
                     comp: Optional[np.ndarray] = None) -> np.ndarray:
    """Max vertex id per component (the max-aggregator mirror of CC).

    ``comp`` — precomputed per-vertex component ids (any labeling that is
    constant within a component, e.g. CC output) — skips the union-find.
    """
    if comp is None:
        comp = cc_oracle(n, edges)
    max_of_comp = np.full(n, -1, dtype=np.int64)
    np.maximum.at(max_of_comp, comp, np.arange(n, dtype=np.int64))
    return max_of_comp[comp]


def widest_path_oracle(n: int, src_arr: np.ndarray, dst_arr: np.ndarray,
                       w_arr: np.ndarray, source: int = 0) -> np.ndarray:
    """Max-min Dijkstra over a directed edge list: width[v] = max over
    paths of the minimum edge weight along the path (source = +inf)."""
    import heapq

    adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for s, d, wt in zip(src_arr, dst_arr, w_arr):
        adj[int(s)].append((int(d), float(wt)))
    width = np.zeros(n)
    width[source] = np.inf
    pq = [(-np.inf, source)]
    while pq:
        neg_wu, u = heapq.heappop(pq)
        if -neg_wu < width[u]:
            continue
        for v, wt in adj[u]:
            cand = min(width[u], wt)
            if cand > width[v]:
                width[v] = cand
                heapq.heappush(pq, (-cand, v))
    return width


def sssp_oracle(n: int, edges: np.ndarray, w: np.ndarray,
                source: int) -> np.ndarray:
    """Dijkstra (heapq) over the symmetrized weighted graph."""
    import heapq

    adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for (s, d), wt in zip(edges, w):
        adj[int(s)].append((int(d), float(wt)))
        adj[int(d)].append((int(s), float(wt)))
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    pq = [(0.0, source)]
    while pq:
        du, u = heapq.heappop(pq)
        if du > dist[u]:
            continue
        for v, wt in adj[u]:
            nd = du + wt
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist
