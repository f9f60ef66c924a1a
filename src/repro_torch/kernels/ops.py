"""The pull step around the semiring SpMV kernel, and its host preprocessing.

Counterpart of ``repro.kernels.ops``.  ``PulledGraph`` is the kernel-ready
edge layout: destination-sorted edges, tile-padded so every EDGE_BLOCK
belongs to exactly one 128-destination tile.  ``frontier_pull_step`` runs
one full-frontier propagation — the synchronous Pregel-equivalent
iteration of the paper's BSP baseline (``bsp_connected_components``) and
of the dense pagerank oracle (``pagerank``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.graph import ShardedGraph
from repro_torch.core.semiring import for_semiring
from repro_torch.kernels.semiring_spmv import (EDGE_BLOCK, TILE, _identity,
                                               spmv_partials)

Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class PulledGraph:
    """Destination-sorted, tile-padded edge stream: host arrays from
    :func:`build_pulled_graph`, device tensors after :meth:`to`."""
    num_vertices: int  # padded to a TILE multiple
    num_real_vertices: int
    edge_src: Array  # [E_pad] int32 (-1 = padding)
    edge_dst_local: Array  # [E_pad] int32 in [0, TILE) (-1 = padding)
    block_tile: Array  # [n_blocks] int32 — destination tile per block
    weights: Optional[Array]  # [E_pad] f32

    @property
    def n_blocks(self) -> int:
        return len(self.block_tile)

    @property
    def n_tiles(self) -> int:
        return self.num_vertices // TILE

    def to(self, device: DeviceLike) -> "PulledGraph":
        """The same stream as tensors on ``device`` (copied once, so the
        rounds of a BSP run do not re-upload it)."""
        dev = torch.device(device)
        put = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
        return dataclasses.replace(
            self, edge_src=put(self.edge_src),
            edge_dst_local=put(self.edge_dst_local),
            block_tile=put(self.block_tile),
            weights=put(self.weights) if self.weights is not None else None)


def build_pulled_graph(graph: ShardedGraph) -> PulledGraph:
    """ShardedGraph CSR -> destination-sorted tile-padded edge stream.

    Byte-identical to the JAX package's builder, but vectorized: each
    tile's edge run lands at its padded offset in one scatter, instead of
    one boolean mask over all edges per tile (O(tiles x E))."""
    srcs, dsts, ws = [], [], []
    for p in range(graph.num_shards):
        cnt = int(graph.edge_counts[p])
        deg = graph.row_ptr[p, 1:] - graph.row_ptr[p, :-1]
        src_local = np.repeat(np.arange(graph.vs), deg)[:cnt]
        srcs.append(src_local + p * graph.vs)
        dsts.append(graph.col_idx[p, :cnt])
        if graph.weights is not None:
            ws.append(graph.weights[p, :cnt])
    src = np.concatenate(srcs).astype(np.int64)
    dst = np.concatenate(dsts).astype(np.int64)
    w = np.concatenate(ws).astype(np.float32) if ws else None

    n_pad = -(-graph.num_vertices // TILE) * TILE
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    if w is not None:
        w = w[order]
    tile = dst // TILE

    # pad each tile's edge run to an EDGE_BLOCK multiple: run k (tile
    # tiles[k], counts[k] edges) starts at out_start[k] in the output
    tiles, counts = np.unique(tile, return_counts=True)
    padded = counts + (-counts) % EDGE_BLOCK
    out_start = np.cumsum(padded) - padded
    in_start = np.cumsum(counts) - counts
    run = np.repeat(np.arange(len(tiles)), counts)
    pos = out_start[run] + (np.arange(len(src)) - in_start[run])
    e_pad = int(padded.sum())
    edge_src = np.full(e_pad, -1, np.int32)
    edge_src[pos] = src
    edge_dst_local = np.full(e_pad, -1, np.int32)
    edge_dst_local[pos] = dst - tile * TILE
    weights = None
    if w is not None:
        weights = np.zeros(e_pad, np.float32)
        weights[pos] = w
    return PulledGraph(
        num_vertices=n_pad,
        num_real_vertices=graph.num_real_vertices,
        edge_src=edge_src,
        edge_dst_local=edge_dst_local,
        block_tile=np.repeat(tiles, padded // EDGE_BLOCK).astype(np.int32),
        weights=weights,
    )


# ======================================================================
def _pull_step(values, edge_src, edge_dst_local, block_tile, weights, *,
               semiring: str, n_tiles: int, use_mxu: bool) -> torch.Tensor:
    ident = _identity(semiring, values.dtype)  # plus_times/SUM: 0
    safe_src = torch.clamp(edge_src, 0, values.shape[0] - 1)
    vals = torch.where(edge_src >= 0,
                       torch.index_select(values, 0, safe_src), ident)
    partials = spmv_partials(vals, edge_dst_local, weights,
                             semiring=semiring, use_mxu=use_mxu)
    # combine per-block partials into per-tile outputs (a torch op, as the
    # JAX package leaves it to XLA)
    agg = for_semiring(semiring)
    tiles = agg.segment_reduce(partials, block_tile, n_tiles)
    if agg.idempotent:  # clamp empty/out-of-domain lanes at the identity
        tiles = agg.tie(tiles, torch.tensor(ident, dtype=tiles.dtype,
                                            device=tiles.device))
    return tiles.reshape(n_tiles * TILE)


def frontier_pull_step(values: torch.Tensor, pg: PulledGraph, *,
                       semiring: str, use_mxu: bool = False) -> torch.Tensor:
    """One full propagation: out[v] = reduce over in-edges combine(src, w).

    For idempotent semirings the result is further tied against the
    current values (the self-stabilizing update); the non-idempotent
    plus_times/SUM result is absolute and supersedes.  ``pg`` may hold
    host arrays or tensors; tensors already on ``values``' device are
    used as they are."""
    dev = values.device
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    vpad = pg.num_vertices - values.shape[0]
    v = torch.cat([values, values.new_full(
        (vpad,), _identity(semiring, values.dtype))]) if vpad else values
    out = _pull_step(v, put(pg.edge_src), put(pg.edge_dst_local),
                     put(pg.block_tile),
                     put(pg.weights) if pg.weights is not None else None,
                     semiring=semiring, n_tiles=pg.n_tiles, use_mxu=use_mxu)
    agg = for_semiring(semiring)
    if agg.idempotent:
        out = agg.tie(out, v)
    return out[: values.shape[0]] if vpad else out


# ======================================================================
def pagerank(graph: ShardedGraph, *, damping: float = 0.85,
             iters: int = 30, dangling: str = "redistribute",
             device: DeviceLike = None,
             pulled: Optional[PulledGraph] = None) -> torch.Tensor:
    """PageRank in the paper's §3.3-safe pull-mode formulation (the dense
    oracle for the engine's push-mode program): rank_v = (1-d) + d * sum_in
    rank_u / deg_u, one ``plus_times`` pull step per iteration.

    ``dangling``: ``"redistribute"`` (a dangling vertex's damped mass
    teleports uniformly; ranks sum to 1) or ``"absorb"`` (it evaporates —
    the push program's fixpoint).  ``pulled``: ``graph``'s pulled stream,
    when the caller has built it already.
    """
    if dangling not in ("redistribute", "absorb"):
        raise ValueError(f"dangling must be 'redistribute' or 'absorb', "
                         f"got {dangling!r}")
    dev = resolve_device(device)
    pg = (pulled or build_pulled_graph(graph)).to(dev)
    n, n_real = pg.num_vertices, graph.num_real_vertices
    deg_raw = graph.degrees().reshape(-1).astype(np.float32)
    deg_raw = np.pad(deg_raw, (0, n - len(deg_raw)))[:n]
    dangling_mask = torch.as_tensor(deg_raw == 0, device=dev)
    deg_t = torch.as_tensor(np.maximum(deg_raw, 1.0), device=dev)
    rank = torch.full((n,), 1.0 / n_real, dtype=torch.float32, device=dev)
    rank[n_real:] = 0.0
    for _ in range(iters):
        contrib = rank / deg_t
        pulled = frontier_pull_step(contrib, pg, semiring="plus_times")
        if dangling == "redistribute":
            dm = torch.sum(torch.where(dangling_mask, rank, 0.0))
            pulled = pulled + dm / n_real
        rank = (1 - damping) / n_real + damping * pulled
        rank[n_real:] = 0.0
    return rank[:n_real]


# ======================================================================
def bsp_connected_components(graph: ShardedGraph, *, max_rounds: int = 10000,
                             device: DeviceLike = None,
                             pulled: Optional[PulledGraph] = None):
    """Synchronous full-frontier CC (the Pregel-equivalent BSP baseline).

    Runs min-label propagation rounds until fixpoint; each round is one
    kernel-backed pull step over ALL edges — the superstep model the
    paper compares against (O(diameter) rounds, all edges touched per
    round).  Returns ``(labels [num_real_vertices] int32 tensor,
    {"rounds", "messages"})``.  ``pulled``: ``graph``'s pulled stream, when
    the caller has built it already."""
    dev = resolve_device(device)
    pg = (pulled or build_pulled_graph(graph)).to(dev)
    n = graph.num_vertices
    values = torch.arange(n, dtype=torch.int32, device=dev)
    rounds = 0
    messages = 0
    for _ in range(max_rounds):
        new = frontier_pull_step(values, pg, semiring="min")
        rounds += 1
        messages += int(pg.edge_src.shape[0])  # BSP sends on every edge
        if torch.equal(new, values):
            break
        values = new
    return values[: graph.num_real_vertices], {"rounds": rounds,
                                               "messages": messages}
