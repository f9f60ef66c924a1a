"""Online graph-mining service: resumable engine sessions + sharded
fixpoint store + streaming-delta incremental recomputation.

Counterpart of ``repro.serve.graph``: the write path of the serving plane
(``serve/store.py`` is the read path).  The sessions tick on their device;
the delta seeding is host numpy, as in the JAX package, and the seeded
planes go back to the session's device.

  * :class:`GraphServer` — one shared graph, one resumable
    :class:`~repro_torch.core.engine.EngineSession` per registered
    program.  ``converge()`` ticks every session to quiescence and
    publishes an epoch; ``apply_delta()`` patches the sharded CSR ONCE
    (:func:`~repro_torch.core.graph.apply_edge_delta`), re-seeds each
    session's frontier with only the delta-touched work and ticks back to
    quiescence — ASYMP's "recover only what was lost", applied to graph
    mutations instead of machine failures.

  * delta → frontier seed, per program class:

      - **insertions, any idempotent program** — monotone aggregators
        (MIN/MAX/OR) can only improve and current values stay achievable
        on the patched graph, so re-activating the inserted edges'
        endpoints with their CURRENT values suffices.
      - **deletions, label-like programs** (``cc``, ``labelprop``,
        ``reachability``: combine forwards the value) — a bounded BFS on
        the patched graph asks whether the deleted edge's endpoints are
        still connected.  Reconnected ⇒ the old fixpoint is still THE
        fixpoint: no-op.  Otherwise the old component (every vertex
        sharing the endpoint's label) resets to program-init and
        re-activates; components are edge-closed, so nothing outside
        needs to resend.
      - **deletions, gradient-like programs** (``sssp``, ``bfs``,
        ``widest_path``) — the *stale closure*: seed with deleted edges
        (u,v) whose message ``combine(value(u), w_uv)`` bitwise-equals
        ``value(v)``, close under the same test along patched-graph
        edges, reset the closure to init and activate it PLUS its
        patched-graph neighbors (the intact frontier re-sends valid
        values into the reset region).
      - **pagerank (push mode, SUM)** — the engine keeps ``r = b − p +
        d·Pᵀp`` at quiescence; patch the residual in place for every
        endpoint whose out-list changed (float64 on the host, then
        float32) and re-activate ``|r| > push_eps``.  Restart-vector
        independent, so cached personalized-pagerank sessions are patched
        the same way.
      - **fallback** — weighted pagerank re-normalizes transition weights
        globally on any topology change, so it takes a fresh init state
        on the patched graph.

    After seeding, :meth:`EngineSession.rebase_recovery` makes the seeded
    state the recovery floor: pre-delta snapshots and logged messages
    describe the OLD graph.

  * :class:`QueryServer` — slot-based batching: queries admit into a fixed
    number of slots, each step answers every admitted query of one kind
    through ONE vectorized store lookup.  ``top_k_near(v)`` is served by a
    cached personalized-pagerank session whose residual is delta-patched
    alongside the main sessions.

Serving under load:

  * **double-buffered epochs** — :meth:`GraphServer.begin_delta` opens a
    :class:`DeltaTransaction`: every session is ``fork()``-ed, the shadow
    is seeded and ticked while queries keep reading the COMMITTED epoch N;
    :meth:`DeltaTransaction.commit` swaps sessions, graph and the
    published view to epoch N+1 at once.
  * **reader-pinned GC** — every query batch reads through ONE pinned
    :class:`~repro_torch.serve.store.FixpointView` from
    :meth:`GraphServer.reader`, so a batch never mixes epochs.
  * **admission control + deadlines** — a bounded
    :class:`~repro_torch.serve.engine.AdmissionQueue`: a full queue
    rejects with a typed ``QueueFullError``, an overdue query retires with
    a typed ``DeadlineExceeded``.  ``stats()`` snapshots the counters and
    the freshness lag (begun deltas the answering epoch has not absorbed).
  * **LRU+TTL PPR cache** — a delta *invalidates* cached sessions without
    dropping them: the next access patches the warm session in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import GraphConfig
from repro_torch.core import programs as prog_mod
from repro_torch.core.engine import EngineSession, EngineState, init_state
from repro_torch.core.graph import (EdgeDelta, ShardedGraph, apply_edge_delta,
                                    build_sharded_graph, normalize_weights)
from repro_torch.dist.sharding import vertex_partition
from repro_torch.serve.cache import LRUTTLCache
from repro_torch.serve.engine import AdmissionQueue, DeadlineExceeded
from repro_torch.serve.store import FixpointStore, FixpointView

# query kind -> the program whose fixpoint answers it
KIND_PROGRAM = {"component_of": "cc", "distance": "sssp", "rank": "pagerank"}

# combine forwards the value unchanged => value-equality closure
# degenerates to "the whole component"; these take the connectivity
# shortcut instead (see module docstring)
LABEL_LIKE = frozenset({"cc", "labelprop", "reachability"})


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor that the caller may write to."""
    return x.detach().cpu().numpy().copy()


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ======================================================================
# Host-side graph probes (delta seeding works on tiny, delta-local sets;
# python loops over them are far cheaper than any device round-trip)
# ======================================================================
def _nbr_row(graph: ShardedGraph, u: int,
             with_weights: bool = False):
    """u's out-edges (global dst ids, optionally weights) from the CSR."""
    p, l = int(u) // graph.vs, int(u) % graph.vs
    lo, hi = int(graph.row_ptr[p, l]), int(graph.row_ptr[p, l + 1])
    dst = graph.col_idx[p, lo:hi].astype(np.int64)
    if not with_weights:
        return dst
    w = (graph.weights[p, lo:hi].astype(np.float32)
         if graph.weights is not None else np.ones(len(dst), np.float32))
    return dst, w


def _edge_weight(graph: ShardedGraph, u: int, v: int) -> float:
    dst, w = _nbr_row(graph, u, with_weights=True)
    hit = np.nonzero(dst == v)[0]
    if not len(hit):
        raise KeyError(f"edge ({u}, {v}) not in graph")
    return float(w[hit[0]])


def _reconnected(graph: ShardedGraph, u: int, v: int,
                 budget: int = 256) -> bool:
    """Bounded BFS u→v on the patched graph.  True is a proof (the
    deleted edge was redundant); False is conservative — "not provably
    reconnected within ``budget`` visited vertices"."""
    u, v = int(u), int(v)
    seen = {u}
    frontier = [u]
    while frontier and len(seen) <= budget:
        nxt: list[int] = []
        for x in frontier:
            for w in _nbr_row(graph, x):
                w = int(w)
                if w == v:
                    return True
                if w not in seen:
                    seen.add(w)
                    nxt.append(w)
        frontier = nxt
    return False


def _combine_msgs(prog, vflat: np.ndarray, x: int, nbrs: np.ndarray,
                  w: np.ndarray) -> np.ndarray:
    """What x's current value would deliver to each neighbor — the
    engine's own combine on small CPU tensors, so the equality test below
    is bitwise."""
    msg = prog.combine(
        torch.from_numpy(vflat[x:x + 1].reshape(1, 1).copy()),
        torch.from_numpy(w[None, :].copy()) if prog.weighted else None)
    msg = msg.numpy().reshape(-1)
    if msg.size == 1:  # unweighted combine broadcasts one message to all
        msg = np.full(len(nbrs), msg[0], msg.dtype)
    return msg


def _value_closure(prog, new_graph: ShardedGraph, vflat: np.ndarray,
                   seeds) -> np.ndarray:
    """Close the suspect set under "w's value equals what suspect x
    delivers over a surviving edge" — every vertex whose value might be
    (transitively) supported by a deleted edge."""
    suspects = {int(s) for s in seeds}
    frontier = sorted(suspects)
    while frontier:
        nxt: list[int] = []
        for x in frontier:
            nbrs, w = _nbr_row(new_graph, x, with_weights=True)
            if not len(nbrs):
                continue
            msg = _combine_msgs(prog, vflat, x, nbrs, w)
            for wv in nbrs[msg == vflat[nbrs]]:
                wv = int(wv)
                if wv not in suspects:
                    suspects.add(wv)
                    nxt.append(wv)
        frontier = nxt
    return np.fromiter(suspects, np.int64, len(suspects))


# ======================================================================
# Frontier seeding (one function per branch of the decision tree)
# ======================================================================
def seed_idempotent_delta(prog, old_graph: ShardedGraph,
                          new_graph: ShardedGraph, core: EngineState,
                          dinfo: EdgeDelta) -> tuple[EngineState, int]:
    """Insertion endpoints + deletion stale-reset for MIN/MAX/OR
    programs.  Returns (seeded core state on the state's device,
    #vertices re-activated)."""
    P_, vs = new_graph.num_shards, new_graph.vs
    n_pad = P_ * vs
    dev = core.values.device
    vflat = _host(core.values).reshape(-1)
    aflat = np.zeros(n_pad, bool)
    cflat = _host(core.cursor).reshape(-1)

    if len(dinfo.deleted):
        gids = torch.arange(n_pad, dtype=torch.int32).reshape(P_, vs)
        valid = gids < new_graph.num_real_vertices
        init_vals, _ = prog.init(gids, valid)
        iflat = init_vals.numpy().reshape(-1)
        if prog.name in LABEL_LIKE:
            suspects: set[int] = set()
            # one direction per undirected deleted pair is enough
            for u, v in dinfo.deleted[dinfo.deleted[:, 0]
                                      < dinfo.deleted[:, 1]]:
                if vflat[u] != vflat[v]:
                    continue  # fixpoint labels agree across an edge
                if vflat[u] == iflat[u] and vflat[v] == iflat[v]:
                    continue  # never improved (reachability's 0-region)
                if int(u) in suspects or _reconnected(new_graph, u, v):
                    continue
                # the old component: everything sharing u's label
                comp = np.nonzero(vflat == vflat[u])[0]
                suspects.update(int(c) for c in comp
                                if c < new_graph.num_real_vertices)
            suspects = np.fromiter(suspects, np.int64, len(suspects))
            neighbors = np.zeros(0, np.int64)  # components are edge-closed
        else:
            seeds = []
            for u, v in dinfo.deleted:
                w_uv = np.asarray([_edge_weight(old_graph, u, v)],
                                  np.float32)
                msg = _combine_msgs(prog, vflat, int(u),
                                    np.asarray([v], np.int64), w_uv)
                if msg[0] == vflat[v]:
                    seeds.append(int(v))
            suspects = _value_closure(prog, new_graph, vflat, seeds)
            neighbors = (np.unique(np.concatenate(
                [_nbr_row(new_graph, s) for s in suspects]))
                if len(suspects) else np.zeros(0, np.int64))
        if len(suspects):
            vflat[suspects] = iflat[suspects]
            aflat[suspects] = True
            aflat[neighbors] = True

    if len(dinfo.inserted):
        aflat[np.unique(dinfo.inserted)] = True

    cflat[aflat] = 0
    reactivated = int(aflat.sum())
    seeded = core._replace(
        values=_put(vflat.reshape(P_, vs), dev),
        active=_put(aflat.reshape(P_, vs), dev),
        cursor=_put(cflat.reshape(P_, vs).astype(np.int32), dev))
    return seeded, reactivated


def seed_pagerank_delta(prog, damping: float, old_graph: ShardedGraph,
                        new_graph: ShardedGraph, core: EngineState,
                        dinfo: EdgeDelta) -> tuple[EngineState, int]:
    """Residual invariant repair (see module docstring): at quiescence
    ``r = b − p + d·Pᵀ_old·p`` exactly, so adding
    ``d·(Pᵀ_new − Pᵀ_old)·p`` — supported only on the changed endpoints'
    out-columns — yields the patched-graph residual without touching
    banked mass.  Works for any restart vector b."""
    P_, vs = new_graph.num_shards, new_graph.vs
    dev = core.values.device
    vflat = _host(core.values).reshape(-1).astype(np.float64)
    aux = _host(core.aux)  # [P, 2, vs]
    res = aux[:, 0, :].reshape(-1).astype(np.float64)
    for u in dinfo.endpoints:
        p_u = vflat[u]
        if p_u == 0.0:
            continue
        old_nbrs = _nbr_row(old_graph, u)
        new_nbrs = _nbr_row(new_graph, u)
        if len(old_nbrs):
            np.add.at(res, old_nbrs, -damping * p_u / len(old_nbrs))
        if len(new_nbrs):
            np.add.at(res, new_nbrs, damping * p_u / len(new_nbrs))
    res32 = res.astype(np.float32)
    aflat = np.abs(res32) > prog.push_eps
    aux[:, 0, :] = res32.reshape(P_, vs)
    cflat = _host(core.cursor).reshape(-1)
    cflat[aflat] = 0
    reactivated = int(aflat.sum())
    seeded = core._replace(
        active=_put(aflat.reshape(P_, vs), dev),
        cursor=_put(cflat.reshape(P_, vs).astype(np.int32), dev),
        aux=_put(aux, dev))
    return seeded, reactivated


# ======================================================================
# The server
# ======================================================================
class DeltaStats(NamedTuple):
    program: str
    reactivated: int  # frontier size seeded by the delta
    ticks: int  # ticks to re-quiesce (the freshness lag)
    full_reseed: bool  # fell back to from-scratch seeding


class PPREntry:
    """One cached personalized-pagerank session plus its pending
    delta-repair records.  A delta marks the entry stale by appending
    ``(old_graph, new_graph, dinfo)``; the next access applies the
    residual repairs in sequence (they compose without ticking) and
    reconverges the WARM session — never from scratch."""

    __slots__ = ("session", "pending")

    def __init__(self, session: EngineSession):
        self.session = session
        self.pending: list[tuple[ShardedGraph, ShardedGraph, EdgeDelta]] = []


class LiveView(NamedTuple):
    """Store-less analogue of a pinned ``FixpointView``: host copies of
    every primary session's values, captured in one grab of
    ``GraphServer.sessions`` (sessions are swapped wholesale at delta
    commit and no tick writes a tensor in place, so the captured planes
    never change under the reader)."""
    values: dict  # program -> flat np.ndarray [n_pad]
    part: object  # VertexPartition (bounds check, same rule as store)
    deltas_visible: int
    epoch: Optional[int]

    def lookup(self, name: str, vertex_ids) -> np.ndarray:
        if name not in self.values:
            raise KeyError(f"program {name!r} not served; "
                           f"have {sorted(self.values)}")
        ids = np.atleast_1d(np.asarray(vertex_ids, np.int64))
        self.part.locate(ids)  # bounds check
        return self.values[name][ids]


class DeltaTransaction:
    """One in-flight streaming delta, double-buffered.

    Construction patches the CSR and seeds a ``fork()`` of every
    primary session with the delta frontier; :meth:`step` ticks the
    shadows (interleave query batches between calls), :meth:`commit`
    swaps shadows/graph/epoch in.  Until commit, the server's primary
    sessions, committed store view, and ``graph`` attribute are
    untouched — readers stay on epoch N.  ``patch_s`` is the host time
    ``apply_edge_delta`` took."""

    def __init__(self, server: "GraphServer", insertions=(), deletions=()):
        self.server = server
        self.old_graph = server.graph
        t0 = time.perf_counter()
        new_graph, dinfo = apply_edge_delta(
            self.old_graph, insertions, deletions, seed=server._delta_seed)
        self.patch_s = time.perf_counter() - t0
        server._delta_seed += 1
        self.new_graph, self.dinfo = new_graph, dinfo
        self.changed = bool(len(dinfo.inserted) + len(dinfo.deleted))
        self.committed = False
        self.shadows: dict[str, EngineSession] = {}
        self._seeded: dict[str, tuple[int, bool]] = {}
        self._t0: dict[str, int] = {}
        if self.changed:
            for name, sess in server.sessions.items():
                shadow = sess.fork()
                self._t0[name] = shadow.totals["ticks"]
                reactivated, full = server._reseed(
                    name, shadow, self.old_graph, new_graph, dinfo)
                shadow.rebase_recovery()
                self.shadows[name] = shadow
                self._seeded[name] = (reactivated, full)

    @property
    def done(self) -> bool:
        return (not self.changed) or all(s.quiescent
                                         for s in self.shadows.values())

    def step(self, ticks: int = 1) -> bool:
        """Tick every non-quiescent shadow up to ``ticks`` times;
        returns :attr:`done`.  Queries served between calls read the
        committed epoch untouched — this is the freshness lag."""
        for shadow in self.shadows.values():
            for _ in range(ticks):
                if shadow.quiescent:
                    break
                shadow.step()
        return self.done

    def run(self, budget: Optional[int] = None) -> bool:
        """Drive every shadow to quiescence (``budget`` ticks per
        session, default ``cfg.max_ticks``) — the synchronous path
        ``apply_delta`` uses."""
        for shadow in self.shadows.values():
            shadow.tick_until_quiescent(budget)
        return self.done

    def commit(self) -> dict[str, DeltaStats]:
        """Swap the shadows in: sessions, graph, PPR-cache invalidation,
        epoch publish + view flip — the single instant readers move from
        epoch N to N+1."""
        if not self.done:
            raise RuntimeError("delta transaction not quiescent; "
                               "step() or run() it to completion first")
        if self.committed:
            raise RuntimeError("delta transaction already committed")
        server = self.server
        if self.changed:
            stats = {}
            for name, shadow in self.shadows.items():
                reactivated, full = self._seeded[name]
                stats[name] = DeltaStats(
                    name, reactivated,
                    shadow.totals["ticks"] - self._t0[name], full)
            server.sessions = self.shadows
            # stale-but-warm: cached PPR sessions get a repair record,
            # not an eviction (the residual fix is restart-independent)
            rec = (self.old_graph, self.new_graph, self.dinfo)
            server._ppr.invalidate(lambda entry: entry.pending.append(rec))
        else:
            stats = {name: DeltaStats(name, 0, 0, False)
                     for name in server.sessions}
        server.graph = self.new_graph
        server.deltas_applied += 1
        server.last_delta = stats
        server._txn = None
        self.committed = True
        server.publish()
        return stats


class GraphServer:
    """Multi-program engine sessions over one shared mutable graph.

    ``programs`` — algorithm names from the program registry; each gets
    its own resumable session over the shared CSR.  ``weighted_rank``
    swaps pagerank onto per-source-normalized transition weights (its
    session then owns a normalized COPY of the graph, re-derived — and
    fully re-seeded — on every delta: the documented fallback branch).
    ``store_dir`` enables the epoch-versioned :class:`FixpointStore`;
    queries then read committed epochs, not live session state.
    ``graph`` — the config's graph if the caller has built it already
    (else it is built from ``cfg``).  ``device=None`` means the CUDA card
    (raises without one); ``"cpu"`` runs on the host.
    """

    def __init__(self, cfg: GraphConfig, programs=("cc",),
                 store_dir: Optional[str] = None, keep_epochs: int = 2,
                 fault_plan=None, schedule: Optional[str] = None,
                 weighted_rank: bool = False, ppr_cache: int = 16,
                 ppr_ttl: Optional[float] = None,
                 clock=time.monotonic, *,
                 graph: Optional[ShardedGraph] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.graph = graph if graph is not None else build_sharded_graph(cfg)
        self.part = vertex_partition(self.graph.num_real_vertices,
                                     self.graph.num_shards)
        if self.part.vs != self.graph.vs:
            raise ValueError(f"graph layout {self.graph.vs} diverged from "
                             f"the partition rule {self.part}")
        self.weighted_rank = weighted_rank
        self.sessions: dict[str, EngineSession] = {}
        for name in programs:
            pcfg = dataclasses.replace(cfg, algorithm=name)
            if name == "pagerank" and weighted_rank:
                prog = prog_mod.get_program("pagerank",
                                            damping=cfg.damping,
                                            weighted=True)
                g = normalize_weights(self.graph)
            else:
                prog, g = prog_mod.get_program(pcfg), self.graph
            self.sessions[name] = EngineSession(
                pcfg, graph=g, prog=prog, fault_plan=fault_plan,
                schedule=schedule, device=self.device)
        self.store = (FixpointStore(store_dir, keep=keep_epochs)
                      if store_dir else None)
        self.epoch: Optional[int] = None
        self._view: Optional[FixpointView] = None
        self._prev_view: Optional[FixpointView] = None
        self._ppr = LRUTTLCache(capacity=ppr_cache, ttl=ppr_ttl,
                                clock=clock)
        self._delta_seed = 1 << 20  # weight stream disjoint from builder
        self.deltas_applied = 0  # committed mutations
        self.deltas_started = 0  # begun mutations (>= applied)
        self._txn: Optional[DeltaTransaction] = None
        self.last_delta: dict[str, DeltaStats] = {}

    @property
    def ppr_cache(self) -> LRUTTLCache:
        """The personalized-pagerank session cache (counters live on
        it: ``srv.ppr_cache.stats()``)."""
        return self._ppr

    # -- convergence + publishing --------------------------------------
    def converge(self, budget: Optional[int] = None) -> dict:
        out = {name: sess.tick_until_quiescent(budget)
               for name, sess in self.sessions.items()}
        self.publish()
        return out

    def publish(self) -> Optional[int]:
        """Commit every session's current fixpoint as a new epoch and
        flip the committed view to it.  Double-buffered: the PREVIOUS
        view stays pinned until the flip after next, so readers that
        grabbed it an instant before the flip finish their lazy loads
        against a retained epoch."""
        if self.store is None:
            return None
        fixpoints = {name: {"values": sess.state.values,
                            "aux": sess.state.aux}
                     for name, sess in self.sessions.items()}
        self.epoch = self.store.publish(
            fixpoints, self.part, meta={"deltas": self.deltas_applied})
        new_view = self.store.view(self.epoch)
        if self._prev_view is not None:
            self._prev_view.close()
        self._prev_view, self._view = self._view, new_view
        return self.epoch

    # -- point queries -------------------------------------------------
    @contextlib.contextmanager
    def reader(self):
        """Pinned read handle for one query batch: a ``FixpointView``
        on the committed epoch (store mode) or a :class:`LiveView`
        snapshot of the primary sessions (live mode).  Everything
        answered under one ``reader()`` is consistent with ONE epoch —
        the no-torn-reads guarantee — and the pin keeps GC away from
        the epoch for the batch's whole lifetime."""
        view = self._view
        if view is None:
            sessions = self.sessions  # one atomic grab (commit swaps it)
            yield LiveView(
                {n: s.state.values.reshape(-1).cpu().numpy()
                 for n, s in sessions.items()},
                self.part, self.deltas_applied, None)
            return
        while True:
            if self.store.pin(view.epoch):
                break
            view = self._view  # epoch flipped+collected under us: retry
        try:
            yield view
        finally:
            self.store.unpin(view.epoch)

    def freshness_lag(self, view) -> int:
        """Epoch age at read time: how many BEGUN mutations the epoch
        the reader is answering from has not yet absorbed (0 = fully
        fresh; 1 while a delta transaction is in flight)."""
        if isinstance(view, LiveView):
            visible = view.deltas_visible
        else:
            visible = int(view.manifest.get("meta", {}).get("deltas", 0))
        return self.deltas_started - visible

    def lookup(self, program: str, vertex_ids,
               view=None) -> np.ndarray:
        """Batched fixpoint lookup, through the committed epoch when a
        store is attached (the ``FixpointView`` path), else live (a
        gather on the device, copied to the host).  Pass a ``reader()``
        view to pin a whole batch to one epoch."""
        if view is not None:
            return view.lookup(program, vertex_ids)
        if program not in self.sessions:
            raise KeyError(f"program {program!r} not served; "
                           f"have {sorted(self.sessions)}")
        ids = np.atleast_1d(np.asarray(vertex_ids, np.int64))
        if self._view is not None:
            return self._view.lookup(program, ids)
        self.part.locate(ids)  # bounds check, same rule as the store
        flat = self.sessions[program].state.values.reshape(-1)
        return flat[torch.from_numpy(ids).to(flat.device)].cpu().numpy()

    def component_of(self, v):
        return self.lookup("cc", v)

    def distance(self, v):
        return self.lookup("sssp", v)

    def rank(self, v):
        return self.lookup("pagerank", v)

    def top_k_near(self, v: int, k: int = 8) -> list[tuple[int, float]]:
        """k highest personalized-pagerank vertices around v (v's own
        mass included — it holds the restart probability).  Served by
        the LRU+TTL PPR session cache; a delta-invalidated entry is
        repaired IN PLACE (restart-independent residual fix + warm
        reconvergence) on first re-access.  Deterministic ties break
        toward lower id."""
        v = int(v)
        entry = self._ppr.get(v)
        if entry is None:
            pcfg = dataclasses.replace(self.cfg, algorithm="pagerank")
            prog = prog_mod.get_program("pagerank", damping=self.cfg.damping,
                                        restart=v)
            sess = EngineSession(pcfg, graph=self.graph, prog=prog,
                                 device=self.device)
            sess.tick_until_quiescent()
            entry = PPREntry(sess)
            self._ppr.put(v, entry)
        elif entry.pending:
            self._repair_ppr(entry)
        sess = entry.session
        n = self.graph.num_real_vertices
        ranks = sess.state.values.reshape(-1)[:n].cpu().numpy()
        order = np.lexsort((np.arange(n), -ranks))[:k]
        return [(int(i), float(ranks[i])) for i in order]

    def _repair_ppr(self, entry: PPREntry,
                    budget: Optional[int] = None) -> None:
        """Apply every queued delta repair to a warm PPR session: the
        residual corrections compose without intermediate ticking (each
        re-establishes ``r = b − p + d·Pᵀp`` for its patched graph with
        ``p`` untouched), then one reconvergence drains them all."""
        sess = entry.session
        for old_g, new_g, dinfo in entry.pending:
            seeded, _ = seed_pagerank_delta(
                sess.prog, self.cfg.damping, old_g, new_g,
                sess.state, dinfo)
            sess.rebind_graph(new_g)
            sess.replace_state(seeded)
        entry.pending.clear()
        sess.tick_until_quiescent(budget)

    # -- the streaming mutation path -----------------------------------
    def begin_delta(self, insertions=(), deletions=()) -> DeltaTransaction:
        """Open a double-buffered delta: fork + seed shadow sessions,
        leave the committed epoch serving.  One transaction at a time —
        the shadow IS the next epoch, there is no third buffer."""
        if self._txn is not None and not self._txn.committed:
            raise RuntimeError("a delta transaction is already in flight; "
                               "commit() it before beginning another")
        self.deltas_started += 1
        self._txn = DeltaTransaction(self, insertions, deletions)
        return self._txn

    def apply_delta(self, insertions=(), deletions=(),
                    budget: Optional[int] = None) -> dict[str, DeltaStats]:
        """Patch the CSR once, re-seed every (forked) session's frontier
        with the delta-touched work, tick back to quiescence, commit —
        the synchronous wrapper over begin_delta/run/commit.  Queries
        issued concurrently keep answering from the prior epoch."""
        txn = self.begin_delta(insertions, deletions)
        txn.run(budget)
        return txn.commit()

    def _reseed(self, name: str, sess: EngineSession,
                old_graph: ShardedGraph, new_graph: ShardedGraph,
                dinfo: EdgeDelta) -> tuple[int, bool]:
        prog = sess.prog
        if name == "pagerank" and self.weighted_rank:
            # normalization is global on any topology change: fallback
            g = normalize_weights(new_graph)
            sess.rebind_graph(g)
            seeded = init_state(prog, g, self.device)
            sess.replace_state(seeded)
            return int(seeded.active.sum()), True
        if prog.aux_channels:  # push mode: residual invariant repair
            seeded, reactivated = seed_pagerank_delta(
                prog, self.cfg.damping, old_graph, new_graph,
                sess.state, dinfo)
        else:
            seeded, reactivated = seed_idempotent_delta(
                prog, old_graph, new_graph, sess.state, dinfo)
        sess.rebind_graph(new_graph)
        sess.replace_state(seeded)
        return reactivated, False


# ======================================================================
# Slot-based query batching
# ======================================================================
class GraphQuery(NamedTuple):
    rid: int
    kind: str  # component_of | distance | rank | top_k_near
    vertex: int
    k: int = 8
    deadline_s: Optional[float] = None  # per-query budget override


class QueryServer:
    """Continuous batching for point queries: fixed slots, greedy
    refill, one vectorized store lookup per (kind, step).

    The wait queue is the bounded
    :class:`~repro_torch.serve.engine.AdmissionQueue` — ``submit`` past
    ``max_queue`` raises ``QueueFullError`` (typed backpressure; nothing
    is silently dropped).  Each query carries a deadline budget (its own
    ``deadline_s`` or the server default): a query still unanswered when
    it expires retires with a typed ``DeadlineExceeded`` answer and frees
    its slot.  Every batch is answered under ONE pinned
    ``GraphServer.reader()`` view, and the freshness lag (begun but
    unabsorbed deltas at read time) is tracked per batch."""

    def __init__(self, server: GraphServer, num_slots: int = 16,
                 max_queue: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 clock=time.monotonic):
        self.server = server
        self.num_slots = num_slots
        self.deadline_s = deadline_s
        self.clock = clock
        self.queue = AdmissionQueue(max_queue=max_queue, clock=clock)
        # slot -> (query, enqueued_at, absolute deadline or None)
        self.active: dict[int, tuple[GraphQuery, float,
                                     Optional[float]]] = {}
        self.done: dict[int, object] = {}  # rid -> answer (typed)
        self.batches = 0
        self.served = 0
        self.deadline_exceeded = 0
        self.lag_last = 0
        self.lag_max = 0
        self._lag_sum = 0

    def submit(self, q: GraphQuery) -> None:
        """Enqueue one query.  Raises ``ValueError`` on an unknown kind
        and ``QueueFullError`` when admission is at capacity."""
        if q.kind != "top_k_near" and q.kind not in KIND_PROGRAM:
            raise ValueError(f"unknown query kind {q.kind!r}")
        budget = q.deadline_s if q.deadline_s is not None else self.deadline_s
        self.queue.push(q, budget)

    def _admit(self) -> None:
        free = [s for s in range(self.num_slots) if s not in self.active]
        admitted, expired = self.queue.pop_ready(len(free))
        for q, waited in expired:
            self.done[q.rid] = DeadlineExceeded(q.rid, q.kind, waited)
            self.deadline_exceeded += 1
        for (q, enq, deadline) in admitted:
            self.active[free.pop(0)] = (q, enq, deadline)

    def _expire_slots(self) -> None:
        """Retire admitted-but-overdue queries with the typed answer —
        slot state stays clean for the rest of the batch."""
        now = self.clock()
        for slot, (q, enq, deadline) in list(self.active.items()):
            if deadline is not None and now > deadline:
                self.done[q.rid] = DeadlineExceeded(q.rid, q.kind,
                                                    now - enq)
                self.deadline_exceeded += 1
                del self.active[slot]

    def step(self) -> None:
        """Admit + answer one batch: every admitted query of the same
        kind shares a single vectorized lookup through one pinned
        epoch view."""
        self._admit()
        self._expire_slots()
        if not self.active:
            return
        by_kind: dict[str, list[GraphQuery]] = {}
        for q, _, _ in self.active.values():
            by_kind.setdefault(q.kind, []).append(q)
        with self.server.reader() as view:
            lag = self.server.freshness_lag(view)
            for kind, batch in sorted(by_kind.items()):
                if kind == "top_k_near":
                    for q in batch:
                        self.done[q.rid] = self.server.top_k_near(q.vertex,
                                                                 q.k)
                else:
                    ids = np.asarray([q.vertex for q in batch], np.int64)
                    vals = self.server.lookup(KIND_PROGRAM[kind], ids,
                                              view=view)
                    for q, val in zip(batch, vals):
                        self.done[q.rid] = (float(val)
                                            if vals.dtype.kind == "f"
                                            else int(val))
        self.served += len(self.active)
        self.lag_last = lag
        self.lag_max = max(self.lag_max, lag)
        self._lag_sum += lag
        self.active.clear()
        self.batches += 1

    def run(self) -> dict[int, object]:
        while len(self.queue) or self.active:
            self.step()
        return self.done

    def stats(self) -> dict:
        """Backpressure / deadline / freshness snapshot (plus the PPR
        cache counters, which this server's ``top_k_near`` traffic
        drives)."""
        return {"submitted": self.queue.submitted,
                "rejected": self.queue.rejected,
                "deadline_exceeded": self.deadline_exceeded,
                "served": self.served, "batches": self.batches,
                "queued": len(self.queue),
                "freshness_lag_last": self.lag_last,
                "freshness_lag_max": self.lag_max,
                "freshness_lag_mean": (self._lag_sum / self.batches
                                       if self.batches else 0.0),
                "ppr_cache": self.server.ppr_cache.stats()}
