"""The ASYMP engine: priority-driven asynchronous-style propagation ticks.

Counterpart of ``repro.core.engine`` on the local transport.  One tick,
for all shards at once (tensors carry the shard axis first: ``[P, vs]``
vertex state, ``[P, M, D]`` fetch windows, ``[P, Pn, cap]`` send buffers —
the JAX package's ``vmap`` written out as a batch axis):

  select   — per-shard priority queue: bucketized priorities (linear/log,
             §3.5), enforcement fraction rho (§5.6), top-M cap
  fetch    — streamed adjacency window per selected vertex (edge cursor)
  create   — program.combine over the fetched edges
  route    — bucket messages by destination shard into fixed-capacity
             buffers; overflow => the sender retries next tick
  receive  — idempotent scatter-⊕ via the program's Aggregator; improved
             vertices join the frontier (on the card one hand kernel,
             ``kernels/receive.py``)

Push mode (pagerank, the non-idempotent SUM aggregator) moves mass
instead: a selected vertex latches its residual, banks it into
``values`` exactly once, and ships only the edge prefix its cursor
commits to; receives scatter-add into the residual plane (``aux``).

Three tick builders share those phases: ``make_local_tick`` (the plain
synchronous tick), ``make_crowded_tick`` (paper §5.4: messages cross the
delay ring, crowded shards get throttled budgets, work activated over a
slow link is demoted) and ``make_async_tick`` (no tick barrier: each
shard fires on its own seeded steps and keeps a logical clock).
``EngineSession`` drives any of them, with fault plans
(``core/faults.py``) and their slowdowns.

The states and counters after every tick are bitwise those of the JAX
package on the CPU (``tests/test_torch_engine.py``,
``tests/test_torch_pagerank.py``, ``tests/test_torch_crowded.py``,
``tests/test_torch_async.py``).

The multi-rank ticks (``make_dist_tick``, ``make_crowded_dist_tick``,
``make_async_dist_tick``) run the same phases on one rank of a
``torch.distributed`` group (``launch/mesh.py::make_worker_group``), one
shard per rank, exchanging through ``exchange_dist(_delayed)``; on the CPU
with gloo ranks they are bitwise the JAX package's dist ticks on a mesh of
as many devices (``tests/test_torch_dist.py``).  ``lower_tick_for_mesh``
is their dry run: the derived sizes and one rank's tick traced on fake
tensors at any number of ranks.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import _trace
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import GraphConfig
from repro_torch.core import programs as prog_mod
from repro_torch.core.graph import ShardedGraph, build_sharded_graph
from repro_torch.dist import exchange as ex_mod
from repro_torch.kernels import receive

N_BUCKETS = 32

_I32 = torch.int32


class EngineState(NamedTuple):
    values: torch.Tensor  # [P, vs]
    active: torch.Tensor  # [P, vs] bool
    cursor: torch.Tensor  # [P, vs] int32 — adjacency streaming position
    tick: torch.Tensor  # scalar int32
    # push-mode sidecar planes [P, aux_channels, vs] (None for idempotent
    # programs): aux[:, 0] = residual, aux[:, 1] = latched mass mid-push.
    # Checkpoints and restores carry it: it is program state.
    aux: Optional[torch.Tensor] = None


class ShardGraph(NamedTuple):
    row_ptr: torch.Tensor  # [P, vs+1] int32
    col_idx: torch.Tensor  # [P, es] int32
    weights: Optional[torch.Tensor]  # [P, es] f32 | None


class TickStats(NamedTuple):
    active: torch.Tensor  # vertices active after tick
    sent: torch.Tensor  # messages sent
    accepted: torch.Tensor  # messages that improved a value
    fetched: torch.Tensor  # edges fetched (seek rate, Fig 10)


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Static knobs."""
    num_shards: int
    vs: int
    max_vertices_per_tick: int  # M
    degree_window: int  # D_cap (edges streamed per vertex per tick)
    route_capacity: int  # per-destination-shard message slots
    enforce_fraction: float  # rho (paper: 100/10/5/2.5%)
    priority: str  # disabled | linear | log
    priority_scale: float  # normalization for bucketing
    wire_compression: str = "none"  # effective wire mode (pre-gated)
    wire_value_bound: int = 0  # int-payload bound gating lossless narrowing
    # straggler-aware scheduling (crowded and async ticks only): bucket
    # penalty for frontier work activated over a slow link (0 = off)
    straggler_demote: int = 0


def wire_codec(prog, ep: EngineParams) -> ex_mod.WireCodec:
    """The exchange substrate's codec for this engine configuration
    (``ep.wire_compression`` is already the gated mode)."""
    return ex_mod.make_wire_codec(
        num_shards=ep.num_shards, capacity=ep.route_capacity, vs=ep.vs,
        requested=ep.wire_compression, value_kind=prog.dtype,
        identity=prog.identity, max_int_value=ep.wire_value_bound,
        quantize_direction=prog.aggregator.quantize_direction,
        idempotent=prog.aggregator.idempotent)


def derive_params(cfg: GraphConfig, *, num_shards: int, vs: int, es: int,
                  num_vertices: int, prog) -> EngineParams:
    """THE EngineParams derivation (the same formulas as the JAX
    package's, held equal by the parity tests)."""
    budget = cfg.edge_budget or max(es // 4, 256)
    d_cap = max(min(cfg.avg_degree, 64), 4)
    m = int(min(max(budget // d_cap, 16), vs))
    cap = cfg.route_capacity or max(budget // num_shards
                                    + budget // (4 * num_shards), 64)
    bound = prog.wire_bound(num_vertices)
    wire = ex_mod.effective_compression(cfg.wire_compression, prog.dtype,
                                        bound, prog.aggregator.idempotent)
    return EngineParams(
        num_shards=num_shards, vs=vs, max_vertices_per_tick=m,
        degree_window=d_cap, route_capacity=int(cap),
        enforce_fraction=cfg.enforce_fraction, priority=cfg.priority,
        priority_scale=prog.priority_scale or float(num_vertices),
        wire_compression=wire, wire_value_bound=bound,
        straggler_demote=getattr(cfg, "straggler_demote", 0))


def default_params(cfg: GraphConfig, graph: ShardedGraph,
                   prog=None) -> EngineParams:
    prog = prog or prog_mod.get_program(cfg)
    return derive_params(cfg, num_shards=graph.num_shards, vs=graph.vs,
                         es=graph.es, num_vertices=graph.num_vertices,
                         prog=prog)


# ======================================================================
# Priority bucketing (§3.5: linear vs log; disabled = arbitrary order)
# ======================================================================
# Log buckets: the reference computes floor(log2(1 + x * (2**32 - 1))) in
# float32, with log2 as log(y) / log(2) and XLA's own float32 log.  That
# log is within an ulp of exact but not correctly rounded, and near the
# bucket edges an ulp moves a vertex to the next bucket (e.g. pv = 32 at
# scale 1024 lands in bucket 26, where a correctly rounded log2 says 27).
# The bucket is a monotone step function of x = clip(pv, 0, scale) /
# scale, so it is fixed by its 31 edges: _LOG_BUCKET_EDGES[k - 1] is the
# smallest float32 x (as bits) that the reference puts in bucket >= k.
# Counting the edges at or below x reproduces the reference's buckets
# exactly, on any device (tests/test_torch_engine.py re-derives the edges
# from the JAX package and sweeps the bucketing against it).
_LOG_BUCKET_EDGES = (
    0x2f7fffff, 0x30400000, 0x30dfffff, 0x316fffff, 0x31f7ffff, 0x327bfffd,
    0x32fdfffd, 0x337efffd, 0x33ff7ffd, 0x347fbffd, 0x34ffdffd, 0x357feff9,
    0x35fff802, 0x367ffbf9, 0x36fffe02, 0x377ffef9, 0x37ffff71, 0x387fffb9,
    0x38ffffd1, 0x397fffe9, 0x39ffffe9, 0x3a7ffff5, 0x3affffef, 0x3b7ffff0,
    0x3bfffff9, 0x3c800001, 0x3d000005, 0x3d7ffff1, 0x3dfffff9, 0x3e800001,
    0x3f000005)


@functools.lru_cache(maxsize=None)
def _log_bucket_edges(device: torch.device) -> torch.Tensor:
    bits = torch.tensor(_LOG_BUCKET_EDGES, dtype=torch.int32)
    return bits.view(torch.float32).to(device)


def priority_buckets(pv: torch.Tensor, strategy: str,
                     scale: float) -> torch.Tensor:
    if strategy == "disabled":
        return torch.zeros(pv.shape, dtype=_I32, device=pv.device)
    # x = clip(pv, 0, scale) / scale as the reference computes it: XLA
    # rewrites the division by a constant into a product with its float32
    # reciprocal, which differs from a true division by an ulp at times
    recip = float(np.float32(1.0) / np.float32(scale))
    x = torch.clamp(pv, 0.0, scale) * recip  # [0, 1]
    if strategy == "linear":
        b = torch.floor(x * N_BUCKETS)
        return torch.clamp(b, 0, N_BUCKETS - 1).to(_I32)
    # log: reserve precision at the low end (paper Fig 9b)
    return torch.searchsorted(_log_bucket_edges(pv.device), x,
                              right=True).to(_I32)


# ======================================================================
# Tick phases, batched over the shard axis
# ======================================================================
def _drop_scatter(target: torch.Tensor, idx: torch.Tensor,
                  src) -> torch.Tensor:
    """``target.at[idx].set(src, mode="drop")`` along the last axis, where
    every index at or past the end drops (scatter into one spare slot)."""
    n = target.shape[-1]
    buf = torch.cat([target, target[..., :1]], dim=-1)
    idx = torch.clamp(idx, max=n).to(torch.int64)
    if not torch.is_tensor(src):
        src = torch.full(idx.shape, src, dtype=target.dtype,
                         device=target.device)
    buf.scatter_(-1, idx, src.to(target.dtype))
    return buf[..., :n]


def _phase1_create(prog, ep: EngineParams, values, active, cursor,
                   row_ptr, col_idx, weights, aux=None, throttle=None,
                   demote=None, stream_window=None):
    """Select + fetch + create + route for all P shards.  Returns
    ``(active, cursor, send_vals [P, Pn, cap], send_ids [P, Pn, cap],
    sent [P], fetched [P], values, aux)``; values and aux change only in
    push mode (``aux`` given).

    Crowded-cluster and async inputs, each per shard (all optional):
      * ``throttle [P]`` — work-budget divisor: a crowded shard selects at
        most ``M // throttle`` vertices a tick;
      * ``demote [P, vs]`` bool — frontier work activated over a slow link
        takes a bucket penalty of ``ep.straggler_demote``, so settled work
        drains first; the threshold still selects it when nothing
        healthier remains, so nothing starves;
      * ``stream_window [P]`` — edges fetched per selected vertex this call
        (``<= ep.degree_window``): the async schedule compiles a widened
        window and passes ``rate * D``, so one firing of a rate-k shard
        streams k steps' worth of edges.

    Push mode: a selected vertex not mid-push (latch 0 AND cursor 0)
    latches ``m = residual``, zeroes the residual and banks ``values +=
    m``, once per push however many ticks its edge stream takes.
    Messages carry ``combine(m, w, deg)``, and only the contiguous edge
    prefix up to the first routing drop ships: a kept edge after the drop
    is fetched again when the cursor resumes there, which would count its
    mass twice under SUM.  When the stream completes the latch clears and
    the vertex stays active iff its residual re-accumulated past
    ``push_eps``."""
    P = values.shape[0]
    vs, M, D = ep.vs, ep.max_vertices_per_tick, ep.degree_window
    Pn, cap = ep.num_shards, ep.route_capacity
    dev = values.device
    push_mode = aux is not None
    if push_mode:
        residual, pushv = aux[:, 0], aux[:, 1]

    # ---- select (priority queue with enforcement fraction) ----
    # bucket histogram + cumsum threshold + rank-by-cumsum (no [vs] sort)
    n_active = active.sum(dim=1, dtype=_I32)  # [P]
    target = torch.clamp(torch.ceil(n_active.to(torch.float32)
                                    * ep.enforce_fraction), 1, M)
    if throttle is not None:  # m_eff = max(M // throttle, 1), per shard
        m_eff = torch.clamp(M // torch.clamp(throttle, min=1), min=1)
        target = torch.minimum(target, m_eff.to(torch.float32))
    target = target.to(_I32)
    # push mode ranks by pending mass: residual + latched push
    potential = residual + pushv if push_mode else values
    if prog.bucketize is not None:
        buckets = prog.bucketize(potential, ep.priority, ep.priority_scale)
    else:
        pkey = prog.aggregator.priority_key(prog.priority_value(potential),
                                            ep.priority_scale)
        buckets = priority_buckets(pkey, ep.priority, ep.priority_scale)
    if demote is not None and ep.straggler_demote:
        buckets = torch.where(demote, torch.clamp(
            buckets + ep.straggler_demote, max=N_BUCKETS - 1), buckets)
    hist = torch.zeros((P, N_BUCKETS), dtype=_I32, device=dev).scatter_add_(
        1, buckets.to(torch.int64), active.to(_I32))
    cum = torch.cumsum(hist, dim=1, dtype=_I32)
    # first bucket covering the target
    thr = torch.searchsorted(cum, target[:, None].contiguous()).to(_I32)
    # strict two-tier rank: every vertex in buckets < thr outranks the
    # threshold bucket (within a bucket, index order)
    low = active & (buckets < thr)
    at_thr = active & (buckets == thr)
    n_low = torch.cumsum(low.to(_I32), dim=1, dtype=_I32)
    n_thr = torch.cumsum(at_thr.to(_I32), dim=1, dtype=_I32)
    total_low = n_low[:, -1:]
    rank_v = torch.where(low, n_low - 1, total_low + n_thr - 1)
    sel_mask = (low | at_thr) & (rank_v < target[:, None])
    # invalid slots get the out-of-bounds sentinel `vs` so downstream
    # scatters drop them (slot-0 fill would alias a real vertex)
    slot = torch.where(sel_mask, rank_v, M)
    sel = _drop_scatter(torch.full((P, M), vs, dtype=_I32, device=dev), slot,
                        torch.arange(vs, dtype=_I32, device=dev).expand(P, vs))
    sel_valid = _drop_scatter(torch.zeros((P, M), dtype=torch.bool,
                                          device=dev), slot, True)
    # overflow slots go to the best buckets first: a stable sort of the M
    # slots by bucket (identity permutation with priority disabled)
    slot_bucket = torch.where(
        sel_valid, torch.gather(buckets, 1,
                                torch.clamp(sel, max=vs - 1).to(torch.int64)),
        N_BUCKETS)
    reorder = torch.argsort(slot_bucket, dim=1, stable=True)
    sel = torch.gather(sel, 1, reorder)
    sel_valid = torch.gather(sel_valid, 1, reorder)
    sel_safe = torch.clamp(sel, max=vs - 1).to(torch.int64)  # for gathers

    # ---- fetch adjacency window (streamed via cursor) ----
    lo = torch.gather(row_ptr, 1, sel_safe)
    deg = torch.gather(row_ptr, 1, sel_safe + 1) - lo
    cur = torch.gather(cursor, 1, sel_safe)
    offs = torch.arange(D, dtype=_I32, device=dev)
    eidx = (lo + cur)[:, :, None] + offs  # [P, M, D]
    edge_valid = sel_valid[:, :, None] & ((cur[:, :, None] + offs)
                                          < deg[:, :, None])
    if stream_window is not None:
        edge_valid = edge_valid & (offs < stream_window[:, None, None])
    eidx_safe = torch.clamp(eidx, 0, col_idx.shape[1] - 1
                            ).reshape(P, M * D).to(torch.int64)
    dst = torch.where(edge_valid,
                      torch.gather(col_idx, 1, eidx_safe).reshape(P, M, D),
                      -1)  # global ids
    w = (torch.gather(weights, 1, eidx_safe).reshape(P, M, D)
         if weights is not None else None)

    # ---- create messages ----
    if push_mode:
        res_sel = torch.gather(residual, 1, sel_safe)
        push_sel = torch.gather(pushv, 1, sel_safe)
        latch = sel_valid & (push_sel == 0) & (cur == 0)
        mass = torch.where(latch, res_sel, push_sel)  # [P, M]
        msg = prog.combine(mass[:, :, None], w, deg[:, :, None]
                           ).expand(P, M, D)
    else:
        src_vals = torch.gather(values, 1, sel_safe)[:, :, None]  # [P, M, 1]
        msg = prog.combine(src_vals, w).expand(P, M, D)

    # ---- route: bucket by destination shard, bounded capacity ----
    L = M * D
    dst_shard = torch.where(dst >= 0, dst // vs, Pn)  # Pn = invalid bucket
    flat_shard = dst_shard.reshape(P, L)
    order2 = torch.argsort(flat_shard, dim=1, stable=True)
    so = torch.gather(flat_shard, 1, order2)
    starts = torch.searchsorted(
        so, torch.arange(Pn + 1, dtype=_I32, device=dev).expand(P, Pn + 1)
        .contiguous())
    rank_sorted = (torch.arange(L, device=dev)
                   - torch.gather(starts, 1, so.to(torch.int64)))
    # rank[order2[j]] = rank_sorted[j]: position within its shard's run
    rank = torch.empty_like(rank_sorted).scatter_(
        1, order2, rank_sorted).reshape(P, M, D)

    keep = edge_valid & (rank < cap)
    # first routing drop per vertex — the cursor stops there and retries
    dropped = edge_valid & ~keep
    first_drop = torch.where(dropped.any(dim=2),
                             torch.argmax(dropped.to(_I32), dim=2), D)
    if stream_window is not None:
        # the cursor stops at the window even with no routing drop: edges
        # past it were never fetched this call
        first_drop = torch.minimum(first_drop,
                                   stream_window[:, None].to(torch.int64))
    if push_mode:  # exactly-once: ship only the prefix the cursor passes
        keep = keep & (offs < first_drop[:, :, None])
    # one spare slot per destination row takes every unkept message
    r_safe = torch.where(keep, rank, cap)
    ds_safe = torch.where(keep, dst_shard, 0).to(torch.int64)
    flat_idx = (ds_safe * (cap + 1) + r_safe).reshape(P, L)
    send_vals = torch.full((P, Pn * (cap + 1)), prog.identity,
                           dtype=prog.tdtype, device=dev).scatter_(
        1, flat_idx, msg.reshape(P, L).to(prog.tdtype))
    send_ids = torch.full((P, Pn * (cap + 1)), -1, dtype=_I32,
                          device=dev).scatter_(
        1, flat_idx, torch.where(keep, dst % vs, -1).reshape(P, L).to(_I32))
    send_vals = send_vals.view(P, Pn, cap + 1)[:, :, :cap]
    send_ids = send_ids.view(P, Pn, cap + 1)[:, :, :cap]

    # ---- cursor advance: up to the first dropped edge (retry the rest) ----
    advance = torch.minimum(first_drop.to(_I32), deg - cur)
    new_cur = cur + torch.where(sel_valid, advance, 0)
    done = sel_valid & (new_cur >= deg)
    upd_idx = torch.where(sel_valid, sel, vs)  # OOB -> dropped
    cursor = _drop_scatter(cursor, upd_idx, torch.where(done, 0, new_cur))
    if push_mode:
        res_after = torch.where(latch, 0.0, res_sel)
        banked = torch.gather(values, 1, sel_safe) + torch.where(latch, mass,
                                                                 0.0)
        values = _drop_scatter(values, upd_idx, banked)
        residual = _drop_scatter(residual, upd_idx, res_after)
        pushv = _drop_scatter(pushv, upd_idx, torch.where(done, 0.0, mass))
        # a finished push re-arms iff mass arrived while it streamed (the
        # receive never touches the cursor in push mode); abs: signed
        # correction mass drains like positive mass
        active = _drop_scatter(active, upd_idx, torch.where(
            done, torch.abs(res_after) > prog.push_eps, True))
        aux = torch.stack([residual, pushv], dim=1)
    else:
        active = _drop_scatter(active, upd_idx, ~done)

    sent = keep.sum(dim=(1, 2))
    fetched = edge_valid.sum(dim=(1, 2))
    return active, cursor, send_vals, send_ids, sent, fetched, values, aux


def _phase2_receive(prog, values, active, cursor, recv_vals, recv_ids):
    """Deliver: idempotent scatter-⊕ (the program's aggregator); improved
    vertices activate.  ``recv_* [P, R, C]`` per receiving shard.  On the
    card one launch of ``csrc/engine_receive.cu`` that reads only the live
    slots' values (``kernels/receive.py``)."""
    return receive.deliver(prog.aggregator, values, active, cursor,
                           recv_vals, recv_ids)


def _phase2_receive_push(prog, ep: EngineParams, residual, active,
                         recv_vals, recv_ids):
    """Push-mode delivery: scatter-add into the residual plane; vertices
    whose |residual| passes ``push_eps`` join the frontier.  The banked
    ``values`` and the cursor are untouched: restarting an edge stream
    in flight would ship its delivered prefix again."""
    agg = prog.aggregator
    P = residual.shape[0]
    ids = recv_ids.reshape(P, -1)
    vals = recv_vals.reshape(P, -1).to(prog.tdtype)
    valid = ids >= 0
    idx = torch.where(valid, ids, ep.vs)  # vs -> dropped (out of bounds)
    residual = agg.scatter(residual, idx,
                           torch.where(valid, vals, prog.identity))
    accepted = valid.sum(dim=1)  # every delivered message lands mass
    active = active | (torch.abs(residual) > prog.push_eps)
    return residual, active, accepted


# ======================================================================
# Local (single-device) execution
# ======================================================================
def _receive(prog, ep: EngineParams, push_mode: bool, values, active,
             cursor, aux, recv_vals, recv_ids):
    """Phase 2 for all shards.  Returns ``(values, active, cursor, aux,
    accepted, old_plane, new_plane)``: the plane a receive writes (values,
    or push mode's residual ``aux[:, 0]``) before and after it, which the
    straggler demotion compares."""
    if push_mode:
        old_plane = aux[:, 0]
        residual, active, accepted = _phase2_receive_push(
            prog, ep, old_plane, active, recv_vals, recv_ids)
        aux = torch.stack([residual, aux[:, 1]], dim=1)
        return values, active, cursor, aux, accepted, old_plane, residual
    old_plane = values
    values, active, cursor, accepted = _phase2_receive(
        prog, values, active, cursor, recv_vals, recv_ids)
    return values, active, cursor, aux, accepted, old_plane, values


def make_local_tick(prog, ep: EngineParams, weighted: bool):
    """``tick(state, g) -> (state', TickStats, (send_vals, send_ids))``:
    one tick of all shards, exchanged by the local transport.  Push-mode
    (non-idempotent) programs thread their ``aux`` planes through it."""
    codec = wire_codec(prog, ep)
    push_mode = not prog.aggregator.idempotent

    def tick(state: EngineState, g: ShardGraph):
        w = g.weights if weighted else None
        with _trace.span("asymp.tick.create"):
            active, cursor, sv, si, sent, fetched, values, aux = \
                _phase1_create(prog, ep, state.values, state.active,
                               state.cursor, g.row_ptr, g.col_idx, w,
                               aux=state.aux if push_mode else None)
        # exchange: send[p][q] -> recv[q][p] via the dist substrate
        with _trace.span("asymp.tick.exchange"):
            rv, ri = ex_mod.exchange_local(codec, sv, si)
        # aux of an idempotent program: None, or an untouched caller plane
        with _trace.span("asymp.tick.receive"):
            values, active, cursor, aux, accepted, _, _ = _receive(
                prog, ep, push_mode, values, active, cursor,
                aux if push_mode else state.aux, rv, ri)
        stats = TickStats(active.sum(), sent.sum(), accepted.sum(),
                          fetched.sum())
        return (EngineState(values=values, active=active, cursor=cursor,
                            tick=state.tick + 1, aux=aux),
                stats, (sv, si))

    return tick


# ======================================================================
# Crowded-cluster emulation (paper §5.4): deferred delivery, throttled
# budgets and straggler-aware scheduling
# ======================================================================
class CrowdedState(NamedTuple):
    core: EngineState
    ring: ex_mod.DelayRing  # in-flight messages (the emulated slow wire)
    demote: torch.Tensor  # [P, vs] bool — frontier work to deprioritize


class CrowdedStats(NamedTuple):
    base: TickStats
    pending: torch.Tensor  # messages still in flight in the delay ring
    shard_fetched: torch.Tensor  # [P] edges fetched per shard this tick
    shard_recv: torch.Tensor  # [P] messages processed per shard this tick


def init_crowded_state(prog, ep: EngineParams, graph: ShardedGraph,
                       max_delay: int,
                       device: DeviceLike = None) -> CrowdedState:
    dev = resolve_device(device)
    return CrowdedState(
        init_state(prog, graph, dev),
        ex_mod.init_delay_ring(max_delay, ep.num_shards, ep.num_shards,
                               ep.route_capacity, prog.identity,
                               prog.tdtype, dev),
        torch.zeros((ep.num_shards, ep.vs), dtype=torch.bool, device=dev))


def _demote_row(agg, ep: EngineParams, new_values, old_values, recv_ids,
                slow_rows):
    """Every shard's ``[vs]`` demotion mask at once: vertices whose value
    improved this tick AND that a message over a slow (delay > 0) link
    targeted (``slow_rows [P, rows]`` flags the slow receive rows).
    Recomputed every tick, so repeated slow arrivals keep deferring the
    work while fresh local work cannot be starved."""
    changed = agg.improves(new_values, old_values)  # [P, vs]
    idx = torch.where((recv_ids >= 0) & slow_rows[:, :, None], recv_ids,
                      ep.vs)
    slow_targets = _drop_scatter(torch.zeros_like(changed),
                                 idx.reshape(idx.shape[0], -1), True)
    return changed & slow_targets


def _slow_recv_rows(ep: EngineParams, num_rows: int, delays):
    """``[Pn, num_rows]`` — for each receiver q, which delivered rows (row
    ``l * P + p`` is sender p's ring slot l) crossed a slow link."""
    sender = torch.arange(num_rows, device=delays.device) % ep.num_shards
    return (delays[sender, :] > 0).T


def _next_demote(prog, ep: EngineParams, new_plane, old_plane, recv_ids,
                 delays, demote, rank: Optional[int] = None):
    """The next demotion plane; ``rank`` set: one rank of the dist ticks,
    whose receive rows are its own column of the delay matrix."""
    if not ep.straggler_demote:
        return torch.zeros_like(demote)
    slow_rows = _slow_recv_rows(ep, recv_ids.shape[1], delays)
    if rank is not None:
        slow_rows = slow_rows[rank:rank + 1]
    return _demote_row(prog.aggregator, ep, new_plane, old_plane, recv_ids,
                       slow_rows)


def make_crowded_tick(prog, ep: EngineParams, weighted: bool):
    """Local-transport tick under emulated crowding.

    ``tick(cstate, g, delays, throttle)`` with ``delays [P, Pn]`` and
    ``throttle [P]`` int32 tensors (from a ``dist.latency`` model, raised
    per tick by a plan's slowdown), so the cluster condition may change
    mid-run.  Sends are parked in the delay ring and delivered when due;
    convergence needs an empty frontier AND an empty ring
    (``stats.pending == 0``)."""
    codec = wire_codec(prog, ep)
    push_mode = not prog.aggregator.idempotent

    def tick(cstate: CrowdedState, g: ShardGraph, delays, throttle):
        state = cstate.core
        w = g.weights if weighted else None
        with _trace.span("asymp.tick.create"):
            active, cursor, sv, si, sent, fetched, values, aux = \
                _phase1_create(prog, ep, state.values, state.active,
                               state.cursor, g.row_ptr, g.col_idx, w,
                               aux=state.aux if push_mode else None,
                               throttle=throttle, demote=cstate.demote)
        # messages from slow links surface ticks later, healthy links
        # deliver at once
        with _trace.span("asymp.tick.exchange"):
            rv, ri, ring, pending = ex_mod.exchange_local_delayed(
                codec, cstate.ring, sv, si, state.tick, delays,
                prog.identity)
        with _trace.span("asymp.tick.receive"):
            values, active, cursor, aux, accepted, old_plane, new_plane = \
                _receive(prog, ep, push_mode, values, active, cursor,
                         aux if push_mode else state.aux, rv, ri)
        demote = _next_demote(prog, ep, new_plane, old_plane, ri, delays,
                              cstate.demote)
        stats = TickStats(active.sum(), sent.sum(), accepted.sum(),
                          fetched.sum())
        cstats = CrowdedStats(stats, pending, fetched,
                              (ri >= 0).sum(dim=(1, 2)))
        core = EngineState(values=values, active=active, cursor=cursor,
                           tick=state.tick + 1, aux=aux)
        return CrowdedState(core, ring, demote), cstats, (sv, si)

    return tick


# ======================================================================
# Asynchronous (barrier-free) execution: per-shard progress clocks
# ======================================================================
class AsyncState(NamedTuple):
    """``core.tick`` stays the emulated wall-clock step (it keys the ring
    slots and the firing pattern); ``clock [P]`` counts each shard's
    firings, the progress that recovery cuts and the metrics read."""
    core: EngineState
    ring: ex_mod.DelayRing  # in-flight messages (arrivals queue here)
    demote: torch.Tensor  # [P, vs] bool — carried until the shard fires
    clock: torch.Tensor  # [P] int32 — firings incorporated into `core`


class AsyncStats(NamedTuple):
    base: TickStats
    pending: torch.Tensor  # messages still in flight (all shards)
    shard_active: torch.Tensor  # [P] frontier size per shard
    shard_pending: torch.Tensor  # [P] in-flight messages bound for shard
    clock: torch.Tensor  # [P] logical clocks after this step


def async_ring_delay(max_delay: int, max_stall: int) -> int:
    """Ring sizing for the async schedule, as a ``max_delay``-equivalent: a
    message due at step ``t`` waits up to ``max_stall - 1`` steps for its
    receiver to fire, so the ring needs ``max_delay + max_stall`` slots
    (the synchronous ``max_delay + 1`` would let a send overwrite a
    due-but-unconsumed row)."""
    return max_delay + max(int(max_stall), 1) - 1


def init_async_state(prog, ep: EngineParams, graph: ShardedGraph,
                     ring_delay: int,
                     device: DeviceLike = None) -> AsyncState:
    """``ring_delay`` comes from :func:`async_ring_delay`."""
    cstate = init_crowded_state(prog, ep, graph, ring_delay, device)
    return AsyncState(cstate.core, cstate.ring, cstate.demote,
                      torch.zeros((ep.num_shards,), dtype=_I32,
                                  device=cstate.demote.device))


def make_async_tick(prog, ep: EngineParams, weighted: bool):
    """Barrier-free step over the local transport.

    ``tick(astate, g, delays, fire, window=None)`` — ``fire [P]`` bool is
    the step's seeded firing mask (``dist.latency.AsyncInterleaving``),
    ``window [P]`` the live per-shard edge window.  A firing shard drains
    its due ring arrivals, selects with its full budget (the throttle is
    a firing rate here, not a budget divisor) and sends; a shard that does
    not fire keeps its state, sends nothing, its inbound due rows stay
    parked (``recv_gate``) and it carries its demotions to its next
    firing.  Convergence: every shard's frontier empty AND its inbound
    ring drained (``shard_active + shard_pending == 0``)."""
    codec = wire_codec(prog, ep)
    push_mode = not prog.aggregator.idempotent

    def tick(astate: AsyncState, g: ShardGraph, delays, fire, window=None):
        state = astate.core
        w = g.weights if weighted else None
        if window is None:  # the full static window for every shard
            window = torch.full((ep.num_shards,), ep.degree_window,
                                dtype=_I32, device=fire.device)
        with _trace.span("asymp.tick.create"):
            active1, cursor1, sv, si, sent, fetched, values1, aux1 = \
                _phase1_create(prog, ep, state.values, state.active,
                               state.cursor, g.row_ptr, g.col_idx, w,
                               aux=state.aux if push_mode else None,
                               demote=astate.demote, stream_window=window)
        # only firing shards advance; the rest keep their state verbatim
        # and send nothing this step
        fire_v, fire_b = fire[:, None], fire[:, None, None]
        values = torch.where(fire_v, values1, state.values)
        active = torch.where(fire_v, active1, state.active)
        cursor = torch.where(fire_v, cursor1, state.cursor)
        aux = torch.where(fire_b, aux1, state.aux) if push_mode else state.aux
        sv = torch.where(fire_b, sv, prog.identity)
        si = torch.where(fire_b, si, -1)
        sent = torch.where(fire, sent, 0)
        fetched = torch.where(fire, fetched, 0)
        # park sends, pop keyed on the receivers: a due row surfaces only
        # on a step its destination shard fires
        with _trace.span("asymp.tick.exchange"):
            rv, ri, ring, pending = ex_mod.exchange_local_delayed(
                codec, astate.ring, sv, si, state.tick, delays,
                prog.identity, recv_gate=fire)
        # a gated receiver's rows arrive empty, and the receive is an
        # exact no-op on empty rows: phase 2 needs no fire mask
        with _trace.span("asymp.tick.receive"):
            values, active, cursor, aux, accepted, old_plane, new_plane = \
                _receive(prog, ep, push_mode, values, active, cursor, aux,
                         rv, ri)
        demote = _next_demote(prog, ep, new_plane, old_plane, ri, delays,
                              astate.demote)
        if ep.straggler_demote:
            demote = torch.where(fire_v, demote, astate.demote)
        clock = astate.clock + fire.to(_I32)
        inflight = (ring.ids >= 0) & (ring.due >= 0)[..., None]
        stats = TickStats(active.sum(), sent.sum(), accepted.sum(),
                          fetched.sum())
        astats = AsyncStats(stats, pending, active.sum(dim=1),
                            inflight.sum(dim=(0, 1, 3)), clock)
        core = EngineState(values=values, active=active, cursor=cursor,
                           tick=state.tick + 1, aux=aux)
        return AsyncState(core, ring, demote, clock), astats, (sv, si)

    return tick


# ======================================================================
# Multi-rank execution: one shard per rank of a torch.distributed group
# ======================================================================
# A rank holds its own rows of every per-shard tensor, with the shard axis
# kept at length 1 (``[1, vs]`` state, ``[1, vs + 1]`` / ``[1, es]`` graph,
# ``[1]`` clock), so the batched phases above run unchanged with P = 1; its
# delay ring drops the sender axis (``[ring_len, Pn, cap]``).  The tick
# scalar and the per-tick cluster inputs (delays, throttle, fire, window)
# are replicated: every rank derives them from the same seed.  The counters
# of a tick cross one all_reduce of a packed int64 vector, so every rank
# reads the same global stats and stops on the same tick.
# ``launch/mesh.py`` cuts a global state into a rank's rows and gathers it
# back.
def _reduce_packed(group, parts):
    """One all_reduce (sum) of several int64 pieces; returns them in their
    shapes."""
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts])
    out = ex_mod.all_reduce_sum(flat, group)
    sizes = [p.numel() for p in parts]
    return [o.reshape(p.shape) for o, p in
            zip(torch.split(out, sizes), parts)]


def _rank_in(group, ep: EngineParams) -> int:
    """This process's rank; the group must have one rank per shard."""
    size = ex_mod.group_size(group)
    if size != ep.num_shards:
        raise ValueError(f"a group of {size} ranks cannot run "
                         f"{ep.num_shards} shards: one rank per shard")
    return ex_mod.group_rank(group)


def _own_slot(x, rank: int, size: int):
    """``x`` (one value) in slot ``rank`` of a zero ``[size]`` vector: a
    field every rank fills with its own entry under the packed sum."""
    slots = torch.arange(size, device=x.device) == rank
    return torch.where(slots, x.reshape(()).to(torch.int64), 0)


def make_dist_tick(prog, ep: EngineParams, group, weighted: bool):
    """``tick(state, g) -> (state', TickStats)`` on one rank of ``group``
    (``ep.num_shards`` ranks): its rows of the state and graph, the sends
    crossing ``exchange_dist``; the global stats after one packed
    all_reduce.  Bitwise the local tick's rows (the same phases, the same
    receive order)."""
    codec = wire_codec(prog, ep)
    push_mode = not prog.aggregator.idempotent
    _rank_in(group, ep)

    def tick(state: EngineState, g: ShardGraph):
        w = g.weights if weighted else None
        with _trace.span("asymp.tick.create"):
            active, cursor, sv, si, sent, fetched, values, aux = \
                _phase1_create(prog, ep, state.values, state.active,
                               state.cursor, g.row_ptr, g.col_idx, w,
                               aux=state.aux if push_mode else None)
        with _trace.span("asymp.tick.exchange"):
            rv, ri = ex_mod.exchange_dist(codec, sv[0], si[0], group)
        with _trace.span("asymp.tick.receive"):
            values, active, cursor, aux, accepted, _, _ = _receive(
                prog, ep, push_mode, values, active, cursor,
                aux if push_mode else state.aux, rv[None], ri[None])
        stats = TickStats(*_reduce_packed(group, [
            active.sum(), sent.sum(), accepted.sum(), fetched.sum()]))
        return (EngineState(values=values, active=active, cursor=cursor,
                            tick=state.tick + 1, aux=aux), stats)

    return tick


def _dist_ring(prog, ep: EngineParams, ring_delay: int, device):
    """Every rank's empty sender-side ring, ``[P, ring_len, Pn, cap]``."""
    one = ex_mod.init_delay_ring(ring_delay, 0, ep.num_shards,
                                 ep.route_capacity, prog.identity,
                                 prog.tdtype, device)
    return ex_mod.DelayRing(*(x.expand((ep.num_shards,) + x.shape).clone()
                              for x in one))


def init_crowded_dist_state(prog, ep: EngineParams, graph: ShardedGraph,
                            max_delay: int,
                            device: DeviceLike = None) -> CrowdedState:
    """:func:`init_crowded_state` in the layout of the dist ticks, all
    ranks at once: the ring ``[P, ring_len, Pn, cap]`` (rank p's ring is
    row p)."""
    dev = resolve_device(device)
    return CrowdedState(
        init_state(prog, graph, dev), _dist_ring(prog, ep, max_delay, dev),
        torch.zeros((ep.num_shards, ep.vs), dtype=torch.bool, device=dev))


def make_crowded_dist_tick(prog, ep: EngineParams, group, weighted: bool):
    """``tick(cstate, g, delays, throttle) -> (cstate', TickStats,
    pending)`` on one rank: :func:`make_crowded_tick` over
    ``exchange_dist_delayed``, with the same delivery order, so bitwise
    its rows.  ``delays [P, Pn]`` and ``throttle [P]`` are replicated;
    ``pending`` is the whole ring's, summed over the ranks."""
    codec = wire_codec(prog, ep)
    push_mode = not prog.aggregator.idempotent
    rank = _rank_in(group, ep)

    def tick(cstate: CrowdedState, g: ShardGraph, delays, throttle):
        state = cstate.core
        w = g.weights if weighted else None
        with _trace.span("asymp.tick.create"):
            active, cursor, sv, si, sent, fetched, values, aux = \
                _phase1_create(prog, ep, state.values, state.active,
                               state.cursor, g.row_ptr, g.col_idx, w,
                               aux=state.aux if push_mode else None,
                               throttle=throttle[rank:rank + 1],
                               demote=cstate.demote)
        with _trace.span("asymp.tick.exchange"):
            rv, ri, ring, pending = ex_mod.exchange_dist_delayed(
                codec, cstate.ring, sv[0], si[0], state.tick, delays[rank],
                group, prog.identity)
        with _trace.span("asymp.tick.receive"):
            values, active, cursor, aux, accepted, old_plane, new_plane = \
                _receive(prog, ep, push_mode, values, active, cursor,
                         aux if push_mode else state.aux, rv[None],
                         ri[None])
        demote = _next_demote(prog, ep, new_plane, old_plane, ri[None],
                              delays, cstate.demote, rank)
        *base, pending = _reduce_packed(group, [
            active.sum(), sent.sum(), accepted.sum(), fetched.sum(),
            pending])
        core = EngineState(values=values, active=active, cursor=cursor,
                           tick=state.tick + 1, aux=aux)
        return CrowdedState(core, ring, demote), TickStats(*base), pending

    return tick


def init_async_dist_state(prog, ep: EngineParams, graph: ShardedGraph,
                          ring_delay: int,
                          device: DeviceLike = None) -> AsyncState:
    """:func:`init_async_state` in the layout of the dist ticks, all ranks
    at once (ring ``[P, ring_len, Pn, cap]``, clock ``[P]``)."""
    cstate = init_crowded_dist_state(prog, ep, graph, ring_delay, device)
    return AsyncState(cstate.core, cstate.ring, cstate.demote,
                      torch.zeros((ep.num_shards,), dtype=_I32,
                                  device=cstate.demote.device))


def make_async_dist_tick(prog, ep: EngineParams, group, weighted: bool):
    """``tick(astate, g, delays, fire, window=None) -> (astate',
    AsyncStats)`` on one rank: :func:`make_async_tick` over
    ``exchange_dist_delayed`` gated on the receivers' ``fire``, bitwise
    its rows.  ``delays``, ``fire`` and ``window`` are replicated; the
    rank gates on its own entries.  The stats' ``[P]`` fields (frontier
    and clock per shard, in-flight messages per receiver) ride the same
    packed all_reduce as the counters: each rank fills its own slot of
    the first two and adds its ring's rows to the third."""
    codec = wire_codec(prog, ep)
    push_mode = not prog.aggregator.idempotent
    rank, size = _rank_in(group, ep), ep.num_shards

    def tick(astate: AsyncState, g: ShardGraph, delays, fire, window=None):
        state = astate.core
        w = g.weights if weighted else None
        if window is None:  # the full static window for every shard
            window = torch.full((ep.num_shards,), ep.degree_window,
                                dtype=_I32, device=fire.device)
        f = fire[rank:rank + 1]
        with _trace.span("asymp.tick.create"):
            active1, cursor1, sv, si, sent, fetched, values1, aux1 = \
                _phase1_create(prog, ep, state.values, state.active,
                               state.cursor, g.row_ptr, g.col_idx, w,
                               aux=state.aux if push_mode else None,
                               demote=astate.demote,
                               stream_window=window[rank:rank + 1])
        fire_v, fire_b = f[:, None], f[:, None, None]
        values = torch.where(fire_v, values1, state.values)
        active = torch.where(fire_v, active1, state.active)
        cursor = torch.where(fire_v, cursor1, state.cursor)
        aux = torch.where(fire_b, aux1, state.aux) if push_mode else state.aux
        sv = torch.where(fire_b, sv, prog.identity)
        si = torch.where(fire_b, si, -1)
        sent = torch.where(f, sent, 0)
        fetched = torch.where(f, fetched, 0)
        with _trace.span("asymp.tick.exchange"):
            rv, ri, ring, pending = ex_mod.exchange_dist_delayed(
                codec, astate.ring, sv[0], si[0], state.tick, delays[rank],
                group, prog.identity, recv_gate=fire)
        with _trace.span("asymp.tick.receive"):
            values, active, cursor, aux, accepted, old_plane, new_plane = \
                _receive(prog, ep, push_mode, values, active, cursor, aux,
                         rv[None], ri[None])
        demote = _next_demote(prog, ep, new_plane, old_plane, ri[None],
                              delays, astate.demote, rank)
        if ep.straggler_demote:
            demote = torch.where(fire_v, demote, astate.demote)
        clock = astate.clock + f.to(_I32)
        inflight = (ring.ids >= 0) & (ring.due >= 0)[..., None]
        n_active = active.sum()
        (n_active_all, sent, accepted, fetched, pending, shard_active,
         shard_pending, clocks) = _reduce_packed(group, [
            n_active, sent.sum(), accepted.sum(), fetched.sum(), pending,
            _own_slot(n_active, rank, size), inflight.sum(dim=(0, 2)),
            _own_slot(clock, rank, size)])
        stats = TickStats(n_active_all, sent, accepted, fetched)
        astats = AsyncStats(stats, pending, shard_active, shard_pending,
                            clocks.to(_I32))
        core = EngineState(values=values, active=active, cursor=cursor,
                           tick=state.tick + 1, aux=aux)
        return AsyncState(core, ring, demote, clock), astats

    return tick


# ======================================================================
# Host-side helpers
# ======================================================================
def init_state(prog, graph: ShardedGraph,
               device: DeviceLike = None) -> EngineState:
    dev = resolve_device(device)
    P_, vs = graph.num_shards, graph.vs
    gids = torch.arange(P_ * vs, dtype=_I32, device=dev).reshape(P_, vs)
    valid = gids < graph.num_real_vertices
    values, active = prog.init(gids, valid)
    aux = prog.init_aux(gids, valid) if prog.aux_channels else None
    return EngineState(values, active,
                       torch.zeros((P_, vs), dtype=_I32, device=dev),
                       torch.zeros((), dtype=_I32, device=dev), aux)


def state_from_numpy(values, active, cursor, tick, aux=None, *,
                     device: DeviceLike = None) -> EngineState:
    """An :class:`EngineState` from host arrays — e.g. a JAX engine's state
    mid-run, handed over as numpy so both engines tick on from one point
    (``aux``: a push-mode run's ``[P, aux_channels, vs]`` planes)."""
    dev = resolve_device(device)
    values = np.asarray(values)
    if values.dtype not in (np.int32, np.float32):
        raise TypeError(f"values must be int32 or float32, got {values.dtype}")
    # copies: the host arrays may be read-only views of another framework's
    put = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)  # noqa: E731
    return EngineState(
        values=put(values, values.dtype), active=put(active, np.bool_),
        cursor=put(cursor, np.int32), tick=put(tick, np.int32).reshape(()),
        aux=put(aux, np.float32) if aux is not None else None)


def to_device_graph(graph: ShardedGraph,
                    device: DeviceLike = None) -> ShardGraph:
    dev = resolve_device(device)
    put = lambda a, dt: torch.as_tensor(np.asarray(a, dt)).to(dev)  # noqa: E731
    return ShardGraph(
        put(graph.row_ptr, np.int32),
        put(np.where(graph.col_idx < 0, -1, graph.col_idx), np.int32),
        put(graph.weights, np.float32) if graph.weights is not None else None)


def _read(x: torch.Tensor):
    """``x`` on the host, as an int (0-dim) or a list: one blocking
    device-to-host transfer, under the ``asymp.session.read`` span and
    counted in ``host_reads``."""
    with _trace.span("asymp.session.read"):
        _trace.count("host_reads")
        return int(x) if x.dim() == 0 else x.tolist()


def _to_host(*tensors) -> list:
    """A tick's counters in one device-to-host transfer (one span, one
    count, as :func:`_read`): a 0-dim tensor comes back as an int, any
    other as a list of ints."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    with _trace.span("asymp.session.read"):
        _trace.count("host_reads")
        flat = flat.tolist()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i] if t.dim() == 0 else flat[i:i + n])
        i += n
    return out


class EngineSession:
    """A resumable engine run: the host-side loop behind
    :func:`run_to_convergence` (tick a few steps, read the state, tick
    again), on one of three paths:

      * plain — the synchronous tick;
      * crowded — ``latency`` (a ``dist.latency.LatencyModel``; None
        resolves one from ``cfg.latency_profile``) or a ``fault_plan``
        that injects slowdowns: messages cross the delay ring, crowded
        shards get throttled budgets, and quiescence also needs the ring
        drained;
      * async — ``schedule="async"`` (None resolves ``cfg.schedule``):
        each shard fires on its own seeded steps, advancing a per-shard
        clock; quiescent when every shard's frontier and inbound ring
        rows are empty.

    ``fault_plan`` (a ``core.faults.FaultPlan``) kills shards on the
    plan's host steps; after each tick the session records the tick in the
    ``FaultManager``, cuts the ring checkpoint, then lets the manager fail
    and recover shards, as the JAX package orders it.  On the crowded and
    async paths each tick's counters come to the host in one transfer; the
    plain path reads its four scalars (frontier, sent, accepted, fetched)
    one by one, four transfers a tick.  Every blocking read of a session
    is counted in ``host_reads`` while ``_trace.tracing`` is on, and the
    session's init, each step, each tick phase and each read open a span
    (``repro_torch/_trace.py``).  ``device=None`` means the CUDA card
    (raises if there is none).  ``fork``, ``replace_state``,
    ``rebind_graph`` and ``rebase_recovery`` are the streaming-delta hooks
    of the serving plane (``serve/graph.py``).

    No tick, recovery or seeding writes into a state tensor in place (the
    scatters copy first, a recovery clones, the ring is functional), so a
    fork may share every tensor with its primary.
    """

    def __init__(self, cfg: GraphConfig, *,
                 graph: Optional[ShardedGraph] = None, prog=None,
                 params: Optional[EngineParams] = None,
                 collect_log: bool = False, fault_plan=None, latency=None,
                 schedule: Optional[str] = None,
                 device: DeviceLike = None):
        from repro_torch.core import faults
        from repro_torch.dist import latency as lat_mod
        with _trace.span("asymp.session.init"):
            schedule = (schedule or getattr(cfg, "schedule", "sync")
                        or "sync")
            if schedule not in ("sync", "async"):
                raise ValueError(f"unknown schedule {schedule!r}; "
                                 f"valid: 'sync', 'async'")
            self.device = resolve_device(device)
            self._faults = faults
            self.cfg = cfg
            self.graph = graph or build_sharded_graph(cfg)
            self.prog = prog or prog_mod.get_program(cfg)
            self.ep = params or default_params(cfg, self.graph, self.prog)
            self.g = to_device_graph(self.graph, self.device)
            self.collect_log = collect_log
            self.schedule = schedule
            self.fault_plan = fault_plan
            if latency is None and cfg.latency_profile != "none":
                latency = lat_mod.from_config(cfg)
            self.latency = latency
            self.crowded = (latency is not None
                            or faults.injects_slowdown(fault_plan))
            self.max_delay = (max(latency.max_delay if latency else 0,
                                  faults.max_injected_delay(fault_plan))
                              if self.crowded else 0)
            self.log: list = []
            self.totals = {"ticks": 0, "sent": 0, "accepted": 0, "fetched": 0,
                           "replayed": 0, "failures": 0, "pending": 0,
                           "schedule": schedule}
            self._t = 0  # host step counter (fault schedules key on it)
            self._pending = 0
            self._ring_ckpt = None
            self._conditions: dict = {}
            if schedule == "async":
                self._init_async(lat_mod)
            elif self.crowded:
                self._init_crowded()
            else:
                self._init_plain()

    # -- mode setup ----------------------------------------------------
    def _fault_manager(self, ep: EngineParams, replay_slack: int):
        # replay recovery must reach back past the checkpoint by every
        # step a message can spend parked in the ring: deferred messages
        # straddling the snapshot are otherwise in neither the restored
        # state nor the replayed range
        if self.fault_plan is None:
            return None
        return self._faults.FaultManager(self.cfg, self.graph, self.prog,
                                         ep, replay_slack=replay_slack,
                                         device=self.device)

    def _base_conditions(self) -> None:
        P_ = self.graph.num_shards
        lat = self.latency
        self._base_delays = (lat.delays if lat
                             else np.zeros((P_, P_), np.int32))
        self._base_throttle = (lat.throttle if lat
                               else np.ones((P_,), np.int32))

    def _init_plain(self) -> None:
        self.ep_run = self.ep
        self.fault_mgr = self._fault_manager(self.ep, 0)
        self._tick_fn = make_local_tick(self.prog, self.ep,
                                        self.prog.weighted)
        self._state = init_state(self.prog, self.graph, self.device)
        self._n_active = _read(torch.sum(self._state.active))

    def _init_crowded(self) -> None:
        self.ep_run = self.ep
        self.fault_mgr = self._fault_manager(self.ep, self.max_delay)
        self._base_conditions()
        self._tick_fn = make_crowded_tick(self.prog, self.ep,
                                          self.prog.weighted)
        self._cstate = init_crowded_state(self.prog, self.ep, self.graph,
                                          self.max_delay, self.device)
        self._n_active = _read(torch.sum(self._cstate.core.active))

    def _init_async(self, lat_mod) -> None:
        cfg, plan = self.cfg, self.fault_plan
        self._base_conditions()
        self._inter = lat_mod.make_interleaving(
            self.graph.num_shards, rates=self._base_throttle,
            seed=getattr(cfg, "async_seed", 0),
            jitter=getattr(cfg, "async_jitter", False))
        plan_rate = (plan.slow_intensity
                     if self._faults.injects_slowdown(plan) else 1)
        max_stall = self._inter.stall_bound(plan_rate)
        self._ring_delay = async_ring_delay(self.max_delay, max_stall)
        # one firing of a rate-k shard stands in for k barrier steps, so it
        # carries k steps' worth of edge window and routing room: compile
        # the widened window and caps once (the largest rate of the profile
        # and any injected slowdown) and pass the live per-shard window each
        # step.  A healthy run (r_all == 1) keeps the sync-shaped params and
        # is bitwise the barrier schedule.
        self._r_all = max(int(np.asarray(self._base_throttle).max(initial=1)),
                          plan_rate, 1)
        self.ep_run = (dataclasses.replace(
            self.ep, degree_window=self.ep.degree_window * self._r_all,
            route_capacity=self.ep.route_capacity * self._r_all)
            if self._r_all > 1 else self.ep)
        # a pre-checkpoint send can also sit due-but-unconsumed until its
        # receiver fires
        self.fault_mgr = self._fault_manager(self.ep_run,
                                             self.max_delay + max_stall)
        self._tick_fn = make_async_tick(self.prog, self.ep_run,
                                        self.prog.weighted)
        self._astate = init_async_state(self.prog, self.ep_run, self.graph,
                                        self._ring_delay, self.device)
        # host mirrors of the device tick and the clock vector: the firing
        # pattern is keyed on the device tick, which a checkpoint restore
        # rewinds, and reading it back would cost a sync every step
        self._dev_tick = 0
        self._clock = [0] * self.graph.num_shards
        self._shard_busy = _read(self._astate.core.active.sum(dim=1))
        self._n_active = sum(self._shard_busy)

    def _device_conditions(self, delays, throttle):
        """Device copies of one cluster condition — delays clipped to the
        ring, throttle, and the async edge window — made once per array
        pair: ``apply_slowdown`` hands back the same arrays for every tick
        of its window."""
        key = (id(delays), id(throttle))
        hit = self._conditions.get(key)
        if hit is None:
            put = lambda a: torch.as_tensor(  # noqa: E731
                np.asarray(a, np.int32), device=self.device)
            window = (put(np.minimum(np.asarray(throttle, np.int64),
                                     self._r_all) * self.ep.degree_window)
                      if self.schedule == "async" else None)
            # the arrays ride in the entry to keep their ids alive
            hit = self._conditions[key] = (
                delays, throttle, put(np.minimum(delays, self.max_delay)),
                put(throttle), window)
        return hit[2:]

    # -- per-tick drivers (bookkeeping order mirrors across all three:
    # totals, fault handling, log entry) --------------------------------
    def _count(self, sent: int, accepted: int, fetched: int) -> None:
        totals = self.totals
        totals["ticks"] += 1
        totals["sent"] += sent
        totals["accepted"] += accepted
        totals["fetched"] += fetched

    def _step_plain(self) -> None:
        t, fault_mgr = self._t, self.fault_mgr
        state, stats, send_bufs = self._tick_fn(self._state, self.g)
        n_active = _read(stats.active)
        totals = self.totals
        self._count(_read(stats.sent), _read(stats.accepted),
                    _read(stats.fetched))
        if fault_mgr is not None:
            # the kill schedule is keyed on the host step, as in the JAX
            # package
            fault_mgr.record(t, state, send_bufs)
            state, extra = fault_mgr.maybe_fail(t, state, self.fault_plan)
            totals["replayed"] += extra["replayed"]
            totals["failures"] += extra["failures"]
            if extra["failures"]:
                n_active = _read(torch.sum(state.active))
        if self.collect_log:
            self.log.append({"tick": t, "active": n_active,
                             "sent": _read(stats.sent),
                             "accepted": _read(stats.accepted),
                             "fetched": _read(stats.fetched)})
        self._state = state
        self._n_active = n_active

    def _step_crowded(self) -> None:
        t, fault_plan, fault_mgr = self._t, self.fault_plan, self.fault_mgr
        delays, throttle, _ = self._device_conditions(
            *self._faults.apply_slowdown(fault_plan, t, self._base_delays,
                                         self._base_throttle))
        cstate, cstats, send_bufs = self._tick_fn(self._cstate, self.g,
                                                  delays, throttle)
        stats = cstats.base
        work = ((cstats.shard_fetched + cstats.shard_recv,)
                if self.collect_log else ())
        n_active, sent, accepted, fetched, pending, *shard_work = _to_host(
            stats.active, stats.sent, stats.accepted, stats.fetched,
            cstats.pending, *work)
        self._count(sent, accepted, fetched)
        totals = self.totals
        if fault_mgr is not None:
            fault_mgr.record(t, cstate.core, send_bufs)
            if (fault_mgr.recovery == "checkpoint"
                    and t % fault_mgr.ckpt_every == 0):
                # a global restore rolls every shard back to the snapshot;
                # its consistent cut must hold the messages in flight
                # (their senders' cursors have advanced, so they are never
                # sent again) and the device tick (ring slots are keyed by
                # tick % ring_len).  The ring is functional, so these
                # references keep it as it stands now.
                self._ring_ckpt = (cstate.ring, cstate.demote,
                                   cstate.core.tick)
            core, extra = fault_mgr.maybe_fail(t, cstate.core, fault_plan)
            cstate = cstate._replace(core=core)
            if extra["failures"] and fault_mgr.recovery == "checkpoint":
                if self._ring_ckpt is not None:
                    ring, demote, snap_tick = self._ring_ckpt
                    cstate = CrowdedState(core._replace(tick=snap_tick),
                                          ring, demote)
                else:  # no snapshot yet -> the run re-inits: empty ring
                    cstate = init_crowded_state(
                        self.prog, self.ep, self.graph, self.max_delay,
                        self.device)._replace(core=core._replace(
                            tick=torch.zeros_like(core.tick)))
                pending = _read(ex_mod.ring_pending(cstate.ring))
            totals["replayed"] += extra["replayed"]
            totals["failures"] += extra["failures"]
            if extra["failures"]:
                n_active = _read(torch.sum(cstate.core.active))
        if self.collect_log:
            self.log.append({"tick": t, "active": n_active, "sent": sent,
                             "accepted": accepted, "fetched": fetched,
                             "pending": pending,
                             "shard_work": shard_work[0]})
        self._cstate = cstate
        self._n_active = n_active
        self._pending = pending

    def _step_async(self) -> None:
        t, fault_plan, fault_mgr = self._t, self.fault_plan, self.fault_mgr
        # the firing pattern and the slowdown windows are keyed on the
        # DEVICE tick (its host mirror), not the host step: a checkpoint
        # restore rewinds the device tick, and the ring-sizing guarantee
        # (a due row is consumed within max_stall steps of its slot's
        # reuse) holds only if the pattern is a function of device time
        dev_tick = self._dev_tick
        delays_np, throttle_np = self._faults.apply_slowdown(
            fault_plan, dev_tick, self._base_delays, self._base_throttle)
        fire_np = self._inter.fire_mask(dev_tick, rates=throttle_np)
        delays, _, window = self._device_conditions(delays_np, throttle_np)
        fire = torch.as_tensor(fire_np, device=self.device)
        astate, astats, send_bufs = self._tick_fn(self._astate, self.g,
                                                  delays, fire, window)
        stats = astats.base
        (n_active, sent, accepted, fetched, pending, shard_active,
         shard_pending) = _to_host(
            stats.active, stats.sent, stats.accepted, stats.fetched,
            astats.pending, astats.shard_active, astats.shard_pending)
        shard_busy = [a + b for a, b in zip(shard_active, shard_pending)]
        self._dev_tick += 1
        self._clock = [c + int(f) for c, f in zip(self._clock, fire_np)]
        self._count(sent, accepted, fetched)
        totals = self.totals
        if fault_mgr is not None:
            fault_mgr.record(t, astate.core, send_bufs, clock=self._clock)
            if (fault_mgr.recovery == "checkpoint"
                    and t % fault_mgr.ckpt_every == 0):
                # the cut under per-shard clocks: (state, ring, wall-clock
                # step, clock vector) at the snapshot instant, with the
                # host mirrors of the last two
                self._ring_ckpt = (astate.ring, astate.demote,
                                   astate.core.tick, astate.clock,
                                   self._dev_tick, list(self._clock))
            core, extra = fault_mgr.maybe_fail(t, astate.core, fault_plan,
                                               clock=self._clock)
            astate = astate._replace(core=core)
            if "clock" in extra:
                astate = astate._replace(clock=extra["clock"])
                self._clock = _read(extra["clock"])
            if extra["failures"] and fault_mgr.recovery == "checkpoint":
                if self._ring_ckpt is not None:
                    (ring, demote, snap_tick, snap_clock, self._dev_tick,
                     clock) = self._ring_ckpt
                    self._clock = list(clock)
                    astate = AsyncState(core._replace(tick=snap_tick),
                                        ring, demote, snap_clock)
                else:  # no snapshot yet -> the run re-inits: empty ring
                    astate = init_async_state(
                        self.prog, self.ep_run, self.graph,
                        self._ring_delay, self.device)._replace(
                        core=core._replace(tick=torch.zeros_like(core.tick)))
                    self._dev_tick = 0
                    self._clock = [0] * self.graph.num_shards
                pending = _read(ex_mod.ring_pending(astate.ring))
            totals["replayed"] += extra["replayed"]
            totals["failures"] += extra["failures"]
            if extra["failures"]:
                inflight = ((astate.ring.ids >= 0)
                            & (astate.ring.due >= 0)[..., None])
                busy = (astate.core.active.sum(dim=1)
                        + inflight.sum(dim=(0, 1, 3)))
                n_active, shard_busy = _to_host(astate.core.active.sum(),
                                                busy)
        if self.collect_log:
            self.log.append({
                "tick": t, "active": n_active, "sent": sent,
                "accepted": accepted, "fetched": fetched, "pending": pending,
                "fired": fire_np.astype(int).tolist(),
                "clock": list(self._clock), "shard_active": shard_active,
                "shard_pending": shard_pending})
        self._astate = astate
        self._n_active = n_active
        self._pending = pending
        self._shard_busy = shard_busy

    # -- public surface ------------------------------------------------
    @property
    def state(self) -> EngineState:
        """The core engine state (ring and clock planes stay internal)."""
        if self.schedule == "async":
            return self._astate.core
        if self.crowded:
            return self._cstate.core
        return self._state

    @property
    def ring(self) -> Optional[ex_mod.DelayRing]:
        """The delay ring of the crowded and async paths (None on the
        plain path)."""
        if self.schedule == "async":
            return self._astate.ring
        return self._cstate.ring if self.crowded else None

    @property
    def quiescent(self) -> bool:
        """No frontier anywhere and, on the ring paths, every delivery
        drained; async: every shard's frontier and inbound ring empty."""
        if self.schedule == "async":
            return max(self._shard_busy, default=0) == 0
        if self.crowded:
            return self._n_active == 0 and self._pending == 0
        return self._n_active == 0

    def step(self) -> None:
        """Run exactly one engine tick (plus its fault bookkeeping)."""
        with _trace.span("asymp.session.step"):
            if self.schedule == "async":
                self._step_async()
            elif self.crowded:
                self._step_crowded()
            else:
                self._step_plain()
        self._t += 1

    def tick_until_quiescent(self, budget: Optional[int] = None) -> dict:
        """Tick until quiescent or ``budget`` ticks elapse; returns the
        cumulative totals snapshot.  ``None`` -> ``cfg.max_ticks``.  The
        first call runs at least one tick, as the JAX package's does."""
        budget = self.cfg.max_ticks if budget is None else budget
        for _ in range(budget):
            if self.totals["ticks"] > 0 and self.quiescent:
                break
            self.step()
            if self.quiescent:
                break
        return self.totals_snapshot()

    def totals_snapshot(self) -> dict:
        """The metrics dict ``run_to_convergence`` returns (ring paths add
        ``pending``, the async schedule the ``clock`` vector)."""
        out = dict(self.totals)
        if self.crowded or self.schedule == "async":
            out["pending"] = self._pending
        out["converged"] = self.quiescent
        if self.schedule == "async":
            out["clock"] = list(self._clock)
        out["log"] = self.log
        return out

    # -- streaming-delta hooks (serve/graph.py) ------------------------
    def fork(self) -> "EngineSession":
        """A shadow copy of this session: same graph, program, params,
        schedule and compiled tick, with the CURRENT run state (core
        state, ring, demotion and clock planes, their host mirrors, host
        step, totals and log) duplicated, so that the fork and the
        original tick independently from this instant.

        The double-buffered serving path's write handle: the primary keeps
        answering at the committed fixpoint while the fork absorbs a delta
        (``serve/graph.py::DeltaTransaction``).  Tensors are shared, not
        copied: no path writes into one in place (class docstring).  The
        fork gets a FRESH fault manager (no log, no snapshots), which
        ``rebase_recovery`` seeds, as the delta path requires."""
        new = copy.copy(self)
        if self.fault_mgr is not None:
            new.fault_mgr = new._fault_manager(self.fault_mgr.ep,
                                               self.fault_mgr.replay_slack)
        new.totals = dict(self.totals)
        new.log = list(self.log)
        if self.schedule == "async":
            new._clock = list(self._clock)
            new._shard_busy = list(self._shard_busy)
        return new

    def replace_state(self, core: EngineState) -> None:
        """Swap the core engine state (host-side delta seeding) and refresh
        the activity counters.  The ring, demotion and clock planes are
        kept: deltas are applied at quiescence, with the rings drained."""
        if self.schedule == "async":
            self._astate = self._astate._replace(core=core)
            ring = self._astate.ring
            inflight = (ring.ids >= 0) & (ring.due >= 0)[..., None]
            self._n_active, self._shard_busy = _to_host(
                core.active.sum(),
                core.active.sum(dim=1) + inflight.sum(dim=(0, 1, 3)))
        elif self.crowded:
            self._cstate = self._cstate._replace(core=core)
            self._n_active = _read(torch.sum(core.active))
        else:
            self._state = core
            self._n_active = _read(torch.sum(core.active))

    def rebind_graph(self, graph: ShardedGraph) -> None:
        """Point the session at a patched graph (streaming delta): the
        device copy is uploaded again; EngineParams stay as derived for
        the original graph, so route capacity keeps its head-room across
        small deltas."""
        self.graph = graph
        self.g = to_device_graph(graph, self.device)
        if self.fault_mgr is not None:
            self.fault_mgr.graph = graph
            self.fault_mgr._boundary = None

    def rebase_recovery(self) -> None:
        """Make the CURRENT state the recovery floor (right after a delta
        is seeded): snapshots and logged messages of the old graph would
        resurrect stale values if restored or replayed.  Checkpoint-restore
        recovery also re-cuts its ring snapshot here."""
        if self.fault_mgr is None:
            return
        if self.schedule == "async":
            a = self._astate
            self.fault_mgr.rebase(self._t, a.core, clock=self._clock,
                                  graph=self.graph)
            self._ring_ckpt = (a.ring, a.demote, a.core.tick, a.clock,
                               self._dev_tick, list(self._clock))
        elif self.crowded:
            c = self._cstate
            self.fault_mgr.rebase(self._t, c.core, graph=self.graph)
            self._ring_ckpt = (c.ring, c.demote, c.core.tick)
        else:
            self.fault_mgr.rebase(self._t, self._state, graph=self.graph)


def run_to_convergence(cfg: GraphConfig, *,
                       graph: Optional[ShardedGraph] = None,
                       prog=None, params: Optional[EngineParams] = None,
                       max_ticks: Optional[int] = None,
                       collect_log: bool = False,
                       fault_plan=None, latency=None,
                       schedule: Optional[str] = None,
                       device: DeviceLike = None):
    """Host loop (the propagation phase).  Returns (state, metrics dict).
    See :class:`EngineSession` for ``latency`` and ``schedule``."""
    session = EngineSession(cfg, graph=graph, prog=prog, params=params,
                            collect_log=collect_log, fault_plan=fault_plan,
                            latency=latency, schedule=schedule, device=device)
    totals = session.tick_until_quiescent(
        cfg.max_ticks if max_ticks is None else max_ticks)
    return session.state, totals


# ======================================================================
# Dry run of the dist tick
# ======================================================================
def lower_tick_for_mesh(cfg: GraphConfig, n_workers: int,
                        cost=None) -> dict:
    """The dry run of one rank's dist tick at ``n_workers`` ranks: the JAX
    package's ``info`` (``workers``, ``vs``, ``es``, ``M``, ``D``, ``cap``,
    ``wire``, ``wire_bytes_per_tick``, ``schedule``; ``ring_slots`` on the
    crowded and async ticks, ``latency_profile`` on the crowded one), from
    the same ``derive_params`` and, for async, the same cycle-scaled
    window and capacity.  There is no compiler to lower to: the tick runs
    once under ``FakeTensorMode``, on one rank's arguments and a
    :class:`~repro_torch.dist.exchange.ShapeOnlyGroup` for the
    collectives, so its shapes are checked at any size without
    allocating (a tick that changed its state's shapes raises).
    ``argument_bytes`` adds up that rank's state, graph, ring and
    replicated inputs (the counterpart of XLA's
    ``argument_size_in_bytes``).  ``cost``, a counting dispatch mode
    with a ``collectives`` list (``roofline.probes.CostMode``), is
    entered inside the fake mode, and the group appends each collective
    the tick makes to that list as ``(op, result_bytes, ranks)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist import latency as lat_mod
    from repro_torch.dist.sharding import vertex_partition
    cfg = dataclasses.replace(cfg, num_shards=n_workers)
    prog = prog_mod.get_program(cfg)
    vs = vertex_partition(cfg.num_vertices, n_workers).vs
    es = max(cfg.num_edges * 2 // n_workers, 1)  # symmetrized estimate
    ep = derive_params(cfg, num_shards=n_workers, vs=vs, es=es,
                       num_vertices=cfg.num_vertices, prog=prog)
    codec = wire_codec(prog, ep)
    info = {"workers": n_workers, "vs": vs, "es": es,
            "M": ep.max_vertices_per_tick, "D": ep.degree_window,
            "cap": ep.route_capacity, "wire": codec.compression,
            "wire_bytes_per_tick": codec.wire_bytes_per_tick(),
            "schedule": cfg.schedule}
    group = ex_mod.ShapeOnlyGroup(
        0, n_workers, None if cost is None else cost.collectives)
    vdt, P_ = prog.tdtype, n_workers
    empty = torch.empty
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), \
                (cost if cost is not None else contextlib.nullcontext()):
            state = EngineState(
                empty((1, vs), dtype=vdt), empty((1, vs), dtype=torch.bool),
                empty((1, vs), dtype=_I32), empty((), dtype=_I32),
                empty((1, prog.aux_channels, vs), dtype=vdt)
                if prog.aux_channels else None)
            g = ShardGraph(empty((1, vs + 1), dtype=_I32),
                           empty((1, es), dtype=_I32),
                           empty((1, es), dtype=torch.float32)
                           if prog.weighted else None)

            def ring(ring_delay, cap):
                L1 = ring_delay + 1
                return ex_mod.DelayRing(empty((L1, P_, cap), dtype=vdt),
                                        empty((L1, P_, cap), dtype=_I32),
                                        empty((L1, P_), dtype=_I32))

            delays = empty((P_, P_), dtype=_I32)
            if cfg.schedule == "async":
                lat = (lat_mod.from_config(cfg)
                       if cfg.latency_profile != "none" else None)
                inter = lat_mod.make_interleaving(
                    n_workers, rates=lat.throttle if lat else None,
                    seed=cfg.async_seed, jitter=cfg.async_jitter)
                ring_delay = async_ring_delay(lat.max_delay if lat else 0,
                                              inter.stall_bound())
                # a rate-k firing carries k steps' window and routing room
                r_all = int(inter.rates.max(initial=1))
                if r_all > 1:
                    ep = dataclasses.replace(
                        ep, degree_window=ep.degree_window * r_all,
                        route_capacity=ep.route_capacity * r_all)
                info["D"], info["cap"] = ep.degree_window, ep.route_capacity
                info["ring_slots"] = ring_delay + 1
                args = (AsyncState(state, ring(ring_delay,
                                               ep.route_capacity),
                                   empty((1, vs), dtype=torch.bool),
                                   empty((1,), dtype=_I32)),
                        g, delays, empty((P_,), dtype=torch.bool),
                        empty((P_,), dtype=_I32))
                out, _ = make_async_dist_tick(prog, ep, group,
                                              prog.weighted)(*args)
            elif cfg.latency_profile != "none":
                lat = lat_mod.from_config(cfg)
                info["ring_slots"] = int(lat.max_delay) + 1
                info["latency_profile"] = cfg.latency_profile
                args = (CrowdedState(state, ring(int(lat.max_delay),
                                                 ep.route_capacity),
                                     empty((1, vs), dtype=torch.bool)),
                        g, delays, empty((P_,), dtype=_I32))
                out, _, _ = make_crowded_dist_tick(prog, ep, group,
                                                   prog.weighted)(*args)
            else:
                args = (state, g)
                out, _ = make_dist_tick(prog, ep, group,
                                        prog.weighted)(*args)
            before, after = _leaves(args[0]), _leaves(out)
            if [(t.shape, t.dtype) for t in before] != \
                    [(t.shape, t.dtype) for t in after]:
                raise RuntimeError(
                    f"the dist tick changed its state's shapes at "
                    f"{n_workers} ranks")
            info["argument_bytes"] = sum(t.numel() * t.element_size()
                                         for t in _leaves(args))
    finally:
        # the bucket-edge tables are cached per device: drop any that
        # were made under the fake mode
        _log_bucket_edges.cache_clear()
        prog_mod._pagerank_edges.cache_clear()
    return info


def _leaves(tree) -> list:
    """The tensors of a (nested) tuple, in order; None skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]
