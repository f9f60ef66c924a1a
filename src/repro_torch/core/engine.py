"""The ASYMP engine: priority-driven asynchronous-style propagation ticks.

Counterpart of ``repro.core.engine`` on its plain synchronous path.  One
tick, for all shards at once (tensors carry the shard axis first:
``[P, vs]`` vertex state, ``[P, M, D]`` fetch windows, ``[P, Pn, cap]``
send buffers — the JAX package's ``vmap`` written out as a batch axis):

  select   — per-shard priority queue: bucketized priorities (linear/log,
             §3.5), enforcement fraction rho (§5.6), top-M cap
  fetch    — streamed adjacency window per selected vertex (edge cursor)
  create   — program.combine over the fetched edges
  route    — bucket messages by destination shard into fixed-capacity
             buffers; overflow => the sender retries next tick
  receive  — idempotent scatter-⊕ via the program's Aggregator; improved
             vertices join the frontier

Push mode (pagerank, the non-idempotent SUM aggregator) moves mass
instead: a selected vertex latches its residual, banks it into
``values`` exactly once, and ships only the edge prefix its cursor
commits to; receives scatter-add into the residual plane (``aux``).

The states and counters after every tick are bitwise those of the JAX
package on the CPU (``tests/test_torch_engine.py``,
``tests/test_torch_pagerank.py``).  ``EngineSession`` drives fault plans
(``core/faults.py``).  Not ported yet (each raises
``NotImplementedError`` where a caller asks for it): the crowded-cluster
ring, fault-injected slowdowns, the async schedule, the multi-rank tick
and the serving hooks of ``EngineSession`` (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import GraphConfig
from repro_torch.core import programs as prog_mod
from repro_torch.core.graph import ShardedGraph, build_sharded_graph
from repro_torch.dist import exchange as ex_mod

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
        wire_compression=wire, wire_value_bound=bound)


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
                   row_ptr, col_idx, weights, aux=None):
    """Select + fetch + create + route for all P shards.  Returns
    ``(active, cursor, send_vals [P, Pn, cap], send_ids [P, Pn, cap],
    sent [P], fetched [P], values, aux)``; values and aux change only in
    push mode (``aux`` given).

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
                                    * ep.enforce_fraction), 1, M).to(_I32)
    # push mode ranks by pending mass: residual + latched push
    potential = residual + pushv if push_mode else values
    if prog.bucketize is not None:
        buckets = prog.bucketize(potential, ep.priority, ep.priority_scale)
    else:
        pkey = prog.aggregator.priority_key(prog.priority_value(potential),
                                            ep.priority_scale)
        buckets = priority_buckets(pkey, ep.priority, ep.priority_scale)
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


def _phase2_receive(prog, ep: EngineParams, values, active, cursor,
                    recv_vals, recv_ids):
    """Deliver: idempotent scatter-⊕ (the program's aggregator); improved
    vertices activate.  ``recv_* [P, ...]`` per receiving shard."""
    agg = prog.aggregator
    vs = ep.vs
    P = values.shape[0]
    ids = recv_ids.reshape(P, -1)
    vals = recv_vals.reshape(P, -1).to(prog.tdtype)
    valid = ids >= 0
    idx = torch.where(valid, ids, vs)  # vs -> dropped (out of bounds)
    old = values
    values = agg.scatter(values, idx, vals)
    prev = torch.gather(old, 1, torch.clamp(idx, 0, vs - 1).to(torch.int64))
    accepted = (valid & agg.improves(vals, prev)).sum(dim=1)
    changed = agg.improves(values, old)
    active = active | changed
    cursor = torch.where(changed, 0, cursor)
    return values, active, cursor, accepted


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
def make_local_tick(prog, ep: EngineParams, weighted: bool):
    """``tick(state, g) -> (state', TickStats, (send_vals, send_ids))``:
    one tick of all shards, exchanged by the local transport.  Push-mode
    (non-idempotent) programs thread their ``aux`` planes through it."""
    codec = wire_codec(prog, ep)
    push_mode = not prog.aggregator.idempotent

    def tick(state: EngineState, g: ShardGraph):
        w = g.weights if weighted else None
        active, cursor, sv, si, sent, fetched, values, aux = _phase1_create(
            prog, ep, state.values, state.active, state.cursor, g.row_ptr,
            g.col_idx, w, aux=state.aux if push_mode else None)
        # exchange: send[p][q] -> recv[q][p] via the dist substrate
        rv, ri = ex_mod.exchange_local(codec, sv, si)
        if push_mode:
            residual, active, accepted = _phase2_receive_push(
                prog, ep, aux[:, 0], active, rv, ri)
            aux = torch.stack([residual, aux[:, 1]], dim=1)
        else:
            values, active, cursor, accepted = _phase2_receive(
                prog, ep, values, active, cursor, rv, ri)
            aux = state.aux  # None, or an untouched caller-supplied plane
        stats = TickStats(active.sum(), sent.sum(), accepted.sum(),
                          fetched.sum())
        return (EngineState(values=values, active=active, cursor=cursor,
                            tick=state.tick + 1, aux=aux),
                stats, (sv, si))

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


class EngineSession:
    """A resumable engine run on the plain synchronous path: the host-side
    loop behind :func:`run_to_convergence` (tick a few steps, read the
    state, tick again).

    ``fault_plan`` (a ``core.faults.FaultPlan``) kills shards on the
    plan's host steps; after each tick the session records the tick in
    the ``FaultManager``, then lets it fail and recover shards, as the JAX
    package orders it.  The JAX package's session also drives the
    crowded-cluster ring, fault-injected slowdowns and the async
    schedule; those are not ported yet, and asking for one raises
    ``NotImplementedError`` rather than running without it.
    ``device=None`` means the CUDA card (raises if there is none).
    """

    def __init__(self, cfg: GraphConfig, *,
                 graph: Optional[ShardedGraph] = None, prog=None,
                 params: Optional[EngineParams] = None,
                 collect_log: bool = False, fault_plan=None, latency=None,
                 schedule: Optional[str] = None,
                 device: DeviceLike = None):
        schedule = schedule or getattr(cfg, "schedule", "sync") or "sync"
        if schedule not in ("sync", "async"):
            raise ValueError(f"unknown schedule {schedule!r}; "
                             f"valid: 'sync', 'async'")
        missing = []
        if fault_plan is not None and fault_plan.slow_fraction > 0:
            missing.append("fault injection with slowdowns (slow_fraction "
                           "> 0) needs the crowded-cluster emulation "
                           "(ROADMAP queue 1, item 8)")
        if latency is not None or cfg.latency_profile != "none":
            missing.append("crowded-cluster emulation (ROADMAP queue 1, "
                           "item 8)")
        if schedule == "async":
            missing.append("the async schedule (ROADMAP queue 1, item 9)")
        if missing:
            raise NotImplementedError("not ported yet: " + "; ".join(missing))
        self.device = resolve_device(device)
        self.cfg = cfg
        self.graph = graph or build_sharded_graph(cfg)
        self.prog = prog or prog_mod.get_program(cfg)
        self.ep = params or default_params(cfg, self.graph, self.prog)
        self.g = to_device_graph(self.graph, self.device)
        self.collect_log = collect_log
        self.schedule = schedule
        self.fault_plan = fault_plan
        self.log: list = []
        self.totals = {"ticks": 0, "sent": 0, "accepted": 0, "fetched": 0,
                       "replayed": 0, "failures": 0, "pending": 0,
                       "schedule": schedule}
        self._t = 0  # host step counter
        self._init_plain()

    def _init_plain(self) -> None:
        from repro_torch.core import faults
        self.fault_mgr = (faults.FaultManager(self.cfg, self.graph,
                                              self.prog, self.ep,
                                              device=self.device)
                          if self.fault_plan is not None else None)
        self._tick_fn = make_local_tick(self.prog, self.ep,
                                        self.prog.weighted)
        self._state = init_state(self.prog, self.graph, self.device)
        self._n_active = int(torch.sum(self._state.active))

    def _step_plain(self) -> None:
        t, fault_mgr = self._t, self.fault_mgr
        state, stats, send_bufs = self._tick_fn(self._state, self.g)
        n_active = int(stats.active)
        totals = self.totals
        totals["ticks"] += 1
        totals["sent"] += int(stats.sent)
        totals["accepted"] += int(stats.accepted)
        totals["fetched"] += int(stats.fetched)
        if fault_mgr is not None:
            # the kill schedule is keyed on the host step, as in the JAX
            # package
            fault_mgr.record(t, state, send_bufs)
            state, extra = fault_mgr.maybe_fail(t, state, self.fault_plan)
            totals["replayed"] += extra["replayed"]
            totals["failures"] += extra["failures"]
            if extra["failures"]:
                n_active = int(torch.sum(state.active))
        if self.collect_log:
            self.log.append({"tick": t, "active": n_active,
                             "sent": int(stats.sent),
                             "accepted": int(stats.accepted),
                             "fetched": int(stats.fetched)})
        self._state = state
        self._n_active = n_active

    # -- public surface ------------------------------------------------
    @property
    def state(self) -> EngineState:
        return self._state

    @property
    def quiescent(self) -> bool:
        """No frontier anywhere."""
        return self._n_active == 0

    def step(self) -> None:
        """Run exactly one engine tick (plus its fault bookkeeping)."""
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
        """The metrics dict ``run_to_convergence`` returns."""
        out = dict(self.totals)
        out["converged"] = self.quiescent
        out["log"] = self.log
        return out


def run_to_convergence(cfg: GraphConfig, *,
                       graph: Optional[ShardedGraph] = None,
                       prog=None, params: Optional[EngineParams] = None,
                       max_ticks: Optional[int] = None,
                       collect_log: bool = False,
                       fault_plan=None, latency=None,
                       schedule: Optional[str] = None,
                       device: DeviceLike = None):
    """Host loop (the propagation phase).  Returns (state, metrics dict)."""
    session = EngineSession(cfg, graph=graph, prog=prog, params=params,
                            collect_log=collect_log, fault_plan=fault_plan,
                            latency=latency, schedule=schedule, device=device)
    totals = session.tick_until_quiescent(
        cfg.max_ticks if max_ticks is None else max_ticks)
    return session.state, totals
