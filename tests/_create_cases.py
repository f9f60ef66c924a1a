"""Shared by the create tests (``test_torch_create.py`` on the CPU,
``test_torch_gpu.py`` on the card): the inputs of the engine tick's create
(``core/engine.py::_phase1_create``) in the cases its callers hand it, and a
slow loop that spells out its semantics one selected vertex and one edge
at a time.

Every case draws a small sharded graph (degree-0 vertices, edges into
every shard, the last included) and a state (ties inside buckets, cursors
mid-stream and at the end of their rows) from its seed.  The table covers
the six idempotent programs (int32 and float32, weighted and unweighted,
the three priority strategies), a routing overflow (a small ``cap``, so
the cursor stops at the first dropped edge and retries), ``throttle``,
``demote`` and ``stream_window``, the async tick's widened ``D`` and
``cap``, one shard of the dist ticks (``P = 1``), an empty frontier and a
frontier above ``M`` with ``M < vs``."""
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import programs as PG


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    program: str
    weighted: bool = False
    priority: str = "log"
    P: int = 3  # shards handed to create (1: one rank of a dist tick)
    Pn: int = 3  # destination shards
    vs: int = 40
    M: int = 24
    D: int = 4
    cap: int = 64
    rho: float = 0.5
    live: float = 0.6  # share of active vertices
    throttle: Optional[tuple] = None
    demote: int = 0  # straggler_demote (0: no demotion plane)
    window: Optional[tuple] = None


CASES = [
    Case("cc", "cc"),
    Case("sssp", "sssp", weighted=True),
    Case("sssp_unweighted", "sssp"),
    Case("bfs", "bfs", priority="linear"),
    Case("reachability", "reachability", priority="disabled"),
    Case("widest_path", "widest_path", weighted=True),
    Case("widest_path_unweighted", "widest_path", priority="linear"),
    Case("labelprop", "labelprop", priority="linear"),
    Case("overflow_cc", "cc", cap=3, rho=1.0),
    Case("overflow_sssp", "sssp", weighted=True, cap=2, rho=1.0),
    Case("throttle", "cc", rho=1.0, throttle=(1, 3, 40)),
    Case("demote", "sssp", weighted=True, demote=3),
    Case("demote_disabled", "cc", priority="disabled", demote=5, rho=0.3),
    Case("stream_window", "bfs", window=(4, 2, 0)),
    Case("async_wide", "sssp", weighted=True, D=8, cap=128, demote=2,
         window=(8, 4, 8)),
    Case("crowded_overflow", "labelprop", cap=4, rho=1.0,
         throttle=(2, 1, 5), demote=1),
    Case("dist_one_shard", "cc", P=1, Pn=4),
    Case("dist_one_shard_async", "sssp", weighted=True, P=1, Pn=4, D=8,
         window=(6,), cap=5, rho=1.0),
    Case("empty_frontier", "sssp", weighted=True, live=0.0),
    Case("frontier_above_m", "cc", M=10, rho=1.0, live=1.0),
    Case("all_selected", "bfs", M=40, rho=1.0, priority="disabled"),
]


def case_id(case: Case) -> str:
    return case.name


def make_case(case: Case, device, seed: int = 0):
    """``(prog, ep, args, kwargs)`` for ``_phase1_create(prog, ep, *args,
    **kwargs)``, the same numbers on every device for one seed."""
    rng = np.random.default_rng(seed)
    prog = PG.get_program(case.program, **(
        {"source": 0} if case.program not in ("cc", "labelprop") else {}))
    P, Pn, vs = case.P, case.Pn, case.vs
    ep = E.EngineParams(
        num_shards=Pn, vs=vs, max_vertices_per_tick=case.M,
        degree_window=case.D, route_capacity=case.cap,
        enforce_fraction=case.rho, priority=case.priority,
        priority_scale=prog.priority_scale or float(Pn * vs),
        straggler_demote=case.demote)
    # degrees: a third 0, the rest up to 3 windows; edges to every shard,
    # the last one twice as often
    deg = np.where(rng.random((P, vs)) < 0.3, 0,
                   rng.integers(1, 3 * case.D + 2, (P, vs)))
    row_ptr = np.zeros((P, vs + 1), np.int32)
    row_ptr[:, 1:] = np.cumsum(deg, axis=1)
    es = int(row_ptr[:, -1].max()) + 5  # padded rows, as a built graph's
    shard = np.minimum(rng.integers(0, Pn + 1, (P, es)), Pn - 1)
    col_idx = (shard * vs + rng.integers(0, vs, (P, es))).astype(np.int32)
    for p in range(P):
        col_idx[p, row_ptr[p, -1]:] = -1
    weights = (rng.integers(0, 8, (P, es)) / 8).astype(np.float32)
    # values from a small set, so that buckets hold ties
    if prog.tdtype == torch.int32:
        top = {"reachability": 2, "labelprop": Pn * vs}.get(prog.name, 50)
        low = -1 if prog.name == "labelprop" else 0
        values = rng.integers(low, top, (P, vs)).astype(np.int32)
        if prog.name == "bfs":
            values[:, ::7] = 2 ** 31 - 1  # the int identity: + 1 wraps
    else:
        scale = ep.priority_scale
        values = (rng.integers(0, 12, (P, vs)) * scale / 16
                  ).astype(np.float32)
        values[:, ::9] = np.inf
    active = rng.random((P, vs)) < case.live
    # cursors: at the row's start, mid-stream, or at its end
    pick = rng.random((P, vs))
    cursor = np.where(pick < 0.5, 0, np.where(
        pick < 0.85, (deg * rng.random((P, vs))).astype(np.int64), deg)
    ).astype(np.int32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    args = (put(values), put(active), put(cursor), put(row_ptr),
            put(col_idx), put(weights) if case.weighted else None)
    kwargs = {}
    if case.throttle is not None:
        kwargs["throttle"] = put(np.asarray(case.throttle, np.int32))
    if case.demote:
        kwargs["demote"] = put(rng.random((P, vs)) < 0.4)
    if case.window is not None:
        kwargs["stream_window"] = put(np.asarray(case.window, np.int32))
    return prog, ep, args, kwargs


def create_loop(prog, ep, values, active, cursor, row_ptr, col_idx, weights,
                throttle=None, demote=None, stream_window=None):
    """``_phase1_create`` spelled out: per shard, the first ``target``
    active vertices in (bucket, index) order, each streaming its window one
    edge at a time into the next free slot of its destination's row."""
    host = lambda t: None if t is None else t.cpu()  # noqa: E731
    values, active, cursor, row_ptr, col_idx, weights = map(
        host, (values, active, cursor, row_ptr, col_idx, weights))
    P, vs = values.shape
    M, D, Pn, cap = (ep.max_vertices_per_tick, ep.degree_window,
                     ep.num_shards, ep.route_capacity)
    pkey = prog.aggregator.priority_key(prog.priority_value(values),
                                        ep.priority_scale)
    buckets = E.priority_buckets(pkey, ep.priority, ep.priority_scale)
    active_out, cursor_out = active.clone(), cursor.clone()
    send_vals = torch.full((P, Pn, cap), prog.identity, dtype=prog.tdtype)
    send_ids = torch.full((P, Pn, cap), -1, dtype=torch.int32)
    sent = torch.zeros((P,), dtype=torch.int64)
    fetched = torch.zeros((P,), dtype=torch.int64)
    for p in range(P):
        bucket = [int(b) for b in buckets[p]]
        if demote is not None and ep.straggler_demote:
            bucket = [min(b + ep.straggler_demote, E.N_BUCKETS - 1)
                      if bool(demote[p, v]) else b
                      for v, b in enumerate(bucket)]
        frontier = [v for v in range(vs) if bool(active[p, v])]
        target = np.ceil(np.float32(len(frontier))
                         * np.float32(ep.enforce_fraction))
        target = int(min(max(target, 1), M))
        if throttle is not None:
            target = min(target, max(M // max(int(throttle[p]), 1), 1))
        chosen = sorted(frontier, key=lambda v: (bucket[v], v))[:target]
        window = D if stream_window is None else int(stream_window[p])
        used = [0] * Pn
        for v in chosen:
            lo = int(row_ptr[p, v])
            deg = int(row_ptr[p, v + 1]) - lo
            cur = int(cursor[p, v])
            first_drop = D
            for d in range(min(D, window)):
                if cur + d >= deg:
                    break
                e = lo + cur + d
                dst = int(col_idx[p, e])
                q = dst // vs
                w = None if weights is None else weights[p, e:e + 1][None]
                msg = prog.combine(values[p, v:v + 1][None], w)
                fetched[p] += 1
                if used[q] < cap:
                    send_vals[p, q, used[q]] = msg.reshape(()).to(prog.tdtype)
                    send_ids[p, q, used[q]] = dst % vs
                    sent[p] += 1
                else:
                    first_drop = min(first_drop, d)
                used[q] += 1
            nxt = cur + min(first_drop, window, deg - cur)
            done = nxt >= deg
            cursor_out[p, v] = 0 if done else nxt
            active_out[p, v] = not done
    return (active_out, cursor_out, send_vals, send_ids, sent, fetched,
            values, None)


FIELDS = ("active", "cursor", "send_vals", "send_ids", "sent", "fetched",
          "values", "aux")


def assert_same(got, want, where: str) -> None:
    """Every output bitwise equal, dtype and shape included (``aux`` is
    None on both sides)."""
    for g, w, field in zip(got, want, FIELDS):
        if w is None:
            assert g is None, f"{where}: {field}"
            continue
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where}: {field}"
        if g.dtype.is_floating_point:  # NaN-free; inf compares equal
            assert torch.equal(g.view(torch.int32), w.cpu().contiguous()
                               .view(torch.int32)), f"{where}: {field}"
        else:
            assert torch.equal(g, w.cpu()), f"{where}: {field}"
