"""The port's side of ``tests/test_torch_dist.py``: job functions for a
``repro_torch.launch.mesh.RankPool`` of 4 gloo ranks on the CPU.  Imports
no JAX (each rank process imports this module to find its job)."""
import dataclasses

import numpy as np
import torch

from _dist_cases import (CASES, CODECS, DELAYS, MAX_DELAY, MAX_TICKS,
                         RATES, T_CAP, T_TICKS, T_VS, THROTTLE, WORKERS,
                         digest, program, state_fields, transport_inputs)
from repro_torch.configs.base import GraphConfig
from repro_torch.core import engine as E
from repro_torch.core import graph as G
from repro_torch.core import programs as PR
from repro_torch.dist import exchange as X
from repro_torch.dist import latency as L
from repro_torch.launch.mesh import gather_rows, rank_rows

CPU = "cpu"


def run_case(ctx, name: str, start: dict) -> dict:
    """One case to quiescence on this rank, from the JAX package's start
    state (``start``: its global ``EngineState`` fields as numpy arrays):
    every tick's global counters and this rank's field digests, and the
    final state gathered back to every rank."""
    spec = CASES[name]
    cfg = GraphConfig(**spec["cfg"])
    graph = G.build_sharded_graph(cfg)
    prog = program(PR, cfg)
    ep = E.default_params(cfg, graph, prog)
    g = rank_rows(E.to_device_graph(graph, CPU), ctx.rank)
    core = E.state_from_numpy(**start, device=CPU)
    delays = torch.tensor(DELAYS, dtype=torch.int32)
    if spec["kind"] == "plain":
        tick = E.make_dist_tick(prog, ep, ctx.group, prog.weighted)
        state = core
    elif spec["kind"] == "crowded":
        tick = E.make_crowded_dist_tick(prog, ep, ctx.group, prog.weighted)
        state = E.init_crowded_dist_state(prog, ep, graph, MAX_DELAY,
                                          CPU)._replace(core=core)
        throttle = torch.tensor(THROTTLE, dtype=torch.int32)
    else:
        inter = L.make_interleaving(WORKERS, rates=RATES, seed=0)
        ring_delay = E.async_ring_delay(MAX_DELAY, inter.stall_bound())
        r_all = max(RATES)
        window = torch.tensor(np.minimum(RATES, r_all) * ep.degree_window,
                              dtype=torch.int32)
        ep = dataclasses.replace(
            ep, degree_window=ep.degree_window * r_all,
            route_capacity=ep.route_capacity * r_all)
        tick = E.make_async_dist_tick(prog, ep, ctx.group, prog.weighted)
        state = E.init_async_dist_state(prog, ep, graph, ring_delay,
                                        CPU)._replace(core=core)
    state = rank_rows(state, ctx.rank)
    stats, digests = [], []
    for t in range(MAX_TICKS):
        if spec["kind"] == "plain":
            state, st = tick(state, g)
            row = [int(x) for x in st]
            done = row[0] == 0
        elif spec["kind"] == "crowded":
            state, st, pending = tick(state, g, delays, throttle)
            row = [int(x) for x in st] + [int(pending)]
            done = row[0] == 0 and row[4] == 0
        else:
            fire = torch.from_numpy(inter.fire_mask(
                t, rates=np.asarray(RATES)))
            state, st = tick(state, g, delays, fire, window)
            row = ([int(x) for x in st.base] + [int(st.pending)]
                   + st.shard_active.tolist() + st.shard_pending.tolist()
                   + st.clock.tolist())
            done = not (st.shard_active + st.shard_pending).any()
        stats.append(row)
        digests.append([digest(f.numpy()) for f in state_fields(state)])
        if done:
            break
    final = gather_rows(state, ctx.group)
    return {"stats": stats, "digests": digests,
            "final": [digest(f.numpy()) for f in state_fields(final)]}


def run_transports(ctx) -> dict:
    """Every codec through ``exchange_dist`` once and
    ``exchange_dist_delayed`` for ``T_TICKS`` ticks; each result is held
    here against this rank's rows of the local transport's on the same
    global buffers (the same bits in the same row order: ``mismatches``
    lists where they differ), and returned for the JAX package's."""
    r = ctx.rank
    out, bad = {}, []

    def _equal(a, b, what: str) -> None:
        if a.dtype != b.dtype or a.shape != b.shape or \
                a.numpy().tobytes() != b.numpy().tobytes():
            bad.append(what)

    for name, kw in CODECS.items():
        codec = X.make_wire_codec(num_shards=WORKERS, capacity=T_CAP,
                                  vs=T_VS, max_int_value=T_VS * WORKERS,
                                  idempotent=True, **kw)
        ident = kw["identity"]
        dtype = torch.int32 if kw["value_kind"] == "int32" else torch.float32
        inp = {k: torch.from_numpy(v)
               for k, v in transport_inputs(kw["value_kind"]).items()}
        rv, ri = X.exchange_dist(codec, inp["vals"][0, r], inp["ids"][0, r],
                                 ctx.group)
        lv, li = X.exchange_local(codec, inp["vals"][0], inp["ids"][0])
        _equal(rv, lv[r], f"{name}: exchange_dist values")
        _equal(ri, li[r], f"{name}: exchange_dist ids")
        out[f"{name}/once_vals"], out[f"{name}/once_ids"] = rv, ri
        ring = X.init_delay_ring(MAX_DELAY, 0, WORKERS, T_CAP, ident, dtype)
        local = X.init_delay_ring(MAX_DELAY, WORKERS, WORKERS, T_CAP, ident,
                                  dtype)
        got = []
        for t in range(T_TICKS):
            tick = torch.tensor(t, dtype=torch.int32)
            rv, ri, ring, pending = X.exchange_dist_delayed(
                codec, ring, inp["vals"][t, r], inp["ids"][t, r], tick,
                inp["delays"][t, r], ctx.group, ident,
                recv_gate=inp["gate"][t])
            lv, li, local, _ = X.exchange_local_delayed(
                codec, local, inp["vals"][t], inp["ids"][t], tick,
                inp["delays"][t], ident, recv_gate=inp["gate"][t])
            _equal(rv, lv[r], f"{name}: exchange_dist_delayed values, {t}")
            _equal(ri, li[r], f"{name}: exchange_dist_delayed ids, {t}")
            for mine, theirs in zip(ring, local):  # [L1, Pn..] vs [L1, P..]
                _equal(mine, theirs[:, r], f"{name}: ring at tick {t}")
            got.append((rv, ri, pending, ring))
        out[f"{name}/delayed_vals"] = torch.stack([x[0] for x in got])
        out[f"{name}/delayed_ids"] = torch.stack([x[1] for x in got])
        out[f"{name}/delayed_pending"] = torch.stack([x[2] for x in got])
        for k, field in enumerate(("vals", "ids", "due")):
            out[f"{name}/ring_{field}"] = torch.stack([x[3][k] for x in got])
    return {"mismatches": bad, **{k: v.numpy() for k, v in out.items()}}


def raise_on(ctx, rank: int) -> int:
    """A job that fails on one rank (the pool must end and raise)."""
    if ctx.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return ctx.rank
