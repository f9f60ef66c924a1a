"""The JAX package's side of ``tests/test_torch_dist.py``: its dist ticks
and dist transports under ``shard_map`` on a mesh of 4 CPU devices, every
tick recorded into one ``.npz``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_dist_jax_ref.py OUT.npz
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from _dist_cases import (CASES, CODECS, DELAYS, MAX_DELAY, MAX_TICKS,
                         RATES, T_CAP, T_TICKS, T_VS, THROTTLE, WORKERS,
                         digest, program, state_fields, transport_inputs)
from repro.configs.base import GraphConfig
from repro.core import engine as E
from repro.core import graph as G
from repro.core import programs as PR
from repro.dist import exchange as X
from repro.dist import latency as L
from repro.dist.compat import shard_map


def rows(fields) -> list:
    """Per rank, the digest of each field's rows (a 0-d field is every
    rank's)."""
    host = [np.asarray(f) for f in fields]
    return [[digest(h if h.ndim == 0 else h[r]) for h in host]
            for r in range(WORKERS)]


def run_case(mesh, spec) -> dict:
    cfg = GraphConfig(**spec["cfg"])
    g = G.build_sharded_graph(cfg)
    prog = program(PR, cfg)
    ep = E.default_params(cfg, g, prog)
    dg = E.to_device_graph(g)
    delays = jnp.asarray(DELAYS, jnp.int32)
    stats, digests = [], []
    if spec["kind"] == "plain":
        tick = jax.jit(E.make_dist_tick(prog, ep, mesh, prog.weighted))
        state = E.init_state(prog, g)
    elif spec["kind"] == "crowded":
        tick = jax.jit(E.make_crowded_dist_tick(prog, ep, mesh,
                                                prog.weighted))
        state = E.init_crowded_dist_state(prog, ep, g, MAX_DELAY)
        throttle = jnp.asarray(THROTTLE, jnp.int32)
    else:
        inter = L.make_interleaving(WORKERS, rates=RATES, seed=0)
        ring_delay = E.async_ring_delay(MAX_DELAY, inter.stall_bound())
        r_all = max(RATES)
        window = jnp.asarray(np.minimum(RATES, r_all) * ep.degree_window,
                             jnp.int32)
        ep = dataclasses.replace(
            ep, degree_window=ep.degree_window * r_all,
            route_capacity=ep.route_capacity * r_all)
        tick = E.make_async_dist_tick(prog, ep, mesh, prog.weighted)
        state = E.init_async_dist_state(prog, ep, g, ring_delay)
    for t in range(MAX_TICKS):
        if spec["kind"] == "plain":
            state, st = tick(state, dg)
            row = [int(x) for x in st]
            done = row[0] == 0
        elif spec["kind"] == "crowded":
            state, st, pending = tick(state, dg, delays, throttle)
            row = [int(x) for x in st] + [int(pending)]
            done = row[0] == 0 and row[4] == 0
        else:
            fire = jnp.asarray(inter.fire_mask(t, rates=np.asarray(RATES)))
            state, st = tick(state, dg, delays, fire, window)
            row = ([int(x) for x in st.base] + [int(st.pending)]
                   + [int(x) for x in st.shard_active]
                   + [int(x) for x in st.shard_pending]
                   + [int(x) for x in st.clock])
            busy = np.asarray(st.shard_active) + np.asarray(st.shard_pending)
            done = not busy.any()
        stats.append(row)
        digests.append(rows(state_fields(state)))
        if done:
            break
    final = [digest(np.asarray(f)) for f in state_fields(state)]
    return {"stats": np.asarray(stats, np.int64),
            "digests": np.asarray(digests), "final": np.asarray(final)}


def run_transports(mesh) -> dict:
    """Every codec through ``exchange_dist`` once and through
    ``exchange_dist_delayed`` for ``T_TICKS`` ticks with a sender ring."""
    Pw = P("workers")
    out = {}
    for name, kw in CODECS.items():
        codec = X.make_wire_codec(num_shards=WORKERS, capacity=T_CAP,
                                  vs=T_VS, max_int_value=T_VS * WORKERS,
                                  idempotent=True, **kw)
        ident = kw["identity"]
        dtype = jnp.int32 if kw["value_kind"] == "int32" else jnp.float32
        inp = transport_inputs(kw["value_kind"])

        def once(v, i):
            rv, ri = X.exchange_dist(codec, v[0], i[0], "workers")
            return rv[None], ri[None]

        sm = jax.jit(shard_map(once, mesh=mesh, in_specs=(Pw, Pw),
                               out_specs=(Pw, Pw), check_vma=False))
        rv, ri = sm(jnp.asarray(inp["vals"][0]), jnp.asarray(inp["ids"][0]))
        out[f"{name}/once_vals"] = np.asarray(rv)
        out[f"{name}/once_ids"] = np.asarray(ri)

        def delayed(rvr, rir, rdr, v, i, tick, delays, gate):
            sid = jax.lax.axis_index("workers")
            ring = X.DelayRing(rvr[0], rir[0], rdr[0])
            rv, ri, ring, pending = X.exchange_dist_delayed(
                codec, ring, v[0], i[0], tick, delays[sid], "workers",
                ident, recv_gate=gate)
            return (rv[None], ri[None], ring.vals[None], ring.ids[None],
                    ring.due[None], pending[None])

        sm = jax.jit(shard_map(
            delayed, mesh=mesh,
            in_specs=(Pw, Pw, Pw, Pw, Pw, P(), P(), P()),
            out_specs=(Pw,) * 6, check_vma=False))
        L1 = MAX_DELAY + 1
        ring = (jnp.full((WORKERS, L1, WORKERS, T_CAP), ident, dtype),
                jnp.full((WORKERS, L1, WORKERS, T_CAP), -1, jnp.int32),
                jnp.full((WORKERS, L1, WORKERS), -1, jnp.int32))
        got = []
        for t in range(T_TICKS):
            rv, ri, *ring, pending = sm(
                *ring, jnp.asarray(inp["vals"][t]),
                jnp.asarray(inp["ids"][t]), jnp.asarray(t, jnp.int32),
                jnp.asarray(inp["delays"][t]), jnp.asarray(inp["gate"][t]))
            got.append((np.asarray(rv), np.asarray(ri), np.asarray(pending),
                        [np.asarray(x) for x in ring]))
        out[f"{name}/delayed_vals"] = np.stack([g[0] for g in got])
        out[f"{name}/delayed_ids"] = np.stack([g[1] for g in got])
        out[f"{name}/delayed_pending"] = np.stack([g[2] for g in got])
        for k, field in enumerate(("vals", "ids", "due")):
            out[f"{name}/ring_{field}"] = np.stack([g[3][k] for g in got])
    return out


def main(path: str) -> None:
    devices = jax.devices()
    if len(devices) < WORKERS:
        raise SystemExit(f"needs {WORKERS} host devices, got "
                         f"{len(devices)}: set XLA_FLAGS="
                         f"--xla_force_host_platform_device_count=4")
    mesh = Mesh(np.array(devices[:WORKERS]), ("workers",))
    rec = {}
    for name, spec in CASES.items():
        for k, v in run_case(mesh, spec).items():
            rec[f"{name}/{k}"] = v
    for k, v in run_transports(mesh).items():
        rec[f"transport/{k}"] = v
    np.savez(path, **rec)


if __name__ == "__main__":
    main(sys.argv[1])
