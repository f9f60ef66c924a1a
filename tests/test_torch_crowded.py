"""Port parity: crowded-cluster emulation (paper §5.4).

The same seeded graphs, latency models and fault plans go through the JAX
package (on the CPU) and the port (``device="cpu"``): the latency models,
the slowdown overlay, the delay ring's delivery order, the straggler
demotion and throttle, and whole crowded sessions stepped in lockstep —
core state, delay ring and demotion plane bitwise equal after every tick,
for the six idempotent programs and pagerank, under the uniform,
stragglers and heavy_tail profiles, and composed with kills recovered by
replay or by checkpoint restore while messages are in flight.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

from repro.configs import get_graph_config as j_config  # noqa: E402
from repro.configs.base import GraphConfig as JCfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import programs as JP  # noqa: E402
from repro.dist import exchange as JX  # noqa: E402
from repro.dist import latency as JL  # noqa: E402
from repro_torch.configs import get_graph_config as t_config  # noqa: E402
from repro_torch.configs.base import GraphConfig as TCfg  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import programs as TP  # noqa: E402
from repro_torch.dist import exchange as TX  # noqa: E402
from repro_torch.dist import latency as TL  # noqa: E402

PROFILES = ("uniform", "stragglers", "heavy_tail")
IDEMPOTENT = ["cc", "sssp", "bfs", "reachability", "widest_path",
              "labelprop"]
# tests/conftest.py::rmat_cc_graph's graph; pagerank on a smaller one, with
# a coarser push threshold (a residual push visits every vertex about
# log(1/eps)/log(1/d) times)
BASE = dict(name="t", num_vertices=1024, avg_degree=8, generator="rmat",
            num_shards=4, priority="log", enforce_fraction=0.5, source=5)
PAGERANK = dict(BASE, algorithm="pagerank", num_vertices=256, avg_degree=4,
                source=0, enforce_fraction=1.0)
PUSH_EPS = 1e-4
LATENCY = dict(slow_fraction=0.5, link_delay=3, intensity=3, seed=1)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _bitwise(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _same(j, t, what):
    """Two (nested) state tuples, field by field, bitwise."""
    if j is None or t is None:
        assert j is None and t is None, what
    elif hasattr(j, "_fields"):
        for f in j._fields:
            _same(getattr(j, f), getattr(t, f), f"{what}.{f}")
    else:
        _bitwise(j, t, what)


def _graphs(kw):
    jc, tc = JCfg(**kw), TCfg(**kw)
    jg = JG.build_sharded_graph(jc)
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    return jc, tc, jg, tg


def _sessions(kw, *, profile=None, plan=None, jprog=None, tprog=None,
              **lat_kw):
    """A JAX session and a port session on one graph, latency model and
    fault plan (pagerank with ``PUSH_EPS``)."""
    jc, tc, jg, tg = _graphs(kw)
    if kw["algorithm"] == "pagerank":
        jprog, tprog = JP.pagerank(push_eps=PUSH_EPS), \
            TP.pagerank(push_eps=PUSH_EPS)
    lat = dict(LATENCY, **lat_kw)
    jl = (JL.make_latency_model(profile, jc.num_shards, **lat)
          if profile else None)
    tl = (TL.make_latency_model(profile, tc.num_shards, **lat)
          if profile else None)
    js = JE.EngineSession(jc, graph=jg, prog=jprog, latency=jl,
                          collect_log=True,
                          fault_plan=JF.FaultPlan(**plan) if plan else None)
    ts = TE.EngineSession(tc, graph=tg, prog=tprog, latency=tl,
                          collect_log=True, device="cpu",
                          fault_plan=TF.FaultPlan(**plan) if plan else None)
    return js, ts


def _inner(session):
    if session.schedule == "async":
        return session._astate
    return session._cstate if session.crowded else session._state


def _lockstep(js, ts, watch=None, max_steps=20_000):
    """Step both sessions to quiescence; the whole inner state (core, ring,
    demotion, clock) is bitwise equal after every step, and so are the
    totals with their per-tick log at the end.  ``watch(ts)`` runs before
    each step."""
    assert (ts.crowded, ts.schedule, ts.max_delay) == \
        (js.crowded, js.schedule, js.max_delay)
    for step in range(max_steps):
        if watch is not None:
            watch(ts)
        js.step()
        ts.step()
        _same(_inner(js), _inner(ts), f"step {step}")
        assert (ts._n_active, ts._pending, ts.quiescent) == \
            (js._n_active, js._pending, js.quiescent), step
        if js.quiescent:
            break
    jt, tt = js.totals_snapshot(), ts.totals_snapshot()
    assert jt["converged"]
    assert jt == tt
    return tt


# ======================================================================
# latency models
# ======================================================================
@pytest.mark.parametrize("profile", ["none", *PROFILES])
@pytest.mark.parametrize("num_shards", [1, 4, 8, 13])
def test_latency_model_matches_jax(profile, num_shards):
    for seed in range(12):
        for kw in (dict(), dict(slow_fraction=0.25, link_delay=5,
                                intensity=9), dict(link_delay=-1,
                                                   intensity=0)):
            j = JL.make_latency_model(profile, num_shards, seed=seed, **kw)
            t = TL.make_latency_model(profile, num_shards, seed=seed, **kw)
            for f in ("delays", "throttle", "slow_mask"):
                _bitwise(getattr(j, f), getattr(t, f), f"{profile}.{f}")
            assert (j.max_delay, j.describe()) == (t.max_delay, t.describe())
    with pytest.raises(ValueError, match="unknown latency profile"):
        TL.make_latency_model("nope", 4)


@pytest.mark.parametrize("name", ["asymp_cc_crowded", "asymp_sssp_crowded",
                                  "asymp_cc_crowded_prod"])
def test_from_config_matches_jax(name):
    j, t = JL.from_config(j_config(name)), TL.from_config(t_config(name))
    for f in ("delays", "throttle", "slow_mask"):
        _bitwise(getattr(j, f), getattr(t, f), f)


# ======================================================================
# the slowdown overlay
# ======================================================================
def test_apply_slowdown_matches_jax():
    """Window edges, a base the overlay must not lower, and the cache: the
    same arrays for every tick of a window, a fresh overlay after a plan
    field changes (``tests/test_crowded.py::TestSlowdownInjection``)."""
    rng = np.random.default_rng(0)
    base_d = rng.integers(0, 3, (8, 8)).astype(np.int32)
    base_t = rng.integers(1, 4, 8).astype(np.int32)
    fields = dict(fail_fraction=0.0, slow_fraction=0.5, slow_delay=2,
                  slow_intensity=3, slow_start=2, slow_stop=9, seed=4)
    jp, tp = JF.FaultPlan(**fields), TF.FaultPlan(**fields)
    for t in range(12):
        jd, jt = JF.apply_slowdown(jp, t, base_d, base_t)
        td, tt = TF.apply_slowdown(tp, t, base_d, base_t)
        _bitwise(jd, td, f"delays {t}")
        _bitwise(jt, tt, f"throttle {t}")
        inside = 2 <= t < 9
        assert (td is base_d) != inside and (tt is base_t) != inside
    assert TF.apply_slowdown(tp, 3, base_d, base_t)[0] is \
        TF.apply_slowdown(tp, 4, base_d, base_t)[0]
    for mutate in (dict(slow_delay=5), dict(slow_intensity=7),
                   dict(slow_fraction=1.0), dict(seed=9)):
        for plan in (jp, tp):
            for k, v in mutate.items():
                setattr(plan, k, v)
        _bitwise(JF.apply_slowdown(jp, 3, base_d, base_t)[0],
                 TF.apply_slowdown(tp, 3, base_d, base_t)[0], str(mutate))
    assert TF.apply_slowdown(None, 3, base_d, base_t)[0] is base_d


# ======================================================================
# the delay ring
# ======================================================================
@pytest.mark.parametrize("mode,kind", [("none", "int32"), ("int16", "int32"),
                                       ("int8", "float32")])
@pytest.mark.parametrize("gated", [False, True])
def test_delayed_exchange_matches_jax(mode, kind, gated):
    """Random sends through a 4-slot ring for 14 ticks under delays that
    change every tick (above the ring's size too, which clamps), with or
    without a receiver gate: the receive buffers (row ``l * P + p`` is
    sender p's slot l), the ring and the count in flight are the JAX
    package's every tick."""
    P, cap, max_delay = 4, 6, 3
    ident = 2 ** 31 - 1 if kind == "int32" else float("inf")
    args = dict(num_shards=P, capacity=cap, vs=50, requested=mode,
                value_kind=kind, identity=ident, max_int_value=60,
                idempotent=True)
    jcodec, tcodec = JX.make_wire_codec(**args), TX.make_wire_codec(**args)
    dtype = np.int32 if kind == "int32" else np.float32
    jring = JX.init_delay_ring(max_delay, P, P, cap, ident, dtype)
    tring = TX.init_delay_ring(max_delay, P, P, cap, ident,
                               {np.int32: torch.int32,
                                np.float32: torch.float32}[dtype])
    _same(jring, tring, "init ring")
    jstep = jax.jit(lambda r, v, i, t, d, g: JX.exchange_local_delayed(
        jcodec, r, v, i, t, d, ident, g if gated else None))
    rng = np.random.default_rng(7)
    for tick in range(14):
        ids = rng.integers(-1, 50, (P, P, cap)).astype(np.int32)
        vals = (rng.integers(0, 60, (P, P, cap)) if kind == "int32"
                else rng.uniform(-5, 5, (P, P, cap))).astype(dtype)
        delays = rng.integers(0, 6, (P, P)).astype(np.int32)
        gate = rng.random(P) < 0.6
        tk = np.asarray(tick, np.int32)
        jrv, jri, jring, jpend = jstep(jring, vals, ids, tk, delays, gate)
        trv, tri, tring, tpend = TX.exchange_local_delayed(
            tcodec, tring, torch.from_numpy(vals), torch.from_numpy(ids),
            torch.from_numpy(tk), torch.from_numpy(delays), ident,
            torch.from_numpy(gate) if gated else None)
        assert trv.shape == (P, (max_delay + 1) * P, cap)
        _bitwise(jrv, trv.contiguous(), f"tick {tick}: recv vals")
        _bitwise(jri, tri.contiguous(), f"tick {tick}: recv ids")
        _same(jring, tring, f"tick {tick}: ring")
        assert int(jpend) == int(tpend) == int(TX.ring_pending(tring))


def test_message_arrives_exactly_delay_ticks_later():
    """One message on link 1 -> 2 with delay 2: empty at ticks 0 and 1,
    delivered at tick 2 in row ``slot * P + sender``, then gone."""
    P, cap = 4, 3
    codec = TX.make_wire_codec(num_shards=P, capacity=cap, vs=10,
                               requested="none", value_kind="int32",
                               identity=99)
    ring = TX.init_delay_ring(2, P, P, cap, 99, torch.int32)
    delays = torch.full((P, P), 2, dtype=torch.int32)
    empty_v = torch.full((P, P, cap), 99, dtype=torch.int32)
    empty_i = torch.full((P, P, cap), -1, dtype=torch.int32)
    sv, si = empty_v.clone(), empty_i.clone()
    sv[1, 2, 0], si[1, 2, 0] = 7, 4
    for tick in range(4):
        rv, ri, ring, pending = TX.exchange_local_delayed(
            codec, ring, sv if tick == 0 else empty_v,
            si if tick == 0 else empty_i, torch.tensor(tick,
                                                      dtype=torch.int32),
            delays, 99)
        got = (ri >= 0).nonzero().tolist()
        if tick == 2:
            assert got == [[2, 0 * P + 1, 0]] and int(rv[2, 1, 0]) == 7
        else:
            assert got == []
        assert int(pending) == (1 if tick < 2 else 0)


# ======================================================================
# straggler demotion and throttle
# ======================================================================
def test_demotion_and_throttle_match_jax():
    """Phase 1 with a throttle and a demotion mask, and the demotion mask
    of a receive over slow rows, against the JAX package's per shard."""
    jc, tc, jg, tg = _graphs(dict(BASE, algorithm="cc", route_capacity=16))
    jp, tp = JP.get_program(jc), TP.get_program(tc)
    jep = dataclasses.replace(JE.default_params(jc, jg, jp),
                              straggler_demote=8)
    tep = dataclasses.replace(TE.default_params(tc, tg, tp),
                              straggler_demote=8)
    rng = np.random.default_rng(3)
    P, vs = jg.num_shards, jg.vs
    js = JE.init_state(jp, jg)
    active = rng.random((P, vs)) < 0.6
    demote = rng.random((P, vs)) < 0.3
    throttle = np.array([1, 4, 2, 9], np.int32)
    jgd = JE.to_device_graph(jg)
    tgd = TE.to_device_graph(tg, device="cpu")
    jout = jax.jit(jax.vmap(lambda v, a, c, r, ci, s, th, d: JE._phase1_create(
        jp, jep, v, a, c, r, ci, None, s, throttle=th, demote=d)))(
        js.values, jnp.asarray(active), js.cursor, jgd.row_ptr, jgd.col_idx,
        jnp.arange(P), jnp.asarray(throttle), jnp.asarray(demote))
    tout = TE._phase1_create(
        tp, tep, torch.from_numpy(np.asarray(js.values)),
        torch.from_numpy(active), torch.from_numpy(np.asarray(js.cursor)),
        tgd.row_ptr, tgd.col_idx, None, throttle=torch.from_numpy(throttle),
        demote=torch.from_numpy(demote))
    for i, what in enumerate(("active", "cursor", "send_vals", "send_ids",
                              "sent", "fetched", "values")):
        j, t = _np(jout[i]), _np(tout[i])
        _bitwise(j, t.astype(j.dtype) if what in ("sent", "fetched") else
                 np.ascontiguousarray(t), what)
    # a throttled shard selects at most M // throttle vertices
    assert int(tout[5][3]) <= max(tep.max_vertices_per_tick // 9, 1) * \
        tep.degree_window
    # the demotion of a receive: improved AND reached over a slow row
    new = rng.integers(0, 5, (P, vs)).astype(np.int32)
    old = rng.integers(0, 5, (P, vs)).astype(np.int32)
    rids = rng.integers(-1, vs, (P, 3 * P, 5)).astype(np.int32)
    delays = rng.integers(0, 2, (P, P)).astype(np.int32)
    jslow = JE._slow_recv_rows(jep, 3 * P, jnp.asarray(delays))
    tslow = TE._slow_recv_rows(tep, 3 * P, torch.from_numpy(delays))
    _bitwise(jslow, tslow.contiguous(), "slow rows")
    jd = jax.vmap(lambda nv, ov, r, s: JE._demote_row(
        jp.aggregator, jep, nv, ov, r, s))(new, old, rids, jslow)
    td = TE._demote_row(tp.aggregator, tep, torch.from_numpy(new),
                        torch.from_numpy(old), torch.from_numpy(rids), tslow)
    _bitwise(jd, td, "demote")
    assert bool(td.any()) and not bool(td.all())


# ======================================================================
# whole crowded sessions, per tick
# ======================================================================
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("algorithm", IDEMPOTENT)
def test_crowded_state_bitwise_every_tick(algorithm, profile):
    kw = dict(BASE, algorithm=algorithm,
              weighted=algorithm in ("sssp", "widest_path"))
    _lockstep(*_sessions(kw, profile=profile))


@pytest.mark.parametrize("profile", PROFILES)
def test_crowded_pagerank_bitwise_every_tick(profile):
    """Push mode under crowding: the residual and latch planes and the
    ring of float mass are the JAX package's every tick."""
    tt = _lockstep(*_sessions(PAGERANK, profile=profile))
    assert tt["pending"] == 0


def test_crowded_config_with_demotion_matches_jax():
    """``asymp_cc_crowded`` reduced: its own stragglers profile,
    straggler_demote=8 and enforcement 1.0."""
    jc = j_config("asymp_cc_crowded").reduced()
    tc = t_config("asymp_cc_crowded").reduced()
    jg = JG.build_sharded_graph(jc)
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    js = JE.EngineSession(jc, graph=jg, collect_log=True)
    ts = TE.EngineSession(tc, graph=tg, collect_log=True, device="cpu")
    demoted = []
    tt = _lockstep(js, ts, watch=lambda s: demoted.append(
        int(s._cstate.demote.sum())))
    assert max(e["pending"] for e in tt["log"]) > 0
    assert max(demoted) > 0


# ======================================================================
# fault compositions
# ======================================================================
def test_slowdown_plan_composes_with_replay():
    """A latency profile, a slowdown window and kills recovered by replay
    in one run (``TestSlowdownInjection::
    test_slowdown_composes_with_midrun_replay``)."""
    kw = dict(BASE, algorithm="cc", num_shards=8, checkpoint_every=3,
              replay_log_ticks=16)
    plan = dict(fail_fraction=0.25, start_tick=5, every=4, seed=2,
                slow_fraction=0.5, slow_delay=3, slow_intensity=4,
                slow_start=2, slow_stop=14)
    tt = _lockstep(*_sessions(kw, profile="stragglers", plan=plan,
                              slow_fraction=0.25, link_delay=2, intensity=2,
                              seed=5))
    assert tt["failures"] >= 1 and tt["replayed"] > 0


@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_replay_covers_messages_in_flight_at_checkpoint(fraction):
    """``asymp_cc_crowded`` reduced under rolling kills: the replay window
    reaches back past each snapshot by the largest link delay."""
    jc = j_config("asymp_cc_crowded").reduced()
    tc = t_config("asymp_cc_crowded").reduced()
    jg = JG.build_sharded_graph(jc)
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    plan = dict(fail_fraction=fraction, start_tick=4, every=6)
    js = JE.EngineSession(jc, graph=jg, collect_log=True,
                          fault_plan=JF.FaultPlan(**plan))
    ts = TE.EngineSession(tc, graph=tg, collect_log=True, device="cpu",
                          fault_plan=TF.FaultPlan(**plan))
    assert ts.fault_mgr.replay_slack == js.fault_mgr.replay_slack == 2
    tt = _lockstep(js, ts)
    assert tt["failures"] >= 2 and tt["replayed"] > 0


def test_checkpoint_restore_snapshots_inflight_ring():
    """Global restore with messages in flight at the snapshot: CC made
    non-self-stabilizing, so kills take the checkpoint restore, which
    rolls back the ring and the device tick with the state.  The ring a
    kill restores is the one the session cut at the snapshot, as it stood
    then, though ticks ran on after it."""
    # kills at steps 5, 9, 13, 17, between the snapshots of 4, 8, 12, 16
    kw = dict(BASE, algorithm="cc", num_shards=8, checkpoint_every=4,
              replay_log_ticks=32)
    jprog = dataclasses.replace(JP.get_program(JCfg(**kw)),
                                self_stabilizing=False)
    tprog = dataclasses.replace(TP.get_program(TCfg(**kw)),
                                self_stabilizing=False)
    plan = dict(fail_fraction=0.5, start_tick=5, every=4, seed=1)
    js, ts = _sessions(kw, profile="stragglers", plan=plan, jprog=jprog,
                       tprog=tprog, link_delay=3, intensity=2, seed=4)
    restored_in_flight = []
    for step in range(20_000):
        cut = (None if ts._ring_ckpt is None else (
            TX.DelayRing(*(x.clone() for x in ts._ring_ckpt[0])),
            ts._ring_ckpt[1].clone(), ts._ring_ckpt[2].clone()))
        failures = ts.totals["failures"]
        js.step()
        ts.step()
        _same(_inner(js), _inner(ts), f"step {step}")
        if ts.totals["failures"] > failures:
            ring, _, tick = cut
            _same(ring, ts._cstate.ring, f"step {step}: restored ring")
            _bitwise(tick, ts._cstate.core.tick, f"step {step}: tick")
            restored_in_flight.append(int(TX.ring_pending(ring)))
        if js.quiescent:
            break
    jt, tt = js.totals_snapshot(), ts.totals_snapshot()
    assert jt == tt and tt["converged"] and tt["pending"] == 0
    assert tt["failures"] >= 1 and tt["replayed"] == 0
    assert max(restored_in_flight) > 0  # messages were in flight
    out = ts.state.values.reshape(-1)[: ts.graph.num_real_vertices]
    assert np.array_equal(out.numpy(), TG.cc_oracle(
        ts.graph.num_real_vertices, TG.edge_list(ts.graph)))


def test_checkpoint_restore_pagerank_with_ring():
    """Pagerank's own checkpoint restore under crowding: state, aux planes
    and ring every tick as in the JAX package; mass conserved."""
    from repro_torch.core import merger as TM
    plan = dict(fail_fraction=0.5, start_tick=4, every=5)
    kw = dict(PAGERANK, checkpoint_every=3)
    js, ts = _sessions(kw, profile="stragglers", plan=plan, link_delay=2,
                       intensity=2)
    tt = _lockstep(js, ts)
    assert tt["failures"] == 2 and tt["replayed"] == 0
    assert abs(TM.mass_balance(ts.state, ts.graph) - 1.0) < 1e-5


def test_restore_before_any_snapshot_reinitializes_ring():
    """A restore with no snapshot re-initializes the run: empty ring,
    device tick 0 (the snapshots of step 0 are dropped in both sessions
    to reach that branch)."""
    kw = dict(PAGERANK, checkpoint_every=1000)
    plan = dict(fail_fraction=0.25, start_tick=2, every=5)
    js, ts = _sessions(kw, profile="uniform", plan=plan, link_delay=2)
    for step in range(3):
        js.step()
        ts.step()
        if step == 0:
            for s in (js, ts):
                s._ring_ckpt = None
                s.fault_mgr.ckpt.clear()
    assert ts.totals["failures"] == 1
    assert int(ts._cstate.core.tick) == 0
    assert int(TX.ring_pending(ts._cstate.ring)) == 0
    _same(_inner(js), _inner(ts), "after the re-init")
    _lockstep(js, ts)
