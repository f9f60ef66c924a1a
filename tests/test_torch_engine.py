"""Port parity: semirings, programs, the wire gate and the engine tick.

The same seeded graph and configs go through the JAX package (``repro``,
on the CPU) and the port (``repro_torch``, ``device="cpu"``).  The engine
state, the send buffers and the tick counters must be bitwise equal after
every tick, to convergence, for the six idempotent programs.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once, and
# each worker's own thread pool over all cores oversubscribes them
torch.set_num_threads(1)

from repro.configs import asymp_graphs as j_cfgs  # noqa: E402
from repro.configs.base import GraphConfig as JCfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import programs as JP  # noqa: E402
from repro.core import semiring as JSR  # noqa: E402
from repro.dist import exchange as JX  # noqa: E402
from repro_torch.configs import asymp_graphs as t_cfgs  # noqa: E402
from repro_torch.configs.base import GraphConfig as TCfg  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import merger as TM  # noqa: E402
from repro_torch.core import programs as TP  # noqa: E402
from repro_torch.core import semiring as TSR  # noqa: E402
from repro_torch.dist import exchange as TX  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PROGRAMS = ["cc", "sssp", "bfs", "reachability", "widest_path", "labelprop"]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _bitwise(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


# ======================================================================
# priority bucketing
# ======================================================================
def _pv_sweep(scale, seed=0):
    rng = np.random.default_rng(seed)
    top = int(min(scale, 1 << 18))
    return np.concatenate([
        np.arange(0, top + 2, dtype=np.float32),
        rng.uniform(0, scale, 200_000).astype(np.float32),
        (scale * rng.uniform(0, 1, 200_000) ** 12).astype(np.float32),
        np.array([np.inf, -np.inf, -1.0, 2 ** 31 - 1, scale, scale / 2, 0.0],
                 np.float32)])


@pytest.mark.parametrize("strategy", ["log", "linear", "disabled"])
@pytest.mark.parametrize("scale", [1.0, 256.0, 1000.0, 1024.0, 4096.0,
                                   12345.0, 262144.0])
def test_priority_buckets_bitwise(strategy, scale):
    pv = _pv_sweep(scale)
    j = jax.jit(lambda p: JE.priority_buckets(p, strategy, scale))(
        jnp.asarray(pv))
    _bitwise(j, TE.priority_buckets(torch.from_numpy(pv), strategy, scale),
             f"{strategy}@{scale}")


def test_log_bucket_edges_rederived():
    """Bisect, over float32 bit patterns, the smallest x the reference
    puts in each log bucket: the port's edge table must be exactly that."""
    fn = jax.jit(lambda pv: JE.priority_buckets(pv, "log", 1.0))
    k = np.arange(1, JE.N_BUCKETS)
    lo = np.zeros(len(k), np.int64)
    hi = np.full(len(k), np.float32(1.0).view(np.int32), np.int64)
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        b = np.asarray(fn(jnp.asarray(mid.astype(np.int32).view(np.float32))))
        up = b >= k
        hi, lo = np.where(up, mid, hi), np.where(up, lo, mid)
    assert tuple(int(v) for v in hi) == TE._LOG_BUCKET_EDGES


# ======================================================================
# semirings, programs, wire gate
# ======================================================================
@pytest.mark.parametrize("name", ["min", "max", "or", "sum"])
def test_aggregator_parity(name):
    ja, ta = JSR.AGGREGATORS[name], TSR.AGGREGATORS[name]
    assert (ja.quantize_direction, ja.idempotent) == \
        (ta.quantize_direction, ta.idempotent)
    rng = np.random.default_rng(1)
    for dtype in ("int32", "float32"):
        assert ja.identity(dtype) == ta.identity(dtype)
        npdt = np.dtype(dtype)
        base = (rng.integers(-5, 50, (3, 16)) if dtype == "int32"
                else rng.uniform(-5, 50, (3, 16))).astype(npdt)
        vals = (rng.integers(-5, 50, (3, 40)) if dtype == "int32"
                else rng.uniform(-5, 50, (3, 40))).astype(npdt)
        idx = rng.integers(0, 20, (3, 40)).astype(np.int32)  # >= 16 drops
        j = jax.vmap(ja.scatter)(jnp.asarray(base), jnp.asarray(idx),
                                 jnp.asarray(vals))
        t = ta.scatter(torch.from_numpy(base), torch.from_numpy(idx),
                       torch.from_numpy(vals))
        if name == "sum" and dtype == "float32":
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6)
        else:
            _bitwise(j, t, f"{name} scatter {dtype}")
        seg = rng.integers(0, 12, 40).astype(np.int32)  # segments 12..14 empty
        j = ja.segment_reduce(jnp.asarray(vals[0]), jnp.asarray(seg),
                              num_segments=15)
        t = ta.segment_reduce(torch.from_numpy(vals[0]),
                              torch.from_numpy(seg), 15)
        if name == "sum" and dtype == "float32":
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6)
        else:
            _bitwise(j, t, f"{name} segment_reduce {dtype}")
        a, b = base[0], base[1]
        _bitwise(ja.improves(jnp.asarray(a), jnp.asarray(b)),
                 ta.improves(torch.from_numpy(a), torch.from_numpy(b)),
                 "improves")
        _bitwise(ja.tie(jnp.asarray(a), jnp.asarray(b)),
                 ta.tie(torch.from_numpy(a), torch.from_numpy(b)), "tie")
        jr = ja.reduce(jnp.asarray(base), axis=1)
        tr = ta.reduce(torch.from_numpy(base), dim=1)
        if name == "sum" and dtype == "float32":  # summation order
            np.testing.assert_allclose(_np(tr), _np(jr), rtol=1e-6)
        else:
            _bitwise(jr, tr, "reduce")
    pv = rng.uniform(0, 100, 64).astype(np.float32)
    _bitwise(ja.priority_key(jnp.asarray(pv), 100.0),
             ta.priority_key(torch.from_numpy(pv), 100.0), "priority_key")
    assert JSR.SEMIRING_AGGREGATOR == TSR.SEMIRING_AGGREGATOR
    for s in JSR.SEMIRING_AGGREGATOR:
        assert JSR.for_semiring(s).name == TSR.for_semiring(s).name


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_parity(name):
    jp, tp = JP.get_program(name, source=3) if name not in (
        "cc", "labelprop") else JP.get_program(name), \
        TP.get_program(name, source=3) if name not in (
            "cc", "labelprop") else TP.get_program(name)
    assert (jp.name, jp.dtype, jp.aggregator.name, jp.weighted,
            jp.self_stabilizing, jp.priority_scale, jp.identity,
            jp.wire_bound(1000)) == \
        (tp.name, tp.dtype, tp.aggregator.name, tp.weighted,
         tp.self_stabilizing, tp.priority_scale, tp.identity,
         tp.wire_bound(1000))
    gids = np.arange(32, dtype=np.int32).reshape(4, 8)
    valid = gids < 29
    jv, ja = jp.init(jnp.asarray(gids), jnp.asarray(valid))
    tv, ta = tp.init(torch.from_numpy(gids), torch.from_numpy(valid))
    _bitwise(jv, tv, "init values")
    _bitwise(ja, ta, "init active")
    rng = np.random.default_rng(2)
    src = (rng.integers(0, 100, (4, 6, 1)).astype(np.int32)
           if jp.dtype == "int32"
           else rng.uniform(0, 5, (4, 6, 1)).astype(np.float32))
    w = rng.uniform(0.1, 1.0, (4, 6, 3)).astype(np.float32)
    for weights in (None, w):
        j = jp.combine(jnp.asarray(src),
                       jnp.asarray(weights) if weights is not None else None)
        t = tp.combine(torch.from_numpy(src), torch.from_numpy(weights)
                       if weights is not None else None)
        _bitwise(j, t, "combine")
    _bitwise(jp.priority_value(jv), tp.priority_value(tv), "priority_value")


def test_program_registry():
    assert set(TP.PROGRAMS) == set(JP.PROGRAMS)
    assert TP.get_program("pagerank", damping=0.9).aux_channels == 2
    with pytest.raises(ValueError, match="registered"):
        TP.get_program("nope")
    with pytest.raises(TypeError):
        TP.get_program("cc", source=1)
    cfg = TCfg(name="x", algorithm="bfs", num_vertices=8, avg_degree=2,
               source=5)
    assert TP.get_program(cfg).init(torch.arange(8, dtype=torch.int32),
                                    torch.ones(8, dtype=torch.bool)
                                    )[0][5] == 0
    TP.register_program("cc_alias", TP.connected_components)
    try:
        assert TP.get_program("cc_alias").name == "cc"
    finally:
        del TP.PROGRAMS["cc_alias"]


@pytest.mark.parametrize("requested", [None, "", "none", "int16", "int8"])
@pytest.mark.parametrize("kind,bound", [("int32", 100), ("int32", 1000),
                                        ("int32", 40000), ("float32", 0)])
@pytest.mark.parametrize("idempotent", [True, False])
def test_effective_compression_parity(requested, kind, bound, idempotent):
    assert JX.effective_compression(requested, kind, bound, idempotent) == \
        TX.effective_compression(requested, kind, bound, idempotent)


def test_wire_codec_and_exchange_parity():
    with pytest.raises(ValueError, match="valid modes"):
        TX.effective_compression("int4", "int32")
    for mode in ("none", "int16", "int8"):
        args = dict(num_shards=4, capacity=16, vs=100, requested=mode,
                    value_kind="int32", identity=2 ** 31 - 1,
                    max_int_value=50, idempotent=True)
        jc, tc = JX.make_wire_codec(**args), TX.make_wire_codec(**args)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        # every mode encodes now (tests/test_torch_wire.py holds the bits)
        labels = np.arange(64, dtype=np.int32).reshape(4, 16)
        enc, scales = tc.encode(torch.from_numpy(labels))
        assert scales is None and enc.dtype == {
            "none": torch.int32, "int16": torch.int16,
            "int8": torch.int8}[mode]
        _bitwise(jc.decode(*jc.encode(jnp.asarray(labels))),
                 tc.decode(enc, scales), f"{mode} round trip")
    rng = np.random.default_rng(3)
    sv = rng.integers(0, 100, (4, 4, 16)).astype(np.int32)
    si = rng.integers(-1, 100, (4, 4, 16)).astype(np.int32)
    codec_args = dict(num_shards=4, capacity=16, vs=100, requested="none",
                      value_kind="int32", identity=0)
    jv, ji = JX.exchange_local(JX.make_wire_codec(**codec_args),
                               jnp.asarray(sv), jnp.asarray(si))
    tv, ti = TX.exchange_local(TX.make_wire_codec(**codec_args),
                               torch.from_numpy(sv), torch.from_numpy(si))
    _bitwise(jv, tv.contiguous(), "exchanged values")
    _bitwise(ji, ti.contiguous(), "exchanged ids")


def _params_match(jep, tep):
    """The port's EngineParams equal the JAX package's, field for field
    (the crowded tick's bucket penalty ``straggler_demote`` included)."""
    assert dataclasses.asdict(jep) == dataclasses.asdict(tep)


@pytest.mark.parametrize("name", sorted(j_cfgs.CONFIGS))
def test_derive_params_parity(name):
    jc, tc = j_cfgs.CONFIGS[name], t_cfgs.CONFIGS[name]
    jp, tp = JP.get_program(jc), TP.get_program(tc)
    sizes = dict(num_shards=jc.num_shards, vs=2048, es=9000,
                 num_vertices=jc.num_shards * 2048)
    _params_match(JE.derive_params(jc, prog=jp, **sizes),
                  TE.derive_params(tc, prog=tp, **sizes))


# ======================================================================
# the engine tick, per tick, to convergence
# ======================================================================
def _pair(cfg_kw):
    jc, tc = JCfg(**cfg_kw), TCfg(**cfg_kw)
    jg = JG.build_sharded_graph(jc)
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    return jc, tc, jg, tg


def _engines(jc, tc, jg, tg):
    jp, tp = JP.get_program(jc), TP.get_program(tc)
    jep, tep = JE.default_params(jc, jg, jp), TE.default_params(tc, tg, tp)
    _params_match(jep, tep)
    return (JE.make_local_tick(jp, jep, jp.weighted), JE.to_device_graph(jg),
            TE.make_local_tick(tp, tep, tp.weighted),
            TE.to_device_graph(tg, device="cpu"), jp, tp)


def _tick_both(jtick, jgd, ttick, tgd, js, ts, max_ticks=5000):
    """Tick both engines from (js, ts) to quiescence, comparing state,
    send buffers and counters bitwise after every tick."""
    for t in range(max_ticks):
        js, jstats, (jsv, jsi) = jtick(js, jgd)
        ts, tstats, (tsv, tsi) = ttick(ts, tgd)
        for f in ("values", "active", "cursor", "tick"):
            _bitwise(getattr(js, f), getattr(ts, f), f"tick {t}: {f}")
        _bitwise(jsv, tsv.contiguous(), f"tick {t}: send_vals")
        _bitwise(jsi, tsi.contiguous(), f"tick {t}: send_ids")
        for f in TE.TickStats._fields:
            assert int(getattr(jstats, f)) == int(getattr(tstats, f)), \
                f"tick {t}: {f}"
        if int(jstats.active) == 0:
            return t + 1, js, ts
    raise AssertionError("no convergence")


BASE = dict(name="t", num_vertices=1024, avg_degree=8, generator="rmat",
            num_shards=4, priority="log", enforce_fraction=0.5)


@pytest.mark.parametrize("cfg_kw", [
    *[dict(BASE, algorithm=a, weighted=a in ("sssp", "widest_path"),
           source=5) for a in PROGRAMS],
    # starved route capacity: drops, cursor retry next tick
    dict(BASE, algorithm="cc", route_capacity=8),
    dict(BASE, algorithm="sssp", weighted=True, route_capacity=8,
         edge_budget=256),
    dict(BASE, algorithm="labelprop", priority="linear",
         enforce_fraction=0.1),
    dict(BASE, algorithm="cc", priority="disabled", num_shards=3,
         num_vertices=1000),
], ids=lambda kw: "-".join(str(kw[k]) for k in (
    "algorithm", "priority", "num_shards")) + (
    f"-cap{kw['route_capacity']}" if "route_capacity" in kw else ""))
def test_tick_bitwise_to_convergence(cfg_kw):
    jc, tc, jg, tg = _pair(cfg_kw)
    jtick, jgd, ttick, tgd, jp, tp = _engines(jc, tc, jg, tg)
    js, ts = JE.init_state(jp, jg), TE.init_state(tp, tg, device="cpu")
    for f in ("values", "active", "cursor", "tick"):
        _bitwise(getattr(js, f), getattr(ts, f), f"init {f}")
    ticks, js, ts = _tick_both(jtick, jgd, ttick, tgd, js, ts)
    assert ticks > 1
    assert np.array_equal(np.asarray(jp.output(js.values)).reshape(-1)[
        : jg.num_real_vertices], TM.extract(ts, tg, tp))


def test_state_handover_mid_run():
    """A JAX state after k ticks, handed over as numpy, ticks on the same."""
    jc, tc, jg, tg = _pair(dict(BASE, algorithm="sssp", weighted=True,
                                route_capacity=16))
    jtick, jgd, ttick, tgd, jp, tp = _engines(jc, tc, jg, tg)
    js = JE.init_state(jp, jg)
    for _ in range(6):
        js, _, _ = jtick(js, jgd)
    ts = TE.state_from_numpy(np.asarray(js.values), np.asarray(js.active),
                             np.asarray(js.cursor), np.asarray(js.tick),
                             device="cpu")
    assert int(ts.tick) == 6 and ts.values.dtype == torch.float32
    _tick_both(jtick, jgd, ttick, tgd, js, ts)


def test_session_totals_match_jax(rmat_cc_graph):
    cfg_j, jg = rmat_cc_graph
    tc = TCfg(**dataclasses.asdict(cfg_j))
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    jstate, jtot = JE.run_to_convergence(cfg_j, graph=jg, collect_log=True)
    tstate, ttot = TE.run_to_convergence(tc, graph=tg, collect_log=True,
                                         device="cpu")
    for k in ("ticks", "sent", "accepted", "fetched", "replayed", "failures",
              "pending", "schedule", "converged", "log"):
        assert jtot[k] == ttot[k], k
    _bitwise(jstate.values, tstate.values, "final values")
    # a quiescent session returns at once
    s = TE.EngineSession(tc, graph=tg, device="cpu")
    s.tick_until_quiescent()
    assert s.tick_until_quiescent()["ticks"] == jtot["ticks"]


def test_bench_speed_smoke_counts():
    """The `bench_speed --smoke` configs give the committed baseline's
    tick and message counts, at the oracles' fixpoints."""
    base = json.loads((REPO / "benchmarks" / "baselines" /
                       "BENCH_speed.json").read_text())
    want = {r["name"]: r["metrics"] for r in base["rows"]}
    cfg = TCfg(name="smoke", algorithm="cc", num_vertices=1 << 12,
               avg_degree=16, generator="rmat", num_shards=8,
               priority="log", enforce_fraction=0.1)
    g = TG.build_sharded_graph(cfg)
    comp = TG.cc_oracle(g.num_real_vertices, TG.edge_list(g))
    expect = {"cc": comp,
              "labelprop": TG.labelprop_oracle(g.num_real_vertices,
                                               comp=comp)}
    for alg in ("cc", "labelprop"):
        c = dataclasses.replace(cfg, algorithm=alg)
        state, tot = TE.run_to_convergence(c, graph=g, device="cpu")
        assert tot["converged"]
        assert {"ticks": tot["ticks"], "messages": tot["sent"]} == \
            want[f"smoke/{alg}"]
        assert np.array_equal(TM.extract(state, g, TP.get_program(c)),
                              expect[alg])


@pytest.mark.parametrize("kw,match", [
    # a plan's slowdowns and a latency model route onto the crowded tick;
    # schedule="async" onto the async tick (``match``: what the refusal
    # named while the option was unported)
    (dict(fault_plan=TF.FaultPlan(0.5, slow_fraction=0.5, slow_delay=2)),
     "fault injection"),
    (dict(latency="stragglers"), "crowded"),
    (dict(schedule="async"), "async"),
])
def test_session_refuses_unported(rmat_cc_graph, kw, match):
    """Nothing of these is refused any more (the test keeps the name it
    had while each was): each option builds the session path the JAX
    package's session builds (async for ``schedule="async"``, else
    crowded), and a crowded config runs to the JAX package's totals."""
    from repro.core import faults as JF
    from repro.dist import latency as JL
    from repro_torch.dist import latency as TL
    cfg_j, jg = rmat_cc_graph
    tc = TCfg(**dataclasses.asdict(cfg_j))
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    jkw = dict(kw)
    if "fault_plan" in kw:
        jkw["fault_plan"] = JF.FaultPlan(0.5, slow_fraction=0.5, slow_delay=2)
    if "latency" in kw:
        jkw["latency"] = JL.make_latency_model(kw["latency"], 4)
        kw = dict(latency=TL.make_latency_model(kw["latency"], 4))
    t = TE.EngineSession(tc, graph=tg, device="cpu", **kw)
    j = JE.EngineSession(cfg_j, graph=jg, **jkw)
    assert (t.crowded, t.schedule, t.max_delay) == \
        (j.crowded, j.schedule, j.max_delay)
    assert (match == "async") == (t.schedule == "async") != t.crowded
    crowded = dataclasses.replace(tc, latency_profile="stragglers")
    _, tt = TE.run_to_convergence(crowded, graph=tg, device="cpu")
    _, jt = JE.run_to_convergence(dataclasses.replace(
        cfg_j, latency_profile="stragglers"), graph=jg)
    assert tt.pop("edges") == tg.num_edges  # the port's own key
    assert tt == jt and tt["converged"] and tt["pending"] == 0
