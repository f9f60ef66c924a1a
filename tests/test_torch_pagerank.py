"""Port parity: push-mode ``pagerank`` (the SUM aggregator, the aux planes).

The same seeded graph goes through the JAX package (``repro``, on the
CPU) and the port (``repro_torch``, ``device="cpu"``).  On the CPU the
port's pagerank state — values, frontier, cursors, residual and push
latch — is bitwise the JAX package's after every tick, for uniform,
personalized (``restart``) and weighted pagerank; the per-tick mass
invariant holds under starved route capacity; and the fixpoint passes
``tests/test_pagerank.py``'s verdict against the JAX dense oracle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

from repro.configs.base import GraphConfig as JCfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import programs as JP  # noqa: E402
from repro.kernels.ops import pagerank as j_dense_pagerank  # noqa: E402
from repro_torch.configs.base import GraphConfig as TCfg  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import merger as TM  # noqa: E402
from repro_torch.core import programs as TP  # noqa: E402
from repro_torch.core import semiring as TSR  # noqa: E402

DAMPING = 0.85
PUSH_EPS = 1e-5
BASE = dict(name="t-pr", algorithm="pagerank", num_vertices=512,
            avg_degree=5, generator="rmat", num_shards=4,
            enforce_fraction=0.5, checkpoint_every=4)
# program variants: name -> (get_program kwargs, weighted graph)
VARIANTS = {"uniform": ({}, False), "restart": ({"restart": 5}, False),
            "weighted": ({"weighted": True}, True)}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _bitwise(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _to_port(jg):
    return TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)


@pytest.fixture(scope="module")
def setup():
    jc, tc = JCfg(**BASE), TCfg(**BASE)
    jg = JG.build_sharded_graph(jc)
    oracle = np.asarray(j_dense_pagerank(jg, damping=DAMPING, iters=80,
                                         use_kernel=False, dangling="absorb"))
    return jc, tc, jg, _to_port(jg), oracle


def _verdict(state, totals, g, oracle):
    """``tests/test_pagerank.py::_verdict`` on the port's state: oracle
    match, conservation, no latched push, residuals drained."""
    assert totals["converged"]
    n = g.num_real_vertices
    out = TM.extract(state, g, TP.pagerank())
    l1 = float(np.abs(out.astype(np.float64) / n - oracle).sum())
    assert l1 < 1e-3, f"L1 to oracle {l1:.2e}"
    assert abs(TM.mass_balance(state, g) - 1.0) < 1e-5
    assert bool((state.aux[:, 1] == 0).all())
    assert bool((state.aux[:, 0].reshape(-1)[:n] <= PUSH_EPS).all())
    return out


# ======================================================================
# priority buckets: float32 thresholds on |pending mass|
# ======================================================================
def _jax_buckets(strategy):
    prog = JP.pagerank()
    return jax.jit(lambda m: JE.priority_buckets(
        prog.aggregator.priority_key(prog.priority_value(m), 24.0),
        strategy, 24.0))


@pytest.mark.parametrize("strategy", ["log", "linear"])
def test_bucket_edges_rederived(strategy):
    """Bisect, over float32 bit patterns, the largest |pending| the
    reference puts in each bucket >= k: the port's table is exactly
    that."""
    fn = _jax_buckets(strategy)
    assert int(fn(jnp.float32(0.0))) == 31 and int(fn(jnp.float32(np.inf))) == 0
    k = np.arange(1, 32)
    lo = np.zeros(31, np.int64)
    hi = np.full(31, np.float32(np.inf).view(np.int32), np.int64)
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        b = np.asarray(fn(jnp.asarray(mid.astype(np.int32).view(np.float32))))
        ok = b >= k
        lo, hi = np.where(ok, mid, lo), np.where(ok, hi, mid)
    assert tuple(int(v) for v in lo) == \
        TP._PAGERANK_BUCKET_EDGES[strategy]


@pytest.mark.parametrize("strategy", ["log", "linear", "disabled"])
def test_bucketize_matches_jax(strategy):
    """A sweep over magnitudes, every threshold's neighbourhood and the
    special values: the port's buckets equal the reference's."""
    rng = np.random.default_rng(0)
    edges = np.array(TP._PAGERANK_BUCKET_EDGES.get(strategy, (1,)),
                     np.int32)
    near = (edges[:, None] + np.arange(-3, 4)[None, :]).reshape(-1)
    m = np.concatenate([
        (10.0 ** rng.uniform(-12, 1, 200_000)).astype(np.float32),
        near.view(np.float32),
        np.array([0.0, -0.0, 2.0 ** -24, 2.0 ** -25, 1.0, 2.0, np.inf,
                  1e-5, 1e-5 * (1 + 1e-7)], np.float32)])
    m = np.concatenate([m, -m])  # signed correction mass buckets on |m|
    j = _jax_buckets(strategy)(jnp.asarray(m))
    prog = TP.pagerank()
    _bitwise(j, prog.bucketize(torch.from_numpy(m), strategy, 24.0),
             strategy)
    with pytest.raises(ValueError, match="scale"):
        prog.bucketize(torch.from_numpy(m), "log", 1000.0)


# ======================================================================
# program, registry, weights, merger
# ======================================================================
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_program_parity(variant):
    kw, _ = VARIANTS[variant]
    jp, tp = JP.get_program("pagerank", **kw), TP.get_program("pagerank", **kw)
    fields = ("name", "dtype", "weighted", "self_stabilizing",
              "priority_scale", "aux_channels", "push_eps", "identity")
    assert [getattr(jp, f) for f in fields] == [getattr(tp, f) for f in fields]
    assert jp.aggregator.name == tp.aggregator.name == "sum"
    gids = np.arange(32, dtype=np.int32).reshape(4, 8)
    valid = gids < 29
    for name in ("init", "init_aux"):
        j = getattr(jp, name)(jnp.asarray(gids), jnp.asarray(valid))
        t = getattr(tp, name)(torch.from_numpy(gids), torch.from_numpy(valid))
        for a, b in zip(j if isinstance(j, tuple) else (j,),
                        t if isinstance(t, tuple) else (t,)):
            _bitwise(a, b, name)
    rng = np.random.default_rng(2)
    mass = rng.uniform(0, 1, (4, 6, 1)).astype(np.float32)
    deg = rng.integers(0, 9, (4, 6, 1)).astype(np.int32)
    w = rng.uniform(0.01, 1.0, (4, 6, 3)).astype(np.float32)
    _bitwise(jp.combine(jnp.asarray(mass), jnp.asarray(w), jnp.asarray(deg)),
             tp.combine(torch.from_numpy(mass), torch.from_numpy(w),
                        torch.from_numpy(deg)), "combine")
    # the raw metric is -log2 in both; the engine buckets through the
    # thresholds, so only closeness is asked of torch.log2
    pend = rng.uniform(1e-9, 1.0, 1000).astype(np.float32)
    np.testing.assert_allclose(
        _np(tp.priority_value(torch.from_numpy(pend))),
        np.asarray(jp.priority_value(jnp.asarray(pend))), rtol=1e-6)


def test_get_program_passes_damping():
    for kw in (dict(BASE), dict(BASE, damping=0.9)):
        jp, tp = JP.get_program(JCfg(**kw)), TP.get_program(TCfg(**kw))
        gids = np.arange(8, dtype=np.int32)
        valid = np.ones(8, bool)
        _bitwise(jp.init_aux(jnp.asarray(gids), jnp.asarray(valid)),
                 tp.init_aux(torch.from_numpy(gids), torch.from_numpy(valid)),
                 "init_aux")
        mass = np.full((2, 1), 0.5, np.float32)
        deg = np.array([[3], [0]], np.int32)
        _bitwise(jp.combine(jnp.asarray(mass), None, jnp.asarray(deg)),
                 tp.combine(torch.from_numpy(mass), None,
                            torch.from_numpy(deg)), "combine")


@pytest.mark.parametrize("weighted", [True, False])
def test_normalize_weights_byte_identical(weighted):
    cfg = dict(BASE, num_vertices=1000, num_shards=3, weighted=weighted)
    jg = JG.build_sharded_graph(JCfg(**cfg))
    jn = JG.normalize_weights(jg)
    tn = TG.normalize_weights(_to_port(jg))
    _bitwise(jn.weights, tn.weights, "normalized weights")
    assert tn.weights.dtype == np.float32


# ======================================================================
# the push-mode tick, per tick, to convergence
# ======================================================================
def _variant_engines(variant, **cfg_over):
    kw, weighted_graph = VARIANTS[variant]
    jc, tc = JCfg(**dict(BASE, **cfg_over)), TCfg(**dict(BASE, **cfg_over))
    jg = JG.build_sharded_graph(dataclasses.replace(jc,
                                                    weighted=weighted_graph))
    if weighted_graph:
        jg = JG.normalize_weights(jg)
    tg = _to_port(jg)
    jp, tp = JP.get_program("pagerank", **kw), TP.get_program("pagerank", **kw)
    jep, tep = JE.default_params(jc, jg, jp), TE.default_params(tc, tg, tp)
    assert dataclasses.asdict(jep) == dataclasses.asdict(tep)
    return (jc, tc, jg, tg, jp, tp, jep, tep)


def _tick_both(jtick, jgd, ttick, tgd, js, ts, max_ticks):
    """Tick both engines, comparing state (aux included), send buffers and
    counters bitwise after every tick, until quiescence."""
    for t in range(max_ticks):
        js, jstats, (jsv, jsi) = jtick(js, jgd)
        ts, tstats, (tsv, tsi) = ttick(ts, tgd)
        for f in ("values", "active", "cursor", "tick", "aux"):
            _bitwise(getattr(js, f), getattr(ts, f), f"tick {t}: {f}")
        _bitwise(jsv, tsv.contiguous(), f"tick {t}: send_vals")
        _bitwise(jsi, tsi.contiguous(), f"tick {t}: send_ids")
        for f in TE.TickStats._fields:
            assert int(getattr(jstats, f)) == int(getattr(tstats, f)), \
                f"tick {t}: {f}"
        if int(jstats.active) == 0:
            return t + 1, js, ts
    return max_ticks, js, ts


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tick_bitwise_to_convergence(variant, setup):
    jc, tc, jg, tg, jp, tp, jep, tep = _variant_engines(variant)
    jtick = JE.make_local_tick(jp, jep, jp.weighted)
    ttick = TE.make_local_tick(tp, tep, tp.weighted)
    js, ts = JE.init_state(jp, jg), TE.init_state(tp, tg, device="cpu")
    for f in ("values", "active", "cursor", "tick", "aux"):
        _bitwise(getattr(js, f), getattr(ts, f), f"init {f}")
    ticks, js, ts = _tick_both(jtick, JE.to_device_graph(jg), ttick,
                               TE.to_device_graph(tg, device="cpu"), js, ts,
                               max_ticks=20000)
    assert ticks > 100 and int(ts.active.sum()) == 0
    # personalized and weighted runs change the fixpoint, not the checks
    # of conservation and quiescence; a restart run seeds 1-d at one
    # vertex instead of at each of the n
    seeded = tg.num_real_vertices if variant == "restart" else 1
    assert abs(TM.mass_balance(ts, tg) * seeded - 1.0) < 1e-5
    assert bool((ts.aux[:, 1] == 0).all())
    if variant == "uniform":
        _verdict(ts, {"converged": True}, tg, setup[4])


def test_mass_invariant_every_tick_with_starved_capacity(setup):
    """route_capacity=4 forces routing drops every tick; the exactly-once
    prefix and the latch keep the mass invariant at every tick boundary
    (a double-shipped or lost message moves it by ~0.9 in 60 ticks), and
    the state stays bitwise the JAX package's."""
    jc, tc, jg, tg, _ = setup
    jc, tc = (dataclasses.replace(c, enforce_fraction=1.0) for c in (jc, tc))
    jp, tp = JP.get_program(jc), TP.get_program(tc)
    jep = dataclasses.replace(JE.default_params(jc, jg, jp), route_capacity=4)
    tep = dataclasses.replace(TE.default_params(tc, tg, tp), route_capacity=4)
    jtick = JE.make_local_tick(jp, jep, False)
    ttick = TE.make_local_tick(tp, tep, False)
    jgd, tgd = JE.to_device_graph(jg), TE.to_device_graph(tg, device="cpu")
    js, ts = JE.init_state(jp, jg), TE.init_state(tp, tg, device="cpu")
    sent = fetched = 0
    for t in range(120):
        js, _, _ = jtick(js, jgd)
        ts, stats, _ = ttick(ts, tgd)
        sent += int(stats.sent)
        fetched += int(stats.fetched)
        assert abs(TM.mass_balance(ts, tg) - 1.0) < 1e-5, f"tick {t}"
    assert fetched > sent  # drops really happened (edges re-fetched)
    for f in ("values", "active", "cursor", "aux"):
        _bitwise(getattr(js, f), getattr(ts, f), f)


def test_session_verdict_and_totals_match_jax(setup):
    jc, tc, jg, tg, oracle = setup
    jstate, jtot = JE.run_to_convergence(jc, graph=jg)
    tstate, ttot = TE.run_to_convergence(tc, graph=tg, device="cpu")
    for k in ("ticks", "sent", "accepted", "fetched", "replayed", "failures",
              "converged"):
        assert jtot[k] == ttot[k], k
    _bitwise(jstate.aux, tstate.aux, "final aux")
    out = _verdict(tstate, ttot, tg, oracle)
    _bitwise(np.asarray(jstate.values).reshape(-1)[: tg.num_real_vertices],
             out, "final ranks")


def test_state_handover_mid_run(setup):
    """A JAX pagerank state after k ticks, aux planes included, handed
    over as numpy, ticks on bitwise the same."""
    jc, tc, jg, tg, _ = setup
    jp, tp = JP.get_program(jc), TP.get_program(tc)
    jtick = JE.make_local_tick(jp, JE.default_params(jc, jg, jp), False)
    ttick = TE.make_local_tick(tp, TE.default_params(tc, tg, tp), False)
    jgd = JE.to_device_graph(jg)
    js = JE.init_state(jp, jg)
    for _ in range(40):
        js, _, _ = jtick(js, jgd)
    ts = TE.state_from_numpy(*(np.asarray(x) for x in js), device="cpu")
    assert ts.aux.shape == (4, 2, tg.vs) and int(ts.tick) == 40
    _tick_both(jtick, jgd, ttick, TE.to_device_graph(tg, device="cpu"), js,
               ts, max_ticks=200)


# ======================================================================
# the SUM aggregator (tests/test_pagerank.py::TestSumAggregator)
# ======================================================================
class TestSumAggregator:
    def test_registered_and_not_idempotent(self):
        assert TSR.AGGREGATORS["sum"] is TSR.SUM
        assert not TSR.SUM.idempotent
        assert all(TSR.AGGREGATORS[a].idempotent
                   for a in ("min", "max", "or"))
        assert TSR.for_semiring("plus_times") is TSR.SUM

    def test_scatter_accumulates(self):
        v = torch.zeros(4)
        idx = torch.tensor([1, 1, 3, 4])  # 4 = out of bounds -> dropped
        vals = torch.tensor([1.0, 2.0, 5.0, 9.0])
        assert TSR.SUM.scatter(v, idx, vals).tolist() == [0.0, 3.0, 0.0, 5.0]

    def test_program_declares_non_self_stabilizing(self):
        prog = TP.get_program("pagerank")
        assert prog.aggregator is TSR.SUM
        assert not prog.self_stabilizing
        assert prog.aux_channels == 2 and prog.init_aux is not None
        assert prog.push_eps > 0
