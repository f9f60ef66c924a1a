"""Port parity: the serving plane (``serve/``), the streaming edge delta
(``core/graph.py::apply_edge_delta``) and the session's delta hooks.

The same seeded graphs, states and deltas go through the JAX package (on
the CPU) and the port (``device="cpu"``): the patched CSR and both frontier
seeders must be bitwise the JAX package's; a ``GraphServer`` after
``converge`` and ``apply_delta`` must hold the JAX server's states (sync
and async, pagerank's aux planes too); store, cache and admission queue
must behave alike and share one on-disk format; the ``graph_serve``
metrics must be equal.  A forked session ticked under kills must leave
its primary bitwise as it was: the fork shares the primary's tensors.
"""
import contextlib
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

from repro.configs.base import GraphConfig as JCfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.dist.sharding import vertex_partition as j_partition  # noqa: E402
from repro.launch import graph_serve as j_graph_serve  # noqa: E402
from repro.serve import cache as JCache  # noqa: E402
from repro.serve import engine as JAdm  # noqa: E402
from repro.serve import graph as JS  # noqa: E402
from repro.serve import store as JStore  # noqa: E402
from repro_torch.configs.base import GraphConfig as TCfg  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import programs as TP  # noqa: E402
from repro_torch.dist.sharding import vertex_partition  # noqa: E402
from repro_torch.launch import graph_serve  # noqa: E402
from repro_torch.serve import cache as TCache  # noqa: E402
from repro_torch.serve import engine as TAdm  # noqa: E402
from repro_torch.serve import graph as TS  # noqa: E402
from repro_torch.serve import store as TStore  # noqa: E402

BASE = dict(name="t-serve", algorithm="cc", num_vertices=256, avg_degree=4,
            generator="rmat", num_shards=4, seed=5, enforce_fraction=0.5,
            priority="log", max_ticks=30000)
PR = dict(BASE, algorithm="pagerank", num_vertices=128, enforce_fraction=1.0)
FIELDS = ("values", "active", "cursor", "tick", "aux")
GRAPH_FIELDS = ("row_ptr", "col_idx", "weights", "edge_counts", "boundary")


def _np(x):
    if x is None:
        return None
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _bitwise(a, b, what):
    a, b = _np(a), _np(b)
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _same_state(js, ts, what=""):
    for f in FIELDS:
        _bitwise(getattr(js, f), getattr(ts, f), f"{what}{f}")


def _same_graph(jg, tg):
    for f in GRAPH_FIELDS:
        _bitwise(getattr(jg, f), getattr(tg, f), f)
    assert (jg.num_vertices, jg.num_edges, jg.es) == \
        (tg.num_vertices, tg.num_edges, tg.es)


def _port_graph(jg):
    return TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)


def _to_port(jstate):
    return TE.state_from_numpy(
        *(np.asarray(getattr(jstate, f)) for f in FIELDS[:4]),
        aux=None if jstate.aux is None else np.asarray(jstate.aux),
        device="cpu")


def _delta(graph, kind, seed=3):
    """Seeded (insertions, deletions) drawn from the live topology.  The
    deletions cut a leaf off (a split the fixpoint must undo) besides
    three random edges; the mixed kind also deletes and re-inserts one
    existing edge."""
    rng = np.random.default_rng(seed)
    n = graph.num_real_vertices
    edges = JG.edge_list(graph)
    ins = ([(int(rng.integers(n)), int(rng.integers(n))) for _ in range(3)]
           if kind in ("insert", "mixed") else [])
    dele = []
    if kind in ("delete", "mixed"):
        deg = np.bincount(edges[:, 0], minlength=n)
        leaves = np.nonzero(deg[edges[:, 0]] == 1)[0]
        picks = rng.choice(len(edges), 3, replace=False)
        dele = [tuple(int(x) for x in edges[i])
                for i in [leaves[seed % len(leaves)], *picks]]
    if kind == "mixed":
        ins.append(tuple(int(x) for x in edges[0]))
        dele.append(tuple(int(x) for x in edges[0]))
    return ins, dele


# ======================================================================
# the edge delta and the seeders
# ======================================================================
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["insert", "delete", "mixed"])
def test_apply_edge_delta_byte_identical(weighted, kind):
    jg = JG.build_sharded_graph(JCfg(**dict(BASE, weighted=weighted)))
    ins, dele = _delta(jg, kind)
    jnew, jd = JG.apply_edge_delta(jg, ins, dele, seed=11)
    tnew, td = TG.apply_edge_delta(_port_graph(jg), ins, dele, seed=11)
    _same_graph(jnew, tnew)
    for a, b, what in zip(jd, td, jd._fields):
        _bitwise(a, b, what)
    assert len(td.inserted) + len(td.deleted) > 0


@pytest.mark.parametrize("generator,shards", [("rmat", 3), ("chain", 4),
                                              ("star", 1), ("er", 4)])
def test_apply_edge_delta_chained_deltas(generator, shards):
    """The port splices only the shards a delta touches; eight chained
    random deltas (a vertex's every edge cut, edges deleted and
    re-inserted, absent deletions) stay byte-identical to the JAX
    package's rebuild from the whole edge list."""
    cfg = JCfg(name="t", algorithm="cc", num_vertices=64, avg_degree=3,
               generator=generator, num_shards=shards, weighted=True)
    jg = JG.build_sharded_graph(cfg)
    tg = _port_graph(jg)
    rng = np.random.default_rng(shards)
    n = jg.num_real_vertices
    for step in range(8):
        e = JG.edge_list(jg)
        ins = [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(3)]
        dele = [tuple(int(x) for x in e[i])
                for i in rng.choice(len(e), min(len(e), 6), replace=False)]
        u = int(e[rng.integers(len(e))][0])
        dele += [tuple(int(x) for x in r) for r in e[e[:, 0] == u]]
        ins += dele[:step % 3]
        dele.append(tuple(int(x) for x in rng.integers(0, n, 2)))
        jg, jd = JG.apply_edge_delta(jg, ins, dele, seed=step)
        tg, td = TG.apply_edge_delta(tg, ins, dele, seed=step)
        _same_graph(jg, tg)
        for a, b, what in zip(jd, td, jd._fields):
            _bitwise(a, b, what)


def test_apply_edge_delta_insert_weights_and_errors():
    jg = JG.build_sharded_graph(JCfg(**dict(BASE, weighted=True)))
    tg = _port_graph(jg)
    ins = [(1, 2), (3, 9), (7, 7)]
    w = np.asarray([0.25, 0.5, 0.75, 1.0], np.float32)  # per canonical edge
    jnew, _ = JG.apply_edge_delta(jg, ins, insert_weights=w)
    tnew, _ = TG.apply_edge_delta(tg, ins, insert_weights=w)
    _same_graph(jnew, tnew)
    empty, d = TG.apply_edge_delta(tg)
    _same_graph(jg, empty)
    assert d.endpoints.size == 0 and d.endpoints.dtype == np.int64
    with pytest.raises(ValueError, match="outside the graph"):
        TG.apply_edge_delta(tg, [(0, tg.num_real_vertices)])


def _converged_jax(kw, schedule=None):
    cfg = JCfg(**kw)
    g = JG.build_sharded_graph(cfg)
    sess = JE.EngineSession(cfg, graph=g, schedule=schedule)
    assert sess.tick_until_quiescent()["converged"]
    return cfg, g, sess


@pytest.mark.parametrize("program", ["cc", "sssp", "reachability"])
@pytest.mark.parametrize("kind", ["delete", "mixed"])
def test_seed_idempotent_delta_bitwise(program, kind):
    cfg, jg, sess = _converged_jax(dict(BASE, algorithm=program,
                                        weighted=program == "sssp"))
    ins, dele = _delta(jg, kind, seed=7)
    jnew, dinfo = JG.apply_edge_delta(jg, ins, dele)
    tg, tnew = _port_graph(jg), _port_graph(jnew)
    want, jn = JS.seed_idempotent_delta(sess.prog, jg, jnew, sess.state,
                                        dinfo)
    got, tn = TS.seed_idempotent_delta(TP.get_program(TCfg(**vars(cfg))), tg,
                                       tnew, _to_port(sess.state), dinfo)
    assert jn == tn
    assert tn > 0 or program == "reachability"  # a cut leaf may be unreached
    _same_state(want, got)


@pytest.mark.parametrize("kind", ["insert", "mixed"])
def test_seed_pagerank_delta_bitwise(kind):
    cfg, jg, sess = _converged_jax(PR)
    ins, dele = _delta(jg, kind, seed=9)
    jnew, dinfo = JG.apply_edge_delta(jg, ins, dele)
    want, jn = JS.seed_pagerank_delta(sess.prog, cfg.damping, jg, jnew,
                                      sess.state, dinfo)
    got, tn = TS.seed_pagerank_delta(TP.get_program(TCfg(**vars(cfg))),
                                     cfg.damping, _port_graph(jg),
                                     _port_graph(jnew), _to_port(sess.state),
                                     dinfo)
    assert jn == tn and tn > 0
    _same_state(want, got)


# ======================================================================
# the session's delta hooks
# ======================================================================
PATHS = {"plain": ({}, {}),
         "crowded": ({}, dict(slow_fraction=0.5, slow_delay=2,
                              slow_intensity=2)),
         "async": (dict(schedule="async"), dict(slow_fraction=0.5,
                                                 slow_delay=2,
                                                 slow_intensity=2))}


def _tensors(sess) -> dict:
    """Every tensor the session holds, by path: the core, ring, demotion
    and clock planes, the ring checkpoint and the fault manager's
    snapshots and log."""
    out = {}

    def add(path, obj):
        if torch.is_tensor(obj):
            out[path] = obj
        elif isinstance(obj, (tuple, list)):
            for i, x in enumerate(obj):
                add(f"{path}.{i}", x)

    add("state", sess.state)
    add("astate", getattr(sess, "_astate", None))
    add("cstate", getattr(sess, "_cstate", None))
    add("ring_ckpt", sess._ring_ckpt)
    add("g", sess.g)
    fm = sess.fault_mgr
    for p, snap in sorted(fm.ckpt.items()):
        add(f"ckpt{p}", snap)
    for t, bufs in sorted(fm.msg_log.items()):
        add(f"log{t}", bufs)
    return out


def _host_fields(sess) -> dict:
    keep = ("_t", "_n_active", "_pending", "_dev_tick", "_clock",
            "_shard_busy")
    out = {k: getattr(sess, k) for k in keep if hasattr(sess, k)}
    out["totals"] = dict(sess.totals)
    out["log"] = len(sess.log)
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kw", [BASE, PR], ids=["cc-replay",
                                                 "pagerank-restore"])
def test_fork_does_not_alias(path, kw):
    """Tick a fork 30 steps under kills (replay for CC, the global
    checkpoint restore, ring included, for pagerank): the primary's
    tensors and host fields are bitwise what they were, and the primary
    then ticks on to what an un-forked twin reaches."""
    sess_kw, slow = PATHS[path]
    cfg = TCfg(**kw)
    g = TG.build_sharded_graph(cfg)

    def session():
        plan = TF.FaultPlan(1.0, start_tick=3, every=3, **slow)
        return TE.EngineSession(cfg, graph=g, fault_plan=plan,
                                collect_log=True, device="cpu", **sess_kw)

    prim, twin = session(), session()
    for s in (prim, twin):
        for _ in range(5):
            s.step()
    assert prim.crowded == (path != "plain")
    before = {k: v.clone() for k, v in _tensors(prim).items()}
    host = _host_fields(prim)
    fork = prim.fork()
    for _ in range(30):
        fork.step()
    assert fork.totals["failures"] >= 3 and prim.totals["failures"] == 1
    after = _tensors(prim)
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
    assert _host_fields(prim) == host
    tp, tt = prim.tick_until_quiescent(), twin.tick_until_quiescent()
    assert tp == tt and tp["converged"]
    _same_state(prim.state, twin.state)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_delta_hooks_match_jax_session(path):
    """``replace_state``, ``rebind_graph`` and ``rebase_recovery`` on a
    converged session, then kills on the patched graph: the port ends
    with the JAX session's state, totals and snapshots."""
    sess_kw, slow = PATHS[path]
    kw = dict(BASE, algorithm="sssp", weighted=True)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jg = JG.build_sharded_graph(jcfg)
    tg = _port_graph(jg)
    # the kills start on the first step after the delta: the step count
    # of a kill-free run with the same slowdown
    ticks = TE.EngineSession(
        tcfg, graph=tg, device="cpu", fault_plan=TF.FaultPlan(0.0, **slow),
        **sess_kw).tick_until_quiescent()["ticks"]
    plan = dict(fail_fraction=1.0, start_tick=ticks, every=2, **slow)
    js = JE.EngineSession(jcfg, graph=jg, fault_plan=JF.FaultPlan(**plan),
                          **sess_kw)
    ts = TE.EngineSession(tcfg, graph=tg, fault_plan=TF.FaultPlan(**plan),
                          device="cpu", **sess_kw)
    assert js.tick_until_quiescent()["converged"]
    ts.tick_until_quiescent()
    ins, dele = _delta(jg, "mixed", seed=4)
    jnew, dinfo = JG.apply_edge_delta(jg, ins, dele)
    tnew, _ = TG.apply_edge_delta(tg, ins, dele)
    for sess, S, new in ((js, JS, jnew), (ts, TS, tnew)):
        seeded, _ = S.seed_idempotent_delta(sess.prog, sess.graph, new,
                                            sess.state, dinfo)
        sess.rebind_graph(new)
        sess.replace_state(seeded)
        sess.rebase_recovery()
    assert js.quiescent == ts.quiescent is False
    for p in range(tg.num_shards):
        for a, b in zip(js.fault_mgr.ckpt[p], ts.fault_mgr.ckpt[p]):
            _bitwise(a, b, f"snapshot {p}")
    assert list(js.fault_mgr.ckpt_tick) == list(ts.fault_mgr.ckpt_tick)
    assert js.fault_mgr.ckpt_clock == ts.fault_mgr.ckpt_clock
    assert ts.fault_mgr.graph is tnew and not ts.fault_mgr.msg_log
    jt, tt = js.tick_until_quiescent(), ts.tick_until_quiescent()
    assert tt["failures"] > 0 and tt["converged"]
    for k in ("ticks", "sent", "accepted", "fetched", "replayed",
              "failures", "pending", "converged"):
        assert jt[k] == tt[k], k
    _same_state(js.state, ts.state)


# ======================================================================
# store, cache, admission
# ======================================================================
def _publish_both(jstore, tstore, part_j, part_t, i):
    planes = np.full((part_t.num_shards, part_t.vs), i, np.int32)
    aux = np.full((part_t.num_shards, 2, part_t.vs), i / 3, np.float32)
    fix = {"cc": {"values": planes}, "pr": {"values": planes * 0.5,
                                            "aux": aux}}
    tfix = {"cc": {"values": torch.from_numpy(planes)},
            "pr": {"values": torch.from_numpy(planes * 0.5),
                   "aux": torch.from_numpy(aux)}}
    return (jstore.publish(fix, part_j, meta={"i": i}),
            tstore.publish(tfix, part_t, meta={"i": i}))


def test_store_epochs_and_gc_with_pins(tmp_path):
    part_j, part_t = j_partition(100, 3), vertex_partition(100, 3)
    jstore = JStore.FixpointStore(str(tmp_path / "j"), keep=2)
    tstore = TStore.FixpointStore(str(tmp_path / "t"), keep=2)
    assert _publish_both(jstore, tstore, part_j, part_t, 1) == (1, 1)
    views = (jstore.view(1), tstore.view(1))
    for i in range(2, 6):
        assert _publish_both(jstore, tstore, part_j, part_t, i) == (i, i)
    assert jstore.epochs() == tstore.epochs() == [1, 4, 5]
    assert tstore.pinned() == {1}
    ids = [0, 33, 99]
    for v in views:
        assert v.lookup("cc", ids).tolist() == [1, 1, 1]
    for v in views:
        v.close()
        v.close()  # idempotent
    assert jstore.epochs() == tstore.epochs() == [4, 5]
    # a refused pin (the epoch is collected) leaves nothing to release
    assert not tstore.pin(1)  # asymplint: disable=pin-balance
    with pytest.raises(FileNotFoundError):
        tstore.view(1)
    with tstore.view() as v:
        assert v.epoch == 5 and v.programs == ["cc", "pr"]
        with pytest.raises(IndexError):
            v.lookup("cc", [100])
        with pytest.raises(KeyError, match="not in epoch"):
            v.lookup("nope", [0])


def test_store_files_cross_packages(tmp_path):
    part_j, part_t = j_partition(100, 3), vertex_partition(100, 3)
    jstore = JStore.FixpointStore(str(tmp_path / "j"))
    tstore = TStore.FixpointStore(str(tmp_path / "t"))
    _publish_both(jstore, tstore, part_j, part_t, 7)
    ids = np.arange(100)
    readers = [(JStore.FixpointStore, str(tmp_path / "t")),
               (TStore.FixpointStore, str(tmp_path / "j"))]
    for Store, d in readers:  # each package reads the other's files
        own = (TStore.FixpointStore if Store is JStore.FixpointStore
               else JStore.FixpointStore)
        with Store(d).view() as theirs, own(d).view() as mine:
            assert theirs.manifest["programs"] == mine.manifest["programs"]
            for name, ch in (("cc", None), ("pr", None), ("pr", 1)):
                _bitwise(theirs.lookup(name, ids, channel=ch),
                         mine.lookup(name, ids, channel=ch), name)


def test_lru_ttl_cache_matches_jax():
    now = [0.0]
    caches = [C.LRUTTLCache(capacity=3, ttl=5.0, clock=lambda: now[0])
              for C in (JCache, TCache)]
    script = [("put", "a"), ("put", "b"), ("get", "a"), ("put", "c"),
              ("put", "d"), ("get", "b"), ("tick", 3.0), ("get", "a"),
              ("tick", 4.0), ("get", "c"), ("peek", "a"), ("sweep", None),
              ("put", "e"), ("invalidate", None), ("get", "e"),
              ("pop", "e"), ("get", "e")]
    for op, arg in script:
        if op == "tick":
            now[0] += arg
            continue
        outs = []
        for c in caches:
            if op == "put":
                outs.append(c.put(arg, [arg]))
            elif op == "invalidate":
                outs.append(c.invalidate(lambda v: v.append("stale")))
            elif op == "sweep":
                outs.append(c.sweep())
            else:
                outs.append(getattr(c, op)(arg))
        assert outs[0] == outs[1], (op, arg)
        assert caches[0].stats() == caches[1].stats(), (op, arg)
        assert list(caches[0].keys()) == list(caches[1].keys())
    with pytest.raises(ValueError):
        TCache.LRUTTLCache(capacity=0)


def test_admission_queue_matches_jax():
    now = [10.0]
    qs = [A.AdmissionQueue(max_queue=3, clock=lambda: now[0])
          for A in (JAdm, TAdm)]
    for i, budget in enumerate((1.0, None, 5.0)):
        for q in qs:
            q.push(i, budget)
    for A, q in zip((JAdm, TAdm), qs):
        with pytest.raises(A.QueueFullError) as e:
            q.push(9)
        assert e.value.max_queue == 3
    now[0] += 2.0
    got = [q.pop_ready(1) for q in qs]
    assert got[0] == got[1] == ([(1, 10.0, None)], [(0, 2.0)])
    assert [(q.submitted, q.rejected, len(q)) for q in qs] == [(3, 1, 1)] * 2
    assert TAdm.DeadlineExceeded(1, "distance", 0.5) == \
        tuple(JAdm.DeadlineExceeded(1, "distance", 0.5))
    with pytest.raises(ValueError):
        TAdm.AdmissionQueue(max_queue=0)


# ======================================================================
# GraphServer, QueryServer, graph_serve
# ======================================================================
def _servers(kw, programs, tmp_path=None, **srv_kw):
    stores = ((str(tmp_path / "j"), str(tmp_path / "t")) if tmp_path
              else (None, None))
    js = JS.GraphServer(JCfg(**kw), programs=programs, store_dir=stores[0],
                        **srv_kw)
    ts = TS.GraphServer(TCfg(**kw), programs=programs, store_dir=stores[1],
                        device="cpu", **srv_kw)
    return js, ts


def _same_servers(js, ts):
    _same_graph(js.graph, ts.graph)
    assert sorted(js.sessions) == sorted(ts.sessions)
    for name in js.sessions:
        a, b = js.sessions[name], ts.sessions[name]
        _same_state(a.state, b.state, f"{name}.")
        for k in ("ticks", "sent", "accepted", "fetched", "converged"):
            assert a.totals_snapshot()[k] == b.totals_snapshot()[k], (name, k)
    assert (js.epoch, js.deltas_applied, js.deltas_started) == \
        (ts.epoch, ts.deltas_applied, ts.deltas_started)


@pytest.mark.parametrize("schedule", ["sync", "async"])
@pytest.mark.parametrize("program", ["cc", "sssp", "reachability"])
def test_graph_server_matches_jax(program, schedule):
    kw = dict(BASE, algorithm=program, weighted=program == "sssp")
    js, ts = _servers(kw, (program,), schedule=schedule)
    assert js.converge() == ts.converge()
    _same_servers(js, ts)
    for kind in ("mixed", "delete", "insert"):
        ins, dele = _delta(js.graph, kind, seed=len(kind))
        assert js.apply_delta(ins, dele) == ts.apply_delta(ins, dele)
        _same_servers(js, ts)


def test_pagerank_server_holds_aux_planes():
    js, ts = _servers(PR, ("cc", "pagerank"))
    assert js.converge() == ts.converge()
    for kind in ("insert", "mixed"):
        ins, dele = _delta(js.graph, kind, seed=2)
        want, got = js.apply_delta(ins, dele), ts.apply_delta(ins, dele)
        assert want == got and got["pagerank"].reactivated > 0
        _same_servers(js, ts)  # aux: residual and latch planes


def test_weighted_rank_takes_full_reseed():
    js, ts = _servers(PR, ("pagerank",), weighted_rank=True)
    js.converge()
    ts.converge()
    want, got = js.apply_delta([(1, 77)]), ts.apply_delta([(1, 77)])
    assert want == got and got["pagerank"].full_reseed
    _same_servers(js, ts)


def _queries(n, seed=0):
    rng = np.random.default_rng(seed)
    kinds = ("component_of", "distance")
    qs = [TS.GraphQuery(i, kinds[i % 2], int(rng.integers(n)))
          for i in range(40)]
    return qs + [TS.GraphQuery(40 + i, "top_k_near", int(rng.integers(n)),
                               k=4) for i in range(2)]


def test_query_server_and_top_k_match_jax(tmp_path):
    kw = dict(BASE, weighted=True)
    js, ts = _servers(kw, ("cc", "sssp"), tmp_path)
    js.converge()
    ts.converge()
    now = [0.0]
    servers = [(S, S.QueryServer(srv, num_slots=8, max_queue=24,
                                 deadline_s=5.0, clock=lambda: now[0]))
               for S, srv in ((JS, js), (TS, ts))]
    queries = _queries(js.graph.num_real_vertices)
    for S, qsrv in servers:
        full = JAdm.QueueFullError if S is JS else TAdm.QueueFullError
        for q in queries[:30]:
            with pytest.raises(full) if q.rid >= 24 else \
                    contextlib.nullcontext():
                qsrv.submit(S.GraphQuery(*q))
        qsrv.step()
    now[0] += 6.0  # the 16 still queued outlive their deadline
    for S, qsrv in servers:
        qsrv.step()  # retires them
        for q in queries[30:]:
            qsrv.submit(S.GraphQuery(*q))
        qsrv.run()
    (_, jq), (_, tq) = servers
    assert jq.stats() == tq.stats()
    assert tq.stats()["rejected"] == 6 and tq.deadline_exceeded == 16
    assert sorted(jq.done) == sorted(tq.done)
    for rid in jq.done:
        a, b = jq.done[rid], tq.done[rid]
        assert type(a).__name__ == type(b).__name__, rid
        assert (tuple(a) == tuple(b) if isinstance(a, tuple) else a == b), rid
    hot = queries[-1].vertex
    assert js.top_k_near(hot, 6) == ts.top_k_near(hot, 6)
    js.apply_delta([(hot, 3)])
    ts.apply_delta([(hot, 3)])
    assert js.top_k_near(hot, 6) == ts.top_k_near(hot, 6)  # repaired entry
    assert js.ppr_cache.stats() == ts.ppr_cache.stats()
    assert ts.ppr_cache.stats()["hits"] >= 1
    with js.reader() as jv, ts.reader() as tv:
        ids = np.arange(js.graph.num_real_vertices)
        for name in ("cc", "sssp"):
            _bitwise(js.lookup(name, ids, view=jv),
                     ts.lookup(name, ids, view=tv), name)
        assert js.freshness_lag(jv) == ts.freshness_lag(tv) == 0


def test_live_mode_lookup_and_double_buffer():
    js, ts = _servers(BASE, ("cc",))
    js.converge()
    ts.converge()
    ids = np.arange(BASE["num_vertices"])
    txns = (js.begin_delta([(0, 200)]), ts.begin_delta([(0, 200)]))
    with js.reader() as jv, ts.reader() as tv:  # epoch N while in flight
        _bitwise(jv.lookup("cc", ids), tv.lookup("cc", ids), "live")
        assert js.freshness_lag(jv) == ts.freshness_lag(tv) == 1
    with pytest.raises(RuntimeError, match="in flight"):
        ts.begin_delta([(1, 2)])
    for t in txns:
        while not t.step(2):
            pass
        t.commit()
    _bitwise(js.lookup("cc", ids), ts.lookup("cc", ids), "committed")
    with pytest.raises(KeyError):
        ts.lookup("sssp", [0])
    with pytest.raises(IndexError):
        ts.component_of([BASE["num_vertices"]])


def test_graph_serve_metrics_match_jax(tmp_path, monkeypatch, capsys):
    args = ["--config", "asymp_cc", "--reduced", "--enforce-fraction", "1.0",
            "--queries", "24", "--deltas", "2"]
    mj, mt = tmp_path / "j.json", tmp_path / "t.json"
    monkeypatch.setattr(sys, "argv", ["graph_serve", *args, "--store",
                                      str(tmp_path / "j"), "--metrics",
                                      str(mj)])
    j_graph_serve.main()
    jout = capsys.readouterr().out
    graph_serve.main([*args, "--store", str(tmp_path / "t"), "--metrics",
                      str(mt), "--device", "cpu"])
    tout = capsys.readouterr().out
    assert json.loads(mj.read_text()) == json.loads(mt.read_text())

    def counts(out):  # the printed lines, minus wall times and paths
        return [re.sub(r"[\d.]+s\b", "", ln) for ln in out.splitlines()
                if "store=" not in ln and "wrote" not in ln]

    assert counts(jout) == counts(tout) and len(counts(tout)) >= 6


def test_no_card_no_silent_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.GraphServer(TCfg(**BASE))
    with pytest.raises(SystemExit):
        graph_serve.main(["--reduced"])
