"""Port parity: elastic resize (``ft/elastic.py``) and the on-disk
checkpoints (``ft/checkpoint.py``).

The same seeded graphs and engine states go through the JAX package (on
the CPU) and the port (``device="cpu"``): ``repartition_state`` must be
bitwise the JAX package's, a resize mid-run must converge to the oracle,
``CheckpointManager`` files must cross between the packages, and the
CSR assembled from an edge list at another shard count must be
byte-identical to ``build_sharded_graph`` (how ``chip_smoke.py`` builds
its resized graph).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from repro.configs.base import GraphConfig as JCfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import programs as JP  # noqa: E402
from repro.ft import checkpoint as JC  # noqa: E402
from repro.ft import elastic as JEl  # noqa: E402
from repro_torch.configs.base import GraphConfig as TCfg  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import merger as TM  # noqa: E402
from repro_torch.core import programs as TP  # noqa: E402
from repro_torch.ft import checkpoint as TC  # noqa: E402
from repro_torch.ft import elastic as TEl  # noqa: E402

# tests/test_substrates.py::TestElastic's graph
CC8 = dict(name="t", algorithm="cc", num_vertices=512, avg_degree=6,
           generator="rmat", num_shards=8, enforce_fraction=0.5)
PR8 = dict(name="t-pr", algorithm="pagerank", num_vertices=512, avg_degree=5,
           generator="rmat", num_shards=8, enforce_fraction=1.0)
FIELDS = ("values", "active", "cursor", "tick", "aux")


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


def _port_graph(jg):
    return TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)


def _to_port(jstate):
    return TE.state_from_numpy(
        *(np.asarray(getattr(jstate, f)) for f in FIELDS[:4]),
        aux=None if jstate.aux is None else np.asarray(jstate.aux),
        device="cpu")


def _jax_state(kw, ticks):
    """A JAX state ``ticks`` local ticks in (None: to quiescence)."""
    cfg = JCfg(**kw)
    g = JG.build_sharded_graph(cfg)
    prog = JP.get_program(cfg)
    tick = JE.make_local_tick(prog, JE.default_params(cfg, g), prog.weighted)
    state, dg = JE.init_state(prog, g), JE.to_device_graph(g)
    for _ in range(ticks or cfg.max_ticks):
        state, stats, _ = tick(state, dg)
        if ticks is None and int(stats.active) == 0:
            break
    return cfg, g, state


@pytest.mark.parametrize("kw,ticks", [(CC8, 6), (PR8, None)],
                         ids=["cc-mid-run", "pagerank-quiescent"])
@pytest.mark.parametrize("new_shards", [4, 2])
def test_repartition_bitwise(kw, ticks, new_shards):
    cfg, jg8, jstate = _jax_state(kw, ticks)
    jgN = JG.build_sharded_graph(dataclasses.replace(cfg,
                                                     num_shards=new_shards))
    want = JEl.repartition_state(jstate, jg8, jgN)
    got = TEl.repartition_state(_to_port(jstate), _port_graph(jg8),
                                _port_graph(jgN))
    for f in FIELDS:
        _bitwise(getattr(want, f), getattr(got, f), f)
    assert got.values.shape == (new_shards, jgN.vs)
    if kw is PR8:  # the quiescent push state: no latch to refuse
        assert not np.asarray(jstate.aux)[:, 1].any()


def test_repartition_refuses_latched_push():
    cfg, jg8, jstate = _jax_state(PR8, 3)
    assert np.asarray(jstate.aux)[:, 1].any()  # pushes mid-stream
    jg4 = JG.build_sharded_graph(dataclasses.replace(cfg, num_shards=4))
    with pytest.raises(ValueError, match="latched"):
        JEl.repartition_state(jstate, jg8, jg4)
    with pytest.raises(ValueError, match="latched"):
        TEl.repartition_state(_to_port(jstate), _port_graph(jg8),
                              _port_graph(jg4))


@pytest.mark.parametrize("new_shards", [4, 2])
def test_resize_mid_run_converges_to_oracle(new_shards):
    """Tick 6 steps on 8 shards, resize, converge: the oracle's labels,
    and only the old cut-crossing vertices re-activate (the reference's
    regression check)."""
    cfg8 = TCfg(**CC8)
    g8 = TG.build_sharded_graph(cfg8)
    oracle = TG.cc_oracle(g8.num_real_vertices, TG.edge_list(g8))
    sess = TE.EngineSession(cfg8, graph=g8, device="cpu")
    for _ in range(6):
        sess.step()
    cfgN = dataclasses.replace(cfg8, num_shards=new_shards)
    gN = TG.build_sharded_graph(cfgN)
    s = TEl.repartition_state(sess.state, g8, gN)
    b = g8.boundary.copy()
    b[np.arange(8), np.arange(8)] = False
    n_cut = int(b.any(axis=1).sum())
    assert int(s.active.sum()) <= n_cut + int(sess.state.active.sum())
    assert int(s.active.sum()) < gN.num_real_vertices
    resized = TE.EngineSession(cfgN, graph=gN, device="cpu")
    resized.replace_state(s)
    tot = resized.tick_until_quiescent()
    assert tot["converged"]
    prog = TP.get_program(cfgN)
    assert np.array_equal(TM.extract(resized.state, gN, prog), oracle)


def _engine_tree(state):
    return {"state": state, "meta": {"tick": 7, "nothing": None},
            "pair": (np.arange(5, dtype=np.int64), np.float32(2.5))}


def test_checkpoint_round_trip_and_gc(tmp_path):
    cfg, jg8, jstate = _jax_state(PR8, 3)
    state = _to_port(jstate)
    bf = torch.tensor([1.0, -2.5, 3.1415], dtype=torch.bfloat16)
    mgr = TC.CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save(step, {**_engine_tree(state), "bf16": bf},
                 metadata={"step": step}, blocking=step % 2 == 0)
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    tree, meta = mgr.restore(device="cpu")
    assert meta["step"] == 3 and meta["__dtypes__"]["bf16"] == "bfloat16"
    # an unregistered NamedTuple (the engine state) restores as a dict
    assert isinstance(tree["state"], dict)
    for f in FIELDS:
        _bitwise(getattr(state, f), tree["state"][f], f)
    assert tree["bf16"].dtype == torch.bfloat16
    assert torch.equal(tree["bf16"].view(torch.int16), bf.view(torch.int16))
    assert tree["meta"]["nothing"] is None and int(tree["meta"]["tick"]) == 7
    _bitwise(tree["pair"][0], np.arange(5, dtype=np.int64), "pair")
    assert all(torch.is_tensor(x) for x in tree["pair"])
    with pytest.raises(FileNotFoundError):
        TC.CheckpointManager(str(tmp_path / "empty")).restore(device="cpu")


def test_checkpoint_files_cross_packages(tmp_path):
    cfg, jg8, jstate = _jax_state(PR8, 3)
    bits = np.asarray([0x3f80, 0xc020, 0x4049, 0x7f80], np.uint16)
    jbf = jnp.asarray(bits.view(jnp.bfloat16))
    tbf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    # JAX writes, the port reads
    JC.CheckpointManager(str(tmp_path / "j")).save(
        1, {"state": jstate, "bf16": jbf}, metadata={"by": "jax"})
    tree, meta = TC.CheckpointManager(str(tmp_path / "j")).restore(
        device="cpu")
    assert meta["by"] == "jax"
    for f in FIELDS:
        _bitwise(getattr(jstate, f), tree["state"][f], f)
    assert torch.equal(tree["bf16"].view(torch.int16),
                       tbf.view(torch.int16))
    # the port writes, JAX reads
    TC.CheckpointManager(str(tmp_path / "t")).save(
        1, {"state": _to_port(jstate), "bf16": tbf}, metadata={"by": "port"})
    jtree, jmeta = JC.CheckpointManager(str(tmp_path / "t")).restore()
    assert jmeta["by"] == "port"
    for f in FIELDS:
        _bitwise(getattr(jstate, f), jtree["state"][f], f)
    assert np.asarray(jtree["bf16"]).view(np.uint16).tobytes() == \
        bits.tobytes()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shards,new_shards", [(8, 4), (4, 8)])
def test_assemble_from_edge_list_matches_builder(weighted, shards,
                                                 new_shards):
    """A graph re-assembled from another shard count's edge list is
    byte-identical to building it at the new count: with weights, the
    builder's draw (seed + 7, one weight per directed edge in (src, dst)
    order)."""
    kw = dict(name="t", algorithm="cc", num_vertices=1000, avg_degree=8,
              generator="rmat", weighted=weighted)
    g = TG.build_sharded_graph(TCfg(num_shards=shards, **kw))
    want = TG.build_sharded_graph(TCfg(num_shards=new_shards, **kw))
    edges = TG.edge_list(g)
    w = (np.random.default_rng(TCfg(**kw).seed + 7).uniform(
        0.1, 1.0, size=len(edges)).astype(np.float32) if weighted else None)
    got = TG._assemble_csr(g.num_real_vertices, new_shards, edges[:, 0],
                           edges[:, 1], w)
    for f in ("row_ptr", "col_idx", "weights", "edge_counts", "boundary"):
        _bitwise(getattr(want, f), getattr(got, f), f)
    assert (got.num_vertices, got.num_edges, got.es) == \
        (want.num_vertices, want.num_edges, want.es)
