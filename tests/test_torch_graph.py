"""Port parity: configs, the vertex partition and the host graph builder.

The same seeded configs go through the JAX package (``repro``) and the
PyTorch port (``repro_torch``); every config field and every graph array
must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once, and
# each worker's own thread pool over all cores oversubscribes them
torch.set_num_threads(1)

from repro.configs import asymp_graphs as j_cfgs  # noqa: E402
from repro.configs import base as j_base  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.dist import sharding as JS  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import asymp_graphs as t_cfgs  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.dist import sharding as TS  # noqa: E402

GRAPH_FIELDS = ("row_ptr", "col_idx", "weights", "edge_counts", "boundary")


def _same_array(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _cfg_pair(**kw):
    return j_base.GraphConfig(**kw), t_base.GraphConfig(**kw)


def _jax_fields(t_cfg) -> dict:
    """A port config's fields less its own ``weight_rule`` and
    ``weight_seed``, which have to give the JAX package's rule:
    ``"directed"``, drawn from ``seed``."""
    out = dataclasses.asdict(t_cfg)
    assert out.pop("weight_rule") == "directed"
    assert out.pop("weight_seed") is None
    return out


@pytest.mark.parametrize("name", sorted(j_cfgs.CONFIGS))
def test_config_table_matches(name):
    assert dataclasses.asdict(j_cfgs.CONFIGS[name]) == \
        _jax_fields(t_cfgs.CONFIGS[name])
    assert _jax_fields(t_configs.get_graph_config(name)) == \
        dataclasses.asdict(j_cfgs.CONFIGS[name])
    assert _jax_fields(t_cfgs.CONFIGS[name].reduced()) == \
        dataclasses.asdict(j_cfgs.CONFIGS[name].reduced())


def test_config_registry():
    assert sorted(t_cfgs.CONFIGS) == sorted(j_cfgs.CONFIGS)
    assert t_configs.list_graph_configs() == sorted(j_cfgs.CONFIGS)
    with pytest.raises(KeyError, match="available"):
        t_configs.get_graph_config("nope")
    # a default-constructed config has the same defaults
    j, t = _cfg_pair(name="x", algorithm="cc", num_vertices=8, avg_degree=2)
    assert dataclasses.asdict(j) == _jax_fields(t)
    assert j.num_edges == t.num_edges


@pytest.mark.parametrize("n,p", [(1024, 4), (1000, 3), (7, 8), (1, 1),
                                 (262144, 8)])
def test_vertex_partition(n, p):
    j, t = JS.vertex_partition(n, p), TS.vertex_partition(n, p)
    assert tuple(j) == tuple(t)
    assert j.padded_vertices == t.padded_vertices
    assert np.array_equal(j.ranges(), t.ranges())
    ids = np.arange(n)
    for a, b in zip(j.locate(ids), t.locate(ids)):
        assert np.array_equal(a, b)
    with pytest.raises(IndexError):
        t.locate([n])


def test_vertex_partition_rejects_empty():
    with pytest.raises(ValueError):
        TS.vertex_partition(0, 4)


GENERATORS = [
    dict(generator="rmat", num_vertices=1024, avg_degree=8, num_shards=4),
    dict(generator="rmat", num_vertices=2048, avg_degree=16, num_shards=3,
         seed=5),
    dict(generator="er", num_vertices=1000, avg_degree=4, num_shards=4),
    dict(generator="grid", num_vertices=1024, avg_degree=4, num_shards=4),
    dict(generator="chain", num_vertices=500, avg_degree=2, num_shards=3),
    dict(generator="star", num_vertices=300, avg_degree=2, num_shards=4),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("spec", GENERATORS,
                         ids=lambda s: f"{s['generator']}{s['num_vertices']}")
def test_build_sharded_graph_identical(spec, weighted):
    jc, tc = _cfg_pair(name="g", algorithm="cc", weighted=weighted, **spec)
    jg, tg = JG.build_sharded_graph(jc), TG.build_sharded_graph(tc)
    for f in ("num_vertices", "num_real_vertices", "num_edges", "num_shards",
              "vs", "es"):
        assert getattr(jg, f) == getattr(tg, f), f
    for f in GRAPH_FIELDS:
        assert _same_array(getattr(jg, f), getattr(tg, f)), f
    assert np.array_equal(jg.degrees(), tg.degrees())
    assert np.array_equal(JG.generate_edges(jc), TG.generate_edges(tc))
    je, jw = JG.edge_list(jg, with_weights=True)
    te, tw = TG.edge_list(tg, with_weights=True)
    assert np.array_equal(je, te) and np.array_equal(jw, tw)


def test_build_from_explicit_edges_identical():
    edges = np.array([[0, 1], [1, 0], [2, 2], [3, 1], [5, 4], [0, 1]])
    jc, tc = _cfg_pair(name="e", algorithm="cc", num_vertices=6,
                       avg_degree=1, num_shards=2)
    for sym in (True, False):
        jg = JG.build_sharded_graph(jc, edges=edges, symmetrize=sym)
        tg = TG.build_sharded_graph(tc, edges=edges, symmetrize=sym)
        for f in GRAPH_FIELDS:
            assert _same_array(getattr(jg, f), getattr(tg, f)), (sym, f)


def test_from_arrays_adopts_jax_graph(rmat_cc_graph):
    _, jg = rmat_cc_graph
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    for f in ("num_vertices", "num_real_vertices", "num_edges", "num_shards",
              "vs", "es"):
        assert getattr(jg, f) == getattr(tg, f), f
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(jg, f), getattr(tg, f)), f
    assert tg.row_ptr is not jg.row_ptr  # copied, never aliased
    with pytest.raises(ValueError):
        TG.ShardedGraph.from_arrays(jg.row_ptr, jg.col_idx[:2], None,
                                    jg.edge_counts, jg.boundary,
                                    num_real_vertices=16)


@pytest.fixture(scope="module")
def weighted_pair():
    jc, tc = _cfg_pair(name="w", algorithm="sssp", num_vertices=512,
                       avg_degree=4, num_shards=4, weighted=True, seed=3)
    jg, tg = JG.build_sharded_graph(jc), TG.build_sharded_graph(tc)
    return jg, tg


def test_oracles_identical(weighted_pair):
    jg, tg = weighted_pair
    n = jg.num_real_vertices
    edges, w = JG.edge_list(jg, with_weights=True)
    comp = JG.cc_oracle(n, edges)
    assert np.array_equal(comp, TG.cc_oracle(n, edges))
    for src in (0, 17):
        assert np.array_equal(JG.reachability_oracle(n, edges, src),
                              TG.reachability_oracle(n, edges, src))
        assert np.array_equal(JG.sssp_oracle(n, edges, w, src),
                              TG.sssp_oracle(n, edges, w, src))
        assert np.array_equal(
            JG.widest_path_oracle(n, edges[:, 0], edges[:, 1], w, src),
            TG.widest_path_oracle(n, edges[:, 0], edges[:, 1], w, src))
    assert np.array_equal(JG.labelprop_oracle(n, edges),
                          TG.labelprop_oracle(n, edges))
    assert np.array_equal(JG.labelprop_oracle(n, comp=comp),
                          TG.labelprop_oracle(n, comp=comp))
