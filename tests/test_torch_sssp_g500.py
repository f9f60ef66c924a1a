"""The port's Graph500 kernel 3 weights and its edge count, on the CPU.

``GraphConfig.weight_rule="undirected"`` gives both directions of an
undirected edge one weight, the i-th float32 draw of
``default_rng(seed + 7).random`` for the i-th edge ``(lo, hi)``, in [0, 1);
the default ``"directed"`` rule stays the JAX package's, one
``uniform(0.1, 1.0)`` a directed edge.  ``weight_seed``, where set, takes
``seed``'s place in either draw.  A job's totals
(``run_to_convergence``) carry the graph's directed edges as ``edges`` on
every path.  An SSSP job under the
new rule meets kernel 3's own validation, and its crowded and async runs
reach the plain run's fixpoint bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs.base import GraphConfig  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import merger as M  # noqa: E402
from repro_torch.core import programs as P  # noqa: E402

G500 = dict(name="g500", algorithm="sssp", num_vertices=512, avg_degree=16,
            generator="rmat", rmat_abcd=(0.57, 0.19, 0.19, 0.05),
            num_shards=4, weighted=True, seed=2 ** 31 + 5)
SHAPE_FIELDS = ("row_ptr", "col_idx", "edge_counts", "boundary")


def _cfg(**kw) -> GraphConfig:
    return GraphConfig(**dict(G500, **kw))


# ------------------------------------------------------------- the rule
def test_undirected_rule_gives_both_directions_the_ith_draw():
    cfg = _cfg(weight_rule="undirected")
    g = G.build_sharded_graph(cfg)
    edges, w = G.edge_list(g, with_weights=True)
    fwd = edges[:, 0] < edges[:, 1]  # the undirected edges (lo, hi)
    und, und_w = edges[fwd], w[fwd]
    assert len(und) * 2 == len(edges)
    key = und[:, 0] * 512 + und[:, 1]
    assert bool((np.diff(key) > 0).all())  # ascending (lo, hi)
    draws = np.random.default_rng(cfg.seed + 7).random(len(und),
                                                       dtype=np.float32)
    assert np.array_equal(und_w, draws)
    canon = edges.min(axis=1) * 512 + edges.max(axis=1)
    i = np.searchsorted(key, canon)
    assert np.array_equal(key[i], canon)
    assert np.array_equal(w, und_w[i])  # w(u, v) == w(v, u), the i-th draw
    assert w.dtype == np.float32 and w.min() >= 0.0 and w.max() < 1.0
    assert (w < 0.1).any()  # the draws span [0, 1), not [0.1, 1)


def test_undirected_rule_changes_only_the_weights():
    d = G.build_sharded_graph(_cfg())
    u = G.build_sharded_graph(_cfg(weight_rule="undirected"))
    for f in SHAPE_FIELDS:
        assert np.array_equal(getattr(d, f), getattr(u, f)), f
    assert not np.array_equal(d.weights, u.weights)


@pytest.mark.parametrize("generator", ["rmat", "er", "grid"])
def test_directed_rule_is_the_default_and_unchanged(generator):
    cfg = _cfg(generator=generator, algorithm="cc")
    assert cfg.weight_rule == "directed"
    g = G.build_sharded_graph(cfg)
    explicit = G.build_sharded_graph(dataclasses.replace(
        cfg, weight_rule="directed"))
    edges, w = G.edge_list(g, with_weights=True)
    want = np.random.default_rng(cfg.seed + 7).uniform(
        0.1, 1.0, size=len(edges)).astype(np.float32)
    assert np.array_equal(w, want)  # (src, dst) order, one a direction
    for f in SHAPE_FIELDS + ("weights",):
        assert np.array_equal(getattr(g, f), getattr(explicit, f)), f


def test_an_unknown_rule_raises():
    with pytest.raises(ValueError, match="weight_rule"):
        G.build_sharded_graph(_cfg(weight_rule="per_vertex"))
    # unweighted builds draw nothing, so the rule is not read
    assert G.build_sharded_graph(_cfg(weighted=False,
                                      weight_rule="x")).weights is None


@pytest.mark.parametrize("rule", ["directed", "undirected"])
def test_weight_seed_holds_the_weights_whatever_the_seed(rule):
    """Set, ``weight_seed`` draws the weights in ``seed``'s place: two
    seeds give one weight set on one edge list, and a config without it
    draws from ``seed`` as before."""
    edges = G.generate_edges(_cfg())
    pinned = [G.build_sharded_graph(_cfg(weight_rule=rule, seed=s,
                                         weight_seed=2 ** 31 + 11),
                                    edges=edges) for s in (1, 2)]
    same = G.build_sharded_graph(_cfg(weight_rule=rule, seed=2 ** 31 + 11),
                                 edges=edges)
    other = G.build_sharded_graph(_cfg(weight_rule=rule, seed=1),
                                  edges=edges)
    assert _cfg().weight_seed is None
    assert np.array_equal(pinned[0].weights, pinned[1].weights)
    assert np.array_equal(pinned[0].weights, same.weights)
    assert not np.array_equal(pinned[0].weights, other.weights)


def test_undirected_rule_needs_both_directions():
    edges = np.array([[0, 1], [1, 0], [1, 2], [3, 2]])
    cfg = _cfg(num_vertices=4, weight_rule="undirected")
    with pytest.raises(ValueError, match="both directions"):
        G.build_sharded_graph(cfg, edges=edges, symmetrize=False)
    g = G.build_sharded_graph(cfg, edges=edges)  # symmetrised: fine
    assert g.num_edges == 6


# ---------------------------------------------------------- the counter
@pytest.mark.parametrize("kw", [{}, {"latency_profile": "stragglers"},
                                {"schedule": "async"}],
                         ids=["plain", "crowded", "async"])
def test_a_jobs_totals_carry_the_graphs_edges(kw):
    cfg = _cfg(algorithm="cc", weighted=False, **kw)
    g = G.build_sharded_graph(cfg)
    _, totals = E.run_to_convergence(cfg, graph=g, device="cpu")
    assert totals["edges"] == g.num_edges == int(g.edge_counts.sum())
    assert totals["converged"]
    assert totals["fetched"] >= g.num_edges  # every edge fetched once
    # the session's own totals, which the JAX package's match, lack it
    sess = E.EngineSession(cfg, graph=g, device="cpu")
    assert "edges" not in sess.tick_until_quiescent()


# ------------------------------------------------------------- a job
def _job(cfg, g, **kw):
    state, totals = E.run_to_convergence(cfg, graph=g, device="cpu", **kw)
    assert totals["converged"]
    return M.extract(state, g, P.get_program(cfg)), totals


def test_an_undirected_sssp_job_meets_kernel_3s_validation():
    """No edge relaxes a distance further (in float32, the program's
    precision), and every reached vertex but the source has a tight edge:
    the least fixpoint, checked from the edge list alone."""
    cfg = _cfg(weight_rule="undirected", source=1)
    g = G.build_sharded_graph(cfg)
    d, _ = _job(cfg, g)
    edges, w = G.edge_list(g, with_weights=True)
    via = d[edges[:, 0]] + w
    assert via.dtype == np.float32 and d[1] == 0.0
    assert (d[edges[:, 1]] <= via).all()
    tight = np.zeros(len(d), bool)
    tight[edges[(via == d[edges[:, 1]]) & np.isfinite(via), 1]] = True
    reached = np.isfinite(d)
    reached[1] = False
    assert tight[reached].all() and reached.sum() > 100


def test_crowded_and_async_reach_the_plain_fixpoint():
    cfg = _cfg(weight_rule="undirected", source=1)
    g = G.build_sharded_graph(cfg)
    plain, _ = _job(cfg, g)
    for kw in ({"latency_profile": "stragglers"}, {"schedule": "async"}):
        got, _ = _job(dataclasses.replace(cfg, **kw), g)
        assert np.array_equal(got, plain), kw
