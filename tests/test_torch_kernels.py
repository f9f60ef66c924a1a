"""Port parity: the semiring SpMV kernel module, its plain versions and the
pull step (BSP baseline, pagerank oracle), on the CPU.

Inputs are made with numpy from a seed and go through both packages: the
JAX side runs its Pallas kernel with ``interpret=True`` (as
``tests/test_kernels.py`` does), the port's wrapper takes its plain
version for CPU tensors.  Idempotent semirings must agree exactly,
``plus_times`` within rtol/atol 1e-5 (float sums in another order).
The CUDA kernel itself is checked on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once, and
# each worker's own thread pool over all cores oversubscribes them
torch.set_num_threads(1)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hermetic envs: deterministic seed-grid fallback
    from _propshim import given, settings, strategies as st

from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels import semiring_spmv as JK  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import semiring_spmv as TK  # noqa: E402

SWEEP = [("min", "int32"), ("min", "float32"), ("min_plus", "float32"),
         ("max", "int32"), ("max", "float32"), ("max_min", "float32"),
         ("or", "int32"), ("plus_times", "float32")]


def _inputs(seed, n, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        vals = rng.integers(0, 10_000, n).astype(np.int32)
    else:
        vals = rng.uniform(0.0, 10.0, n).astype(np.float32)
    dst = rng.integers(-1, TK.TILE, n).astype(np.int32)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return vals, dst, w


def _both(vals, dst, w, semiring, **kw):
    """(port wrapper, port ref, JAX kernel in interpret mode) as numpy."""
    tw = torch.from_numpy(w) if w is not None else None
    jw = jnp.asarray(w) if w is not None else None
    tv, td = torch.from_numpy(vals), torch.from_numpy(dst)
    port = TK.spmv_partials(tv, td, tw, semiring=semiring, **kw).numpy()
    port_ref = TR.spmv_partials_ref(tv, td, tw, semiring=semiring).numpy()
    jax_k = np.asarray(JK.spmv_partials(jnp.asarray(vals), jnp.asarray(dst),
                                        jw, semiring=semiring,
                                        interpret=True, **kw))
    return port, port_ref, jax_k


def _agree(a, b, semiring):
    assert a.dtype == b.dtype and a.shape == b.shape
    if semiring == "plus_times":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(a, b)


@pytest.mark.parametrize("semiring,dtype", SWEEP)
@pytest.mark.parametrize("n_blocks", [1, 3, 8])
def test_sweep_matches_jax(semiring, dtype, n_blocks):
    vals, dst, w = _inputs(n_blocks, n_blocks * TK.EDGE_BLOCK, dtype)
    port, port_ref, jax_k = _both(vals, dst, w, semiring)
    assert port.shape == (n_blocks, TK.TILE) and port.dtype == vals.dtype
    _agree(port, jax_k, semiring)
    _agree(port_ref, jax_k, semiring)
    jax_ref = np.asarray(JR.spmv_partials_ref(
        jnp.asarray(vals), jnp.asarray(dst), jnp.asarray(w),
        semiring=semiring))
    _agree(port_ref, jax_ref, semiring)


@pytest.mark.parametrize("semiring,dtype", SWEEP)
def test_unit_weights_match_jax(semiring, dtype):
    vals, dst, _ = _inputs(11, 2 * TK.EDGE_BLOCK, dtype)
    port, _, jax_k = _both(vals, dst, None, semiring)
    _agree(port, jax_k, semiring)


def test_mxu_form_matches_jax():
    """On the CPU the plain version computes the one-hot matmul's sum."""
    vals, dst, w = _inputs(7, 4 * TK.EDGE_BLOCK, "float32")
    port, _, jax_k = _both(vals, dst, w, "plus_times", use_mxu=True)
    _agree(port, jax_k, "plus_times")


def test_max_clamps_at_identity():
    vals = np.full((TK.EDGE_BLOCK,), -5.0, np.float32)
    dst = np.zeros((TK.EDGE_BLOCK,), np.int32)
    port, port_ref, jax_k = _both(vals, dst, None, "max")
    assert np.array_equal(port, jax_k) and np.array_equal(port_ref, jax_k)
    assert port[0, 0] == 0.0


def test_all_padding_block():
    vals = np.zeros((TK.EDGE_BLOCK,), np.float32)
    dst = np.full((TK.EDGE_BLOCK,), -1, np.int32)
    port, _, jax_k = _both(vals, dst, None, "min")
    assert np.isinf(port).all() and np.array_equal(port, jax_k)


def test_wrapper_validates():
    vals, dst, w = _inputs(0, 100, "float32")
    with pytest.raises(ValueError):
        TK.spmv_partials(torch.from_numpy(vals), torch.from_numpy(dst), None,
                         semiring="min")
    with pytest.raises(ValueError):
        TK.spmv_partials(torch.zeros(512), torch.zeros(512, dtype=torch.int32),
                         None, semiring="nope")


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 4), st.integers(0, 2 ** 31 - 1),
       st.sampled_from(["min", "min_plus", "max", "max_min", "plus_times"]))
def test_hypothesis_random(n_blocks, seed, semiring):
    vals, dst, w = _inputs(seed, n_blocks * TK.EDGE_BLOCK, "float32")
    port, _, jax_k = _both(vals, dst, w, semiring)
    _agree(port, jax_k, semiring)


# ======================================================================
# ops: pulled layout, pull step, BSP baseline, pagerank oracle
# ======================================================================
def _port_graph(jg):
    return TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)


@pytest.fixture(scope="module")
def graphs():
    from repro.configs.base import GraphConfig
    from repro.core.graph import build_sharded_graph
    out = {}
    for name, kw in {
            "rmat": dict(generator="rmat", num_vertices=1024, avg_degree=8,
                         num_shards=4),
            "rmat_w": dict(generator="rmat", num_vertices=1000, avg_degree=6,
                           num_shards=3, weighted=True, seed=2),
            "grid": dict(generator="grid", num_vertices=256, avg_degree=4,
                         num_shards=4),
            "star": dict(generator="star", num_vertices=256, avg_degree=4,
                         num_shards=4)}.items():
        jg = build_sharded_graph(GraphConfig(name=name, algorithm="cc", **kw))
        out[name] = (jg, _port_graph(jg))
    return out


@pytest.mark.parametrize("name", ["rmat", "rmat_w", "grid", "star"])
def test_build_pulled_graph_identical(graphs, name):
    jg, tg = graphs[name]
    jp, tp = JO.build_pulled_graph(jg), TO.build_pulled_graph(tg)
    assert (jp.num_vertices, jp.num_real_vertices, jp.n_blocks, jp.n_tiles) \
        == (tp.num_vertices, tp.num_real_vertices, tp.n_blocks, tp.n_tiles)
    for f in ("edge_src", "edge_dst_local", "block_tile", "weights"):
        a, b = getattr(jp, f), getattr(tp, f)
        if a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("semiring,dtype", [
    ("min", "int32"), ("min_plus", "float32"), ("max", "int32"),
    ("max_min", "float32"), ("or", "int32")])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_frontier_pull_step_exact(graphs, semiring, dtype, use_kernel):
    jg, tg = graphs["rmat_w"]
    jp, tp = JO.build_pulled_graph(jg), TO.build_pulled_graph(tg)
    rng = np.random.default_rng(5)
    n = jg.num_vertices  # unpadded: exercises the identity padding
    values = (rng.integers(0, n, n).astype(np.int32) if dtype == "int32"
              else rng.uniform(0, 10, n).astype(np.float32))
    if semiring == "or":
        values = (values % 2).astype(np.int32)
    # the JAX package's interpreted kernel and its plain path, against the
    # port's one path
    j = np.asarray(JO.frontier_pull_step(jnp.asarray(values), jp,
                                         semiring=semiring,
                                         use_kernel=use_kernel))
    t = TO.frontier_pull_step(torch.from_numpy(values), tp,
                              semiring=semiring)
    assert t.dtype == torch.from_numpy(values).dtype
    assert np.array_equal(j, t.numpy())


def test_pull_step_plus_times_and_full_oracle(graphs):
    jg, tg = graphs["rmat"]
    jp, tp = JO.build_pulled_graph(jg), TO.build_pulled_graph(tg)
    contrib = np.random.default_rng(9).uniform(
        0, 1, jp.num_vertices).astype(np.float32)
    j = np.asarray(JO.frontier_pull_step(jnp.asarray(contrib), jp,
                                         semiring="plus_times"))
    t = TO.frontier_pull_step(torch.from_numpy(contrib), tp,
                              semiring="plus_times").numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    # whole-graph oracle, on the real edges
    src = tp.edge_src
    dst = tp.block_tile.repeat(TK.EDGE_BLOCK) * TK.TILE + tp.edge_dst_local
    valid = src >= 0
    labels = np.arange(jp.num_vertices, dtype=np.int32)
    args = dict(semiring="min", num_vertices=jp.num_vertices)
    jf = np.asarray(JR.full_propagation_ref(
        jnp.asarray(labels), jnp.asarray(src[valid]),
        jnp.asarray(dst[valid]), None, **args))
    tf = TR.full_propagation_ref(
        torch.from_numpy(labels), torch.from_numpy(src[valid]).long(),
        torch.from_numpy(dst[valid]).long(), None, **args).numpy()
    assert np.array_equal(jf, tf)


@pytest.mark.parametrize("name", ["rmat", "rmat_w", "grid", "star"])
def test_bsp_connected_components_identical(graphs, name):
    jg, tg = graphs[name]
    jl, jstats = JO.bsp_connected_components(jg)
    tl, tstats = TO.bsp_connected_components(tg, device="cpu")
    assert jstats == tstats
    assert tl.dtype == torch.int32 and np.array_equal(np.asarray(jl),
                                                      tl.numpy())


@pytest.mark.parametrize("dangling", ["redistribute", "absorb"])
def test_pagerank_oracle_matches(graphs, dangling):
    jg, tg = graphs["rmat"]
    j = np.asarray(JO.pagerank(jg, iters=40, dangling=dangling))
    t = TO.pagerank(tg, iters=40, dangling=dangling, device="cpu").numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_pagerank_star_hub(graphs):
    _, tg = graphs["star"]
    r = TO.pagerank(tg, iters=40, device="cpu")
    assert int(torch.argmax(r)) == 0
    assert abs(float(r.sum()) - 1.0) < 0.01
