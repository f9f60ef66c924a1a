"""The tensor work of the tensor-core SpMV form, counted on the CPU.

The CUDA kernel's ``plus_times`` tensor-core form
(``src/repro_torch/csrc/semiring_spmv.cu::spmv_plus_times_mma_kernel``)
issues one ``mma.sync.m16n8k16`` per (k-step, M tile) pair: for each k-step
of 16 consecutive edges with a valid dst, the 16-lane M tiles in the span
from its lowest to its highest valid dst's tile.
``kernels/semiring_spmv.py::mma_tile_steps`` counts those pairs, and
``chip_smoke.py`` bounds the form's operations by that count.  It is held
here against a brute-force count, on random dst and on the pulled streams
of both packages' builders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as JO  # noqa: E402
from repro_torch.configs import get_graph_config  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels.semiring_spmv import (EDGE_BLOCK, TILE,  # noqa: E402
                                               mma_tile_steps)

KSTEP = 16  # edges per mma k-step
M_TILES = TILE // 16


def _brute(dst) -> int:
    n = 0
    for i in range(0, len(dst), KSTEP):
        tiles = [int(x) // 16 for x in dst[i:i + KSTEP] if 0 <= x < TILE]
        if tiles:
            n += max(tiles) - min(tiles) + 1
    return n


def _ksteps_with_a_valid_edge(dst) -> int:
    k = np.asarray(dst).reshape(-1, KSTEP)
    return int(((k >= 0) & (k < TILE)).any(axis=1).sum())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pad", [0.0, 0.5, 0.95])
def test_matches_brute_force_on_random_dst(seed, pad):
    """Random dst with a share of padding and of keys outside the tile
    (which no lane takes): the brute-force count, and at most all eight
    tiles of every k-step that has a valid edge."""
    rng = np.random.default_rng(seed)
    n = 4 * EDGE_BLOCK
    d = rng.integers(0, TILE, n)
    d[rng.random(n) < pad] = -1
    d[rng.random(n) < 0.02] = TILE + 5
    d = d.astype(np.int32)
    got = mma_tile_steps(d)
    assert got == _brute(d)
    assert got <= M_TILES * _ksteps_with_a_valid_edge(d)
    assert mma_tile_steps(torch.from_numpy(d)) == got


@pytest.mark.parametrize("seed", range(3))
def test_random_dst_spanning_every_tile(seed):
    """Random dst in which every k-step with a valid edge reaches tile 0
    and tile 7, and a third of the k-steps are all padding: eight pairs
    for each k-step with a valid edge."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-1, TILE, (8 * EDGE_BLOCK // KSTEP, KSTEP))
    lo, hi = rng.integers(0, KSTEP, (2, len(k)))
    hi = np.where(hi == lo, (lo + 1) % KSTEP, hi)
    rows = np.arange(len(k))
    k[rows, lo] = rng.integers(0, 16, len(k))
    k[rows, hi] = rng.integers(TILE - 16, TILE, len(k))
    k[rng.random(len(k)) < 1 / 3] = -1
    d = k.reshape(-1).astype(np.int32)
    assert mma_tile_steps(d) == M_TILES * _ksteps_with_a_valid_edge(d)
    assert mma_tile_steps(d) == _brute(d)


def test_empty_padding_and_bad_length():
    assert mma_tile_steps(np.zeros(0, np.int32)) == 0
    assert mma_tile_steps(np.full(2 * EDGE_BLOCK, -1, np.int32)) == 0
    one_lane = np.full(EDGE_BLOCK, 77, np.int32)
    assert mma_tile_steps(one_lane) == EDGE_BLOCK // KSTEP
    with pytest.raises(ValueError):
        mma_tile_steps(np.zeros(EDGE_BLOCK + KSTEP, np.int32))


@pytest.mark.parametrize("builder", ["jax", "torch"])
def test_sorted_stream_hits_about_one_tile_a_kstep(rmat_cc_graph, builder):
    """``build_pulled_graph``'s stream of the 1024-vertex test graph (the
    JAX package's and the port's): the brute-force count, and between one
    and 1.1 tiles for each k-step that has a valid edge, of the eight a
    k-step that does not skip pays for."""
    jg = rmat_cc_graph[1]
    if builder == "jax":
        d = np.asarray(JO.build_pulled_graph(jg).edge_dst_local)
    else:
        d = TO.build_pulled_graph(TG.ShardedGraph.from_arrays(
            jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
            num_real_vertices=jg.num_real_vertices)).edge_dst_local
    got = mma_tile_steps(d)
    assert got == _brute(d)
    valid_ksteps = _ksteps_with_a_valid_edge(d)
    assert valid_ksteps <= got <= 1.1 * valid_ksteps


def test_pagerank_stream_issues_31_to_32_pairs_a_block():
    """The ``asymp_pagerank`` (RMAT 2^14) stream that ``chip_smoke.py``'s
    phase 6 pulls through the tensor-core form: 31-32 pairs a block, of
    the 256 a block that does not skip issues (the 1024-vertex test graph
    has more padding, 29.7)."""
    cfg = get_graph_config("asymp_pagerank")
    d = TO.build_pulled_graph(TG.build_sharded_graph(cfg)).edge_dst_local
    n_blocks = len(d) // EDGE_BLOCK
    got = mma_tile_steps(d)
    assert got == _brute(d)
    assert 31 * n_blocks <= got <= 32 * n_blocks
