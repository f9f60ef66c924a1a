"""The invariant the scalar SpMV kernel's fast path relies on, on the CPU.

The CUDA kernel (``src/repro_torch/csrc/semiring_spmv.cu``) reduces a warp
with a segmented scan when the warp's dst never decrease, and scans per
lane otherwise.  Every block of the pulled stream must therefore be sorted
for the main path to take the fast path: valid ``dst_local`` never
decrease, padding (``-1``) comes only after the block's last valid edge,
and the block lies in the one tile ``block_tile`` names.  Both the JAX
package's builder and the port's are checked, on the same graphs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import GraphConfig  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels.semiring_spmv import EDGE_BLOCK, TILE  # noqa: E402

GRAPHS = {
    "star": dict(generator="star", num_vertices=256, avg_degree=4,
                 num_shards=4),
    "rmat_weighted": dict(generator="rmat", num_vertices=1000, avg_degree=6,
                          num_shards=3, weighted=True, seed=2),
}


def _pulled(jg, builder):
    if builder == "jax":
        return JO.build_pulled_graph(jg)
    return TO.build_pulled_graph(TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices))


@pytest.mark.parametrize("builder", ["jax", "torch"])
@pytest.mark.parametrize("name", ["rmat_cc", "star", "rmat_weighted"])
def test_blocks_are_sorted_and_padded_at_the_tail(request, builder, name):
    if name == "rmat_cc":
        jg = request.getfixturevalue("rmat_cc_graph")[1]
    else:
        jg = JG.build_sharded_graph(GraphConfig(name=name, algorithm="cc",
                                                **GRAPHS[name]))
    pg = _pulled(jg, builder)
    dst = np.asarray(pg.edge_dst_local).reshape(-1, EDGE_BLOCK)
    src = np.asarray(pg.edge_src).reshape(-1, EDGE_BLOCK)
    tile = np.asarray(pg.block_tile)
    assert dst.shape[0] == len(tile) > 0
    valid = dst >= 0
    # padding is -1 (in dst and src alike), and only after the block's
    # last valid edge: no padding slot is followed by a valid one
    assert (dst[~valid] == -1).all() and (src[~valid] == -1).all()
    assert (src[valid] >= 0).all()
    assert not (~valid[:, :-1] & valid[:, 1:]).any()
    assert (dst[valid] < TILE).all()
    # valid dst never decrease within a block
    key = np.where(valid, dst, TILE)
    assert (np.diff(key, axis=1) >= 0).all()
    # each block lies in the tile block_tile names: the (src, tile * TILE +
    # dst_local) pairs are exactly the graph's edges, each tile's blocks in
    # a row and in tile order
    assert (np.diff(tile) >= 0).all()
    got = np.stack([src[valid], (tile[:, None] * TILE + dst)[valid]], 1)
    want = JG.edge_list(jg)
    order = lambda e: e[np.lexsort((e[:, 0], e[:, 1]))]  # noqa: E731
    assert np.array_equal(order(got.astype(np.int64)),
                          order(want.astype(np.int64)))
