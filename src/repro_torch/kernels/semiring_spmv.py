"""Semiring edge propagation (the ASYMP hot loop): wrapper of the CUDA kernel.

Counterpart of ``repro.kernels.semiring_spmv``, whose Pallas kernel
``_spmv_kernel`` (``src/repro/kernels/semiring_spmv.py:71-97``, launched by
``pl.pallas_call`` at ``:120``) this module's CUDA kernel
``csrc/semiring_spmv.cu`` replaces.  The contract is unchanged — a
pull-mode semiring SpMV over a destination-sorted, tile-padded edge
stream, one ``[TILE]`` partial per ``EDGE_BLOCK`` of edges:

    out[b, t] = tie(REDUCE_{e in block b, dst_e == t} COMBINE(v_e, w_e), identity)

with semirings (min, .) for CC, (min, +) for SSSP/BFS, (max, .) for label
propagation, (max, min) for widest path, (or, .) for reachability and
(+, *) for PageRank.  Lanes no edge hits hold the identity; ``dst = -1``
marks padding.  Every idempotent reduce is one of ``core.semiring``'s
Aggregators, so kernel names and engine programs cannot drift.

The scalar kernel is a segmented reduction over the destination-sorted
stream, bound by the bytes it reads: each thread loads four consecutive
edges as 16-byte vectors, and a warp whose 128 dst never decrease (every
block of ``ops.build_pulled_graph``'s stream) reduces each run with a
shuffle scan and no atomics; any other warp scans its edges per lane.
Both orders are fixed, so every launch gives the same bits; ``plus_times``
sums run-then-tree, not in edge order, and is held to rtol/atol 1e-5
against the plain version.  ``use_mxu=True`` selects the tensor-core form
of ``plus_times`` (the JAX package's one-hot matmul on the TPU's matrix
unit): the same sum, as a one-hot ``[128, 512]`` matrix times the edge
values split into three bf16 terms, on ``mma.sync`` with fp32
accumulation.  Each warp takes 8 k-steps of 16 edges and issues the
products only for the 16-lane M tiles in its k-step's span of dst, which
on the destination-sorted stream is about one tile; ``mma_tile_steps``
counts the (k-step, M tile) pairs it issues.

``spmv_partials`` launches the kernel for CUDA tensors and takes the plain
version (``kernels/ref.py``) only for tensors on the CPU; there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.semiring import for_semiring

TILE = 128  # destination vertices per tile
EDGE_BLOCK = 512  # edges per block

SEMIRINGS = ("min", "min_plus", "max", "max_min", "or", "plus_times")
# the C entry point's semiring and dtype codes (csrc/semiring_spmv.cu)
_SEMIRING_CODE = {s: i for i, s in enumerate(SEMIRINGS)}
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}


def _identity(semiring: str, dtype: torch.dtype):
    """The aggregator's identity as a Python scalar of ``dtype``'s kind
    (plus_times/SUM: 0)."""
    agg = for_semiring(semiring)
    kind = "float32" if dtype.is_floating_point else "int32"
    return agg.identity(kind)


def _combine(semiring: str, vals, w):
    if semiring in ("min", "max", "or"):
        return vals
    if semiring == "min_plus":
        return vals + w
    if semiring == "max_min":
        return torch.minimum(vals, w)  # path bottleneck
    return vals * w  # plus_times


def spmv_partials(edge_vals: torch.Tensor, edge_dst_local: torch.Tensor,
                  edge_weights: Optional[torch.Tensor], *, semiring: str,
                  use_mxu: bool = False) -> torch.Tensor:
    """[n_blocks*EB] edge stream -> [n_blocks, TILE] per-block partials.

    edge_dst_local: int32 destination index within the block's tile
    (-1 = padding).  ``edge_weights`` may be None (unit weights).
    ``use_mxu`` selects the tensor-core form of ``plus_times`` (float32
    values; other semirings ignore it, as in the JAX package); on the CPU
    the plain version computes the same sum.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}; valid: {SEMIRINGS}")
    n = edge_vals.shape[0]
    if edge_vals.dim() != 1 or n % EDGE_BLOCK:
        raise ValueError(f"edge stream must be 1-D with a length that is a "
                         f"multiple of {EDGE_BLOCK}, got {tuple(edge_vals.shape)}")
    if edge_vals.device.type == "cpu":
        from repro_torch.kernels import ref
        return ref.spmv_partials_ref(edge_vals, edge_dst_local, edge_weights,
                                     semiring=semiring)
    if edge_vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {edge_vals.device}")
    mxu = use_mxu and semiring == "plus_times"
    dtype = edge_vals.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"edge_vals must be int32 or float32, got {dtype}")
    if mxu and dtype != torch.float32:
        raise TypeError(f"the tensor-core form of plus_times takes float32 "
                        f"values, got {dtype}")
    if edge_dst_local.dtype != torch.int32 or \
            edge_dst_local.shape != edge_vals.shape:
        raise TypeError("edge_dst_local must be int32 of the same shape as "
                        "edge_vals")
    # min, max and or ignore the weights: they are checked as inputs, but
    # neither cast nor passed to the kernel
    reads_weights = semiring not in ("min", "max", "or")
    if edge_weights is not None:
        if edge_weights.shape != edge_vals.shape:
            raise ValueError("edge_weights must match edge_vals' shape")
        if reads_weights:  # in the value dtype, as the JAX wrapper casts
            edge_weights = edge_weights.to(dtype)
    tensors = [edge_vals, edge_dst_local] + (
        [edge_weights] if edge_weights is not None else [])
    for t in tensors:
        if t.device != edge_vals.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if t.data_ptr() % 16:  # both kernels load 16-byte vectors
            raise ValueError("inputs must start on a 16-byte boundary")
    if not reads_weights:
        edge_weights = None

    n_blocks = n // EDGE_BLOCK
    out = torch.empty((n_blocks, TILE), dtype=dtype, device=edge_vals.device)
    if n_blocks == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load("semiring_spmv")
    device = edge_vals.device
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    # the library links its own CUDA runtime, which torch's current device
    # does not reach, so the launch names its device itself
    stream = torch.cuda.current_stream(index).cuda_stream
    err = lib.spmv_partials_launch(
        index, _SEMIRING_CODE[semiring], _DTYPE_CODE[dtype], int(mxu),
        ctypes.c_void_p(edge_vals.data_ptr()),
        ctypes.c_void_p(edge_dst_local.data_ptr()),
        ctypes.c_void_p(edge_weights.data_ptr()
                        if edge_weights is not None else None),
        ctypes.c_void_p(out.data_ptr()), n_blocks, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"semiring_spmv kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(lib, err)})")
    key = (f"{semiring}{'_mxu' if mxu else ''}/"
           f"{str(dtype).replace('torch.', '')}")
    spmv_partials.launches_by_form[key] = \
        spmv_partials.launches_by_form.get(key, 0) + 1
    return out


def mma_tile_steps(edge_dst_local) -> int:
    """The (k-step, M tile) pairs the tensor-core form issues on this dst
    stream: for each k-step of 16 consecutive edges with a valid dst
    (``0 <= dst < TILE``), the 16-lane M tiles in the span from its lowest
    to its highest valid dst's tile.  Each pair is one
    ``mma.sync.m16n8k16``, 4,096 FLOP."""
    dst = torch.as_tensor(edge_dst_local).reshape(-1)
    if dst.numel() % EDGE_BLOCK:
        raise ValueError(f"edge stream length {dst.numel()} is not a "
                         f"multiple of {EDGE_BLOCK}")
    d = dst.to(torch.int64).reshape(-1, 16)
    valid = (d >= 0) & (d < TILE)
    tile = d.clamp(0, TILE - 1) // 16
    hi = torch.where(valid, tile, -1).amax(dim=1)
    lo = torch.where(valid, tile, TILE).amin(dim=1)
    return int((hi - lo + 1).clamp(min=0).sum())


# launches of the CUDA kernels in this process per "semiring/dtype" form,
# the tensor-core form as "plus_times_mxu/float32" (CPU calls never count)
spmv_partials.launches_by_form = {}


def reset_launch_counts() -> None:
    spmv_partials.launches_by_form = {}
