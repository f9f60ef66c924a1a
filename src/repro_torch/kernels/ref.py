"""Plain PyTorch versions of the semiring SpMV kernel (the oracles).

Counterpart of ``repro.kernels.ref``.  ``spmv_partials_ref`` is what the
kernel wrapper computes for tensors on the CPU, and what ``chip_smoke.py``
holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import for_semiring
from repro_torch.kernels.semiring_spmv import (EDGE_BLOCK, TILE, _combine,
                                               _identity)


def spmv_partials_ref(edge_vals, edge_dst_local, edge_weights, *,
                      semiring: str) -> torch.Tensor:
    """Same contract as ``kernels.semiring_spmv.spmv_partials``, via a
    segment reduce."""
    dtype = edge_vals.dtype
    n = edge_vals.shape[0]
    n_blocks = n // EDGE_BLOCK
    if edge_weights is None:
        edge_weights = torch.ones((n,), dtype=dtype, device=edge_vals.device)
    cand = _combine(semiring, edge_vals, edge_weights.to(dtype))
    block = torch.arange(n, device=edge_vals.device) // EDGE_BLOCK
    dst = edge_dst_local.to(torch.int64)
    seg = torch.where(dst >= 0, block * TILE + dst, n_blocks * TILE)
    agg = for_semiring(semiring)
    flat = agg.segment_reduce(cand, seg, n_blocks * TILE + 1)
    if agg.idempotent:
        # clamp at the aggregation identity: empty segments (dtype-extreme
        # filled) become the identity, and payloads outside the
        # aggregator's domain clamp to it — what the kernel's identity
        # initialised lanes compute
        flat = agg.tie(flat, torch.tensor(_identity(semiring, dtype),
                                          dtype=dtype, device=flat.device))
    return flat[:-1].reshape(n_blocks, TILE)


def full_propagation_ref(values, edge_src, edge_dst, edge_weights, *,
                         semiring: str, num_vertices: int) -> torch.Tensor:
    """Whole-graph pull step: out[v] = reduce over in-edges (oracle for
    ops.frontier_pull_step)."""
    vals = values[edge_src]
    if edge_weights is None:
        edge_weights = torch.ones_like(vals)
    cand = _combine(semiring, vals, edge_weights.to(vals.dtype))
    valid = edge_dst >= 0
    seg = torch.where(valid, edge_dst, num_vertices)
    agg = for_semiring(semiring)
    ident = _identity(semiring, values.dtype)
    out = agg.segment_reduce(torch.where(valid, cand, ident), seg,
                             num_vertices + 1)[:-1]
    if not agg.idempotent:
        return out
    return agg.tie(out, torch.tensor(ident, dtype=out.dtype,
                                     device=out.device))
