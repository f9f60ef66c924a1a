"""The Graph500 Kronecker generator, on the device, and Graphalytics' cleaning.

Graph500 v3 (graph500.org, "Kernel 1"): ``edgefactor << scale`` edges, each
drawn by ``scale`` independent quadrant choices of the initiator
``A, B, C, D``.  At every level the source bit is 1 with probability
``C + D``; the destination bit is then 1 with probability ``B / (A + B)``
under a 0 source bit and ``D / (C + D)`` under a 1.  This is the recursive
quadrant model of the port's host generator (``core/graph.py::rmat_edges``),
drawn with a ``torch.Generator`` on the card in one call a level.

The graph is made undirected, with self-loops and duplicate edges dropped,
as Graphalytics' Graph500 datasets are: :func:`clean` returns each
undirected edge once, as ``(lo, hi)`` with ``lo < hi``, sorted.  Unlike
those datasets, every id below ``2**scale`` stays a vertex, isolated or
not, and ids stay in generator order (the Graph500 scramble is not
applied).
"""
from __future__ import annotations

import torch


def kronecker_edges(scale: int, edgefactor: int, initiator, seed: int,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(src, dst)`` int64 tensors of ``edgefactor << scale`` raw edges."""
    a, b, c, d = (float(x) for x in initiator)
    m = int(edgefactor) << int(scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    a_norm, c_norm = a / (a + b), c / (c + d)
    for _ in range(int(scale)):
        r = torch.rand((2, m), generator=gen, device=device)
        src_bit = r[0] > (a + b)
        dst_bit = r[1] > torch.where(src_bit, c_norm, a_norm)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src, dst


def clean(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Undirected simple graph: ``[E, 2]`` int64, one row ``(lo, hi)`` per
    edge, ``lo < hi``, in ``(lo, hi)`` order."""
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    key = torch.unique(lo * n + hi)
    return torch.stack([key // n, key % n], dim=1)


def generate(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's cleaned undirected edge list, from ``seed``."""
    scale = int(cfg["scale"])
    src, dst = kronecker_edges(scale, cfg["edgefactor"], cfg["initiator"],
                               seed, device)
    return clean(src, dst, 1 << scale)
