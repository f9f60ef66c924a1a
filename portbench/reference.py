"""The plain reference's arithmetic, in torch: WCC and SSSP on the cleaned
edge list, which the files of ``references/`` put to a configuration.

It reads only the benchmark's own inputs (the undirected edge list of the
generator, the configuration and the seed) and imports nothing of the
program.  The edge weights are worked out again from the rule of the
program's build: one ``uniform(0.1, 1.0)`` float32 draw per directed edge,
in ``(src, dst)`` order, from ``numpy.random.default_rng(seed + 7)``.

Both fixpoints are unique, so the comparison is exact:

* WCC: every vertex carries the least vertex id of its component;
* SSSP: ``d[root] = 0`` and ``d[v] = min over edges (u, v) of
  float32(d[u] + w)``.  ``x -> float32(x + w)`` is monotone, so every
  order of relaxation reaches the same least fixpoint, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

WEIGHT_SEED_OFFSET = 7
WEIGHT_LOW, WEIGHT_HIGH = 0.1, 1.0


def directed(undirected: torch.Tensor, n: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions of every undirected edge, sorted by ``(src, dst)``."""
    lo, hi = undirected[:, 0], undirected[:, 1]
    key, _ = torch.sort(torch.cat([lo * n + hi, hi * n + lo]))
    return key // n, key % n


def weights(num_directed: int, seed: int) -> np.ndarray:
    """The configuration's weight rule, one float32 a directed edge."""
    rng = np.random.default_rng(seed + WEIGHT_SEED_OFFSET)
    return rng.uniform(WEIGHT_LOW, WEIGHT_HIGH,
                       size=num_directed).astype(np.float32)


def _min_rounds(values: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                step, stop_short: bool) -> torch.Tensor:
    """Synchronous rounds ``v <- min(v, scatter-min over edges of
    step(v[src]))`` to the fixpoint, or the round before it."""
    prev = values
    while True:
        cand = step(values[src])
        nxt = values.scatter_reduce(0, dst, cand, "amin", include_self=True)
        if torch.equal(nxt, values):
            return prev if stop_short else values
        prev, values = values, nxt


def wcc(src: torch.Tensor, dst: torch.Tensor, n: int, *,
        stop_short: bool = False) -> torch.Tensor:
    """int64 ``[n]``: the least vertex id of each vertex's component."""
    labels = torch.arange(n, dtype=torch.int64, device=src.device)
    return _min_rounds(labels, src, dst, lambda x: x, stop_short)


def sssp(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, n: int,
         root: int, dtype=torch.float32) -> torch.Tensor:
    """float32 ``[n]``: distances from ``root`` (inf where unreachable),
    computed in ``dtype``."""
    dist = torch.full((n,), float("inf"), dtype=dtype, device=src.device)
    dist[root] = 0
    w = w.to(dtype)
    return _min_rounds(dist, src, dst, lambda x: x + w,
                       False).to(torch.float32)


def mismatches(answer: np.ndarray, expected: torch.Tensor) -> int:
    """Vertices whose answer differs from the reference (exact; inf equals
    inf, and a NaN equals nothing)."""
    exp = expected.cpu().numpy()
    ans = np.asarray(answer)
    if ans.shape != exp.shape:
        return int(max(ans.size, exp.size))
    return int(np.count_nonzero(ans.astype(exp.dtype) != exp))
