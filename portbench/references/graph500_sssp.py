"""Graph500 v3 kernel 3 SSSP: float32 min-plus distances from one fixed
source on the weighted undirected graph of one fixed dataset.

The weights are worked out again from the rule Graph500 states and the
configuration's ``weight_rule`` ``"undirected"`` names: the i-th edge of
the generator's undirected list (``(lo, hi)``, ``lo < hi``, in ascending
order) takes the i-th draw of ``numpy.random.default_rng(s + 7)
.random(E, dtype=float32)``, exactly in [0, 1), and both of its directions
carry it.  ``s`` is the dataset's weight seed, the configuration's
``engine.weight_seed``; the run's seed is not read.  The control runs in
bfloat16, the precision below the float32 the configuration states.

The source is the vertex of highest degree, the least id on ties: fixed by
the graph, as Graphalytics fixes one source a dataset, and drawn from no
seed (a seed-drawn source moves a job's work too far for one bound)."""
import numpy as np
import torch

from portbench import reference


def source(edges, n, seed):
    deg = torch.bincount(edges.reshape(-1), minlength=n)
    return int(torch.argmax(deg))  # the first of the largest


def weight_seed(config: dict) -> int:
    return int(config["engine"]["weight_seed"])


def weights(num_undirected: int, seed: int) -> np.ndarray:
    """One float32 an undirected edge, in the list's order, from the
    weight seed ``seed``."""
    rng = np.random.default_rng(seed + reference.WEIGHT_SEED_OFFSET)
    return rng.random(num_undirected, dtype=np.float32)


def _distances(edges, n, config, root, dtype):
    w = weights(edges.shape[0], weight_seed(config))
    w = torch.from_numpy(w).to(edges.device)
    lo, hi = edges[:, 0], edges[:, 1]
    return reference.sssp(torch.cat([lo, hi]), torch.cat([hi, lo]),
                          torch.cat([w, w]), n, root, dtype=dtype)


def expected(edges, n, config, seed, root):
    return _distances(edges, n, config, root, torch.float32)


def control(edges, n, config, seed, root):
    return _distances(edges, n, config, root, torch.bfloat16)
