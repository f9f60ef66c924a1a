"""SSSP: float32 min-plus distances from the job's source, with the
weights worked out again from the rule of the program's build (see
``reference.weights``).  The control runs in bfloat16, the precision below
the float32 the configuration states.

The source is drawn from the seed among the vertices with an edge, as
Graph500 v3 draws its search keys."""
import torch

from portbench import reference


def source(edges, n, seed):
    deg = torch.bincount(edges.reshape(-1), minlength=n)
    keys = torch.nonzero(deg > 0).reshape(-1)
    gen = torch.Generator(device=edges.device)
    gen.manual_seed(int(seed))
    pick = torch.randint(keys.numel(), (1,), generator=gen,
                         device=edges.device)
    return int(keys[pick])


def _distances(edges, n, seed, root, dtype):
    src, dst = reference.directed(edges, n)
    w = torch.from_numpy(reference.weights(src.numel(), seed)).to(
        edges.device)
    return reference.sssp(src, dst, w, n, root, dtype=dtype)


def expected(edges, n, config, seed, root):
    return _distances(edges, n, seed, root, torch.float32)


def control(edges, n, config, seed, root):
    return _distances(edges, n, seed, root, torch.bfloat16)
