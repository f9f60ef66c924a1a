"""The port's side of ``tests/test_torch_train.py``'s ``compressed_psum``
case: a job for a ``repro_torch.launch.mesh.RankPool`` of gloo ranks on
the CPU.  Imports no JAX (each rank process imports this module to find
its job)."""
import numpy as np
import torch

from repro_torch.dist.compression import compressed_psum


def psum_rounds(ctx, xs: np.ndarray, errors: np.ndarray) -> list:
    """Three rounds on this rank's rows of ``xs`` [rounds, ranks, ...]:
    with no residual, with ``errors``, then with the carried residual.
    Returns each round's (mean, residual) as numpy arrays."""
    out = []
    err = None
    for i, x in enumerate(xs):
        e = torch.from_numpy(errors[ctx.rank].copy()) if i == 1 else err
        mean, err = compressed_psum(torch.from_numpy(x[ctx.rank].copy()),
                                    ctx.group, e)
        out.append((mean.numpy(), err.numpy()))
    return out
