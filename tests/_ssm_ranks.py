"""The port's side of ``tests/test_torch_ssm.py``'s multi-rank cases:
jobs for a ``repro_torch.launch.mesh.RankPool`` of gloo ranks on the
CPU.  Imports no JAX (each rank process imports this module to find its
job)."""
import torch

from repro_torch.dist.sharding import Mesh, use_mesh_rules
from repro_torch.models import moe_a2a, ssm


def ssd_seq_parallel(ctx, shape: dict, args: list, chunk: int,
                     ct: torch.Tensor):
    """``_ssd_seq_parallel_call`` on this rank of a ``shape`` mesh: its
    blocks of the global (x, dt, B, C) as ``moe_a2a.rank_block`` cuts
    them, ``a`` whole; then the backward of its share of ``sum(y * ct)``.
    Returns (this rank's y block, the gradients of its blocks and of
    ``a``)."""
    mesh = Mesh.build(shape, ctx.rank)
    local = [(a if a.ndim == 1 else moe_a2a.rank_block(a, mesh))
             .clone().requires_grad_() for a in args]
    y = ssm._ssd_seq_parallel_call(*local, chunk, mesh)
    torch.sum(y * moe_a2a.rank_block(ct, mesh)).backward()
    return y.detach(), [t.grad for t in local]


def ssm_layer(ctx, shape: dict, cfg, p: dict, u: torch.Tensor,
              ct: torch.Tensor):
    """``apply_ssm`` in train mode on this rank of a ``shape`` mesh (the
    sequence-parallel SSD and the conv's rows from the previous rank):
    its block of ``u``, the layer's leaves whole; then the backward of
    its share of ``sum(y * ct)``.  Returns (its y block as fp32, the
    gradient of its u block and of each leaf as fp32)."""
    mesh = Mesh.build(shape, ctx.rank)
    local = {k: v.clone().requires_grad_() for k, v in p.items()}
    ub = moe_a2a.rank_block(u, mesh).clone().requires_grad_()
    with use_mesh_rules(mesh):
        y, _ = ssm.apply_ssm(local, cfg, ub, mode="train")
    torch.sum(y.float() * moe_a2a.rank_block(ct, mesh)).backward()
    return (y.detach().float(), ub.grad.float(),
            {k: v.grad.float() for k, v in local.items()})
