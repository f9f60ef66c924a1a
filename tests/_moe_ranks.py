"""The port's side of ``tests/test_torch_moe_a2a.py``: a job for a
``repro_torch.launch.mesh.RankPool`` of gloo ranks on the CPU.  Imports
no JAX (each rank process imports this module to find its job)."""
import math

import torch

from repro_torch.dist import exchange as ex_mod
from repro_torch.dist.sharding import Mesh, use_mesh_rules
from repro_torch.models import moe, moe_a2a


def moe_layer(ctx, shape: dict, cfg, p: dict, x: torch.Tensor,
              ct: torch.Tensor):
    """``apply_moe`` on this rank of a ``shape`` mesh (laid over the first
    ranks of the pool): its block of the global ``x`` and its slices of
    the global weights ``p``, then the backward of ``sum(y * ct) + aux``
    (each rank's share: its block of ``ct``, the aux over the mesh's
    size).  Returns (the output block as fp32, the aux, this rank's
    coordinates, the gradients of its weight slices and of its block of
    x as fp32), or None on a rank past the mesh."""
    mesh = Mesh.build(shape, ctx.rank)
    if mesh is None:
        return None
    local = {k: v.clone().requires_grad_()
             for k, v in moe_a2a.rank_weights(p, cfg, mesh).items()}
    xb = moe_a2a.rank_block(x, mesh).clone().requires_grad_()
    with use_mesh_rules(mesh):
        y, aux = moe.apply_moe(local, cfg, xb)
        share = math.prod(shape.values())
        ct_l = moe_a2a.rank_block(ct, mesh)
        loss = torch.sum(y.float() * ct_l) + aux / share
        loss.backward()
    grads = {k: v.grad.float() for k, v in local.items()}
    return (y.detach().float(), float(aux.detach()), mesh.coords, grads,
            xb.grad.float())


def mesh_groups(ctx, shape: dict) -> tuple:
    """This rank's coordinates on a ``shape`` mesh, and for each set of
    axes the ranks an all-gather over its group returns, in order."""
    mesh = Mesh.build(shape, ctx.rank)
    me = torch.tensor([ctx.rank])
    return mesh.coords, {",".join(axes): ex_mod.all_gather(
        me, group).tolist() for axes, group in mesh.groups.items()}
