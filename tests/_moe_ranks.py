"""The port's side of ``tests/test_torch_moe_a2a.py``: a job for a
``repro_torch.launch.mesh.RankPool`` of gloo ranks on the CPU.  Imports
no JAX (each rank process imports this module to find its job)."""
import torch

from repro_torch.dist import exchange as ex_mod
from repro_torch.dist.sharding import Mesh, use_mesh_rules
from repro_torch.models import moe, moe_a2a


def moe_layer(ctx, shape: dict, cfg, p: dict, x: torch.Tensor) -> tuple:
    """``apply_moe`` on this rank of a ``shape`` mesh: its block of the
    global ``x`` and its slices of the global weights ``p``.  Returns
    (the output block as fp32, the aux loss, this rank's coordinates)."""
    mesh = Mesh.build(shape, ctx.rank)
    with use_mesh_rules(mesh):
        y, aux = moe.apply_moe(moe_a2a.rank_weights(p, cfg, mesh), cfg,
                               moe_a2a.rank_block(x, mesh))
    return y.float(), float(aux), mesh.coords


def mesh_groups(ctx, shape: dict) -> tuple:
    """This rank's coordinates on a ``shape`` mesh, and for each set of
    axes the ranks an all-gather over its group returns, in order."""
    mesh = Mesh.build(shape, ctx.rank)
    me = torch.tensor([ctx.rank])
    return mesh.coords, {",".join(axes): ex_mod.all_gather(
        me, group).tolist() for axes, group in mesh.groups.items()}
