"""The JAX package's side of ``tests/test_torch_moe_a2a.py``: its
``apply_moe`` under ``("data", "model")`` meshes of CPU devices (the
``shard_map`` all-to-all path when the model axis divides the experts,
GSPMD's grouped dispatch when it does not), each case's output, aux and
gradients into one ``.npz``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_moe_jax_ref.py IN.npz OUT.npz

``IN.npz`` holds, for case ``i``, ``shape{i}`` (the mesh's two sizes),
and ``x{i}`` and the layer's leaves ``{leaf}{i}`` as bf16 bits (uint16),
and ``ct{i}`` (fp32), the cotangent of the output.  The gradients are
``jax.grad`` of ``sum(y * ct) + aux`` with respect to the leaves and x,
``g_{leaf}{i}`` and ``g_x{i}`` as fp32.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_config
from repro.dist.sharding import use_mesh_rules
from repro.models import moe

LEAVES = ("router", "w_in", "w_gate", "w_out")


def main(src: str, dst: str) -> None:
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    out = {}
    with np.load(src) as f:
        cases = {k: f[k] for k in f.files}
    i = 0
    while f"shape{i}" in cases:
        def bf16(name):
            return jnp.asarray(cases[f"{name}{i}"]).view(jnp.bfloat16)
        d, m = (int(v) for v in cases[f"shape{i}"])
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))
        p = {name: bf16(name) for name in LEAVES}
        ct = jnp.asarray(cases[f"ct{i}"])

        def loss(p, x):
            y, aux = moe.apply_moe(p, cfg, x)
            return jnp.sum(y.astype(jnp.float32) * ct) + aux
        with use_mesh_rules(mesh):
            y, aux = jax.jit(lambda p, x: moe.apply_moe(p, cfg, x))(
                p, bf16("x"))
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, bf16("x"))
        out[f"y{i}"] = np.asarray(y.astype(jnp.float32))
        out[f"aux{i}"] = np.asarray(aux)
        out[f"g_x{i}"] = np.asarray(gx.astype(jnp.float32))
        for name in LEAVES:
            out[f"g_{name}{i}"] = np.asarray(gp[name].astype(jnp.float32))
        i += 1
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
