"""The JAX package's side of ``tests/test_torch_ssm.py``'s multi-rank
cases: ``_ssd_seq_parallel_call`` and ``apply_ssm`` (train mode, whose
SSD then runs sequence-parallel) under ``("data", "model")`` meshes of 4
CPU devices, each case's output and gradients into one ``.npz``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_ssm_jax_ref.py IN.npz OUT.npz

``IN.npz`` holds, for SSD case ``i``, ``ssd_shape{i}``, the fp32 inputs
``ssd_{x,dt,a,B,C}{i}``, ``ssd_chunk{i}`` and the output's cotangent
``ssd_ct{i}``; for the layer case, ``layer_shape``, the reduced mamba2
layer's leaves ``layer_{leaf}`` (bf16 as uint16 bits, fp32 as they are),
``layer_u`` (bf16 bits) and ``layer_ct``.  The gradients are ``jax.grad``
of ``sum(y * ct)``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_config
from repro.dist.sharding import use_mesh_rules
from repro.models import ssm

SSD_ARGS = ("x", "dt", "a", "B", "C")


def _mesh(shape) -> Mesh:
    d, m = (int(v) for v in shape)
    return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))


def main(src: str, dst: str) -> None:
    out = {}
    with np.load(src) as f:
        cases = {k: f[k] for k in f.files}
    i = 0
    while f"ssd_shape{i}" in cases:
        mesh = _mesh(cases[f"ssd_shape{i}"])
        args = [jnp.asarray(cases[f"ssd_{n}{i}"]) for n in SSD_ARGS]
        chunk = int(cases[f"ssd_chunk{i}"])
        ct = jnp.asarray(cases[f"ssd_ct{i}"])

        def call(*a):
            return ssm._ssd_seq_parallel_call(*a, chunk, mesh)
        y = jax.jit(call)(*args)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(call(*a) * ct),
                                 argnums=tuple(range(5))))(*args)
        out[f"ssd_y{i}"] = np.asarray(y)
        for n, g in zip(SSD_ARGS, grads):
            out[f"ssd_g_{n}{i}"] = np.asarray(g)
        i += 1
    if "layer_shape" in cases:
        cfg = get_config("mamba2-780m").reduced()
        mesh = _mesh(cases["layer_shape"])

        def leaf(k):
            v = jnp.asarray(cases[k])
            return v.view(jnp.bfloat16) if v.dtype == jnp.uint16 else v
        p = {k[len("layer_p_"):]: leaf(k) for k in cases
             if k.startswith("layer_p_")}
        u, ct = leaf("layer_u"), jnp.asarray(cases["layer_ct"])

        def layer(p, u):
            return ssm.apply_ssm(p, cfg, u, mode="train")[0]
        with use_mesh_rules(mesh):
            y = jax.jit(layer)(p, u)
            gp, gu = jax.jit(jax.grad(lambda p, u: jnp.sum(
                layer(p, u).astype(jnp.float32) * ct), argnums=(0, 1)))(p, u)
        out["layer_y"] = np.asarray(y.astype(jnp.float32))
        out["layer_g_u"] = np.asarray(gu.astype(jnp.float32))
        for k, g in gp.items():
            out[f"layer_g_{k}"] = np.asarray(g.astype(jnp.float32))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
