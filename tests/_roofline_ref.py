"""The JAX package's side of the roofline and dry-run parity tests, in
this process (``JAX_PLATFORMS=cpu``): the reference's probes on a
one-device mesh, the product FLOPs of a traced function's jaxpr, and the
dry-run module imported without its import-time device count."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh


def jax_dryrun():
    """``repro.launch.dryrun``: importing it sets ``XLA_FLAGS`` to 512
    placeholder devices for the process.  Here jax's backend starts first
    (one CPU device) and the variable is put back, so neither this process
    nor a subprocess it starts later sees the 512 devices."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for item in (v if isinstance(v, (list, tuple)) else (v,)):
            if hasattr(item, "jaxpr") and hasattr(item, "consts"):
                yield item.jaxpr
            elif hasattr(item, "eqns"):
                yield item


def jaxpr_products(jaxpr) -> tuple[int, int]:
    """2 x output elements x contracted size of every ``dot_general`` in
    a jaxpr, a scan's body times its length: the products the traced
    function asks for, before XLA's optimisation removes any.  Returns
    (the matrix products: a contracted dim and a free dim on each side;
    the rest: outer products, with nothing contracted, and batched dot
    products, with a side that has no free dim, which ``torch.einsum``
    computes as broadcast multiplies and sums)."""
    total, outer = 0, 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            rhs = eqn.invars[1].aval.shape
            f = 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(
                lhs[i] for i in lc)
            if lc and len(lhs) > len(lc) + len(lb) \
                    and len(rhs) > len(rc) + len(rb):
                total += f
            else:
                outer += f
        reps = eqn.params.get("length", 1) if eqn.primitive.name == "scan" \
            else 1
        for sub in _sub_jaxprs(eqn):
            t, o = jaxpr_products(sub)
            total, outer = total + reps * t, outer + reps * o
    return total, outer


def train_layer_products(cfg, B, S, kind, window, d_ff) -> int:
    """The products of the reference's ``probe_train_layer`` function."""
    from repro.models import transformer as tm
    from repro.models.layers import split_params
    from repro.roofline import probes
    shapes = jax.eval_shape(lambda: split_params(
        tm.init_block(jax.random.PRNGKey(0), cfg, kind, d_ff))[0])
    x = jax.ShapeDtypeStruct((B, S, cfg.d_model), jnp.bfloat16)
    positions = jnp.broadcast_to(jnp.arange(S)[None, :], (B, S))

    def f(p, x):
        out, _, aux = tm.apply_block(p, cfg, kind, x, positions, window,
                                     "train", tm.LayerCache(None, None))
        return jnp.sum(out.astype(jnp.float32)) + aux

    with probes._unrolled():
        jx = jax.make_jaxpr(jax.grad(f, argnums=(0, 1)))(shapes, x)
    return jaxpr_products(jx.jaxpr)


def dec_layer_products(cfg, B, S) -> int:
    """The products of the reference's ``_probe_dec_layer_train``."""
    from repro.models import encdec
    from repro.models.layers import split_params
    from repro.roofline import probes
    shapes = jax.eval_shape(lambda: split_params(
        encdec._init_dec_layer(jax.random.PRNGKey(0), cfg))[0])
    x = jax.ShapeDtypeStruct((B, S, cfg.d_model), jnp.bfloat16)
    e = jax.ShapeDtypeStruct((B, cfg.enc_seq, cfg.d_model), jnp.bfloat16)
    positions = jnp.broadcast_to(jnp.arange(S)[None, :], (B, S))

    def f(p, x, enc):
        out, _ = encdec._dec_layer(p, cfg, x, positions, enc, None, "train")
        return jnp.sum(out.astype(jnp.float32))

    with probes._unrolled():
        jx = jax.make_jaxpr(jax.grad(f, argnums=(0, 1, 2)))(shapes, x, e)
    return jaxpr_products(jx.jaxpr)


def embed_loss_products(cfg, B, S) -> int:
    """The products of the reference's ``probe_embed_loss(with_grad=True)``."""
    from repro.models.layers import chunked_softmax_xent, rms_norm
    from repro.roofline import probes
    V, D = cfg.vocab_size, cfg.d_model
    p = {"embed": jax.ShapeDtypeStruct((V, D), jnp.bfloat16),
         "final_norm": jax.ShapeDtypeStruct((D,), jnp.bfloat16)}
    if not cfg.tie_embeddings and not cfg.encdec:
        p["head"] = jax.ShapeDtypeStruct((D, V), jnp.bfloat16)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)

    def f(p, tokens, labels):
        h = jnp.take(p["embed"], tokens, axis=0)
        hn = rms_norm(h, p["final_norm"], cfg.norm_eps)
        head = p["embed"].T if ("head" not in p) else p["head"]
        return chunked_softmax_xent(hn, head, labels)

    with probes._unrolled():
        jx = jax.make_jaxpr(jax.grad(f))(p, tok, tok)
    return jaxpr_products(jx.jaxpr)
