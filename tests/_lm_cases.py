"""Shared by the LM parity tests (``test_torch_lm*.py``): conversions
between the packages, the JAX side jitted once per config, the weights
carried across, and the bf16 near-tie rules of ``tests/test_serve.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

GAP = 0.15  # a bf16 near tie (tests/test_serve.py)

# jitted once per config and shape (the config is static), as the JAX
# package's tests run the model
J_INIT = jax.jit(lambda key, cfg: JL.split_params(JT.init_lm(key, cfg))[0],
                 static_argnums=1)
J_ATTN = jax.jit(JA.attention_layer, static_argnames=("cfg", "mode"))
J_FWD = jax.jit(lambda p, cfg, t, mode, c: JT.forward(
    p, cfg, t, mode=mode, caches=c)[:2], static_argnums=(1, 3))


def f32(a) -> np.ndarray:
    """A JAX array or a torch tensor as fp32 numpy."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def tt(a) -> torch.Tensor:
    return T._tensor(np.asarray(a))


def rel_err(j, t) -> float:
    j, t = f32(j), f32(t)
    return float(np.abs(j - t).max() / np.abs(j).max())


def carried(arch="qwen3-4b", seed=0, **kw):
    """(jax cfg, port cfg, jax params, port model) for ``arch`` reduced."""
    cfg = dataclasses.replace(jget(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    params = J_INIT(jax.random.PRNGKey(seed), cfg)
    model = T.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                "cpu")
    return cfg, tcfg, params, model


def port_logits(model, cfg):
    """Tokens [B, S] -> the port's full-forward logits [B, S, V] (fp32)."""
    def fn(tokens):
        return f32(T.forward(model, cfg, torch.as_tensor(tokens))[0])
    return fn


def jax_logits(params, cfg):
    def fn(tokens):
        return f32(J_FWD(params, cfg, jnp.asarray(tokens), "train", None)[0])
    return fn


def teacher_forced(logits_fn, out: np.ndarray, S: int) -> None:
    """``tests/test_serve.py``'s rule: each generated token of ``out``
    [B, S + new] is the full forward's argmax on the generated prefix, or
    within ``GAP`` of it (a bf16 near tie); at least 75% are the argmax."""
    B, new = out.shape[0], out.shape[1] - S
    matches = 0
    for t in range(new):
        last = logits_fn(out[:, :S + t])[:, -1]
        for b in range(B):
            got, best = int(out[b, S + t]), int(last[b].argmax())
            if got == best:
                matches += 1
            else:
                assert last[b, best] - last[b, got] < GAP, (t, b)
    assert matches >= 0.75 * new * B, matches


def same_or_near_tie(logits_fn, a: np.ndarray, b: np.ndarray,
                     S: int) -> int:
    """Two decodes of the same prompts [B, S + new]: equal, or at each
    row's first difference the full forward on the common prefix puts
    the two tokens within ``GAP``.  Returns the rows that are equal."""
    assert a.shape == b.shape
    equal = 0
    for r in range(a.shape[0]):
        diff = np.flatnonzero(a[r] != b[r])
        if diff.size == 0:
            equal += 1
            continue
        i = int(diff[0])
        assert i >= S, "the prompts differ"
        last = logits_fn(a[r:r + 1, :i])[0, -1]
        assert abs(last[a[r, i]] - last[b[r, i]]) < GAP, (r, i)
    return equal
