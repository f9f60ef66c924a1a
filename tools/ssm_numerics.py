"""Numerics of the SSM port on the CPU, the numbers its tolerances and
notes rest on.

    PYTHONPATH=src:. python tools/ssm_numerics.py

Prints one JSON line with:

  * ``xla_exp_log1p``: how many of 400,000 float32 draws (-|N(0, 8)| for
    ``exp``, ``exp`` of those for ``log1p``) torch's ``exp``/``log1p``
    give other bits than XLA's jitted ones, and how many the port's
    spelled-out ``_xla_exp``/``_xla_log1p`` do (when the JAX package is
    importable);
  * ``decode_drift``: the largest difference, of max|logit|, between the
    greedy decode's logits along 16 + 11 tokens and one full forward's,
    for mamba2 at 48 layers and hymba at 32 (the reduced widths): the
    port's in bf16 and in fp32 (fp32 weights and caches), and the JAX
    package's in bf16 (when importable);
  * ``scan_vs_recurrence``: the chunked scan (bf16 x, B, C) against the
    fp32 sequential recurrence, of max|y|, at both archs' full widths, 512
    tokens, ``chip_smoke.ssd_seq_inputs``' draws, seeds 0-2.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

import chip_smoke as CS
from repro_torch.configs import get_config
from repro_torch.models import ssm as TM
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE

ARCHS = (("mamba2-780m", 48), ("hymba-1.5b", 32))


def _jax():
    try:
        import jax  # noqa: F401
    except ImportError:
        return None
    return jax


def xla_exp_log1p() -> dict:
    rng = np.random.default_rng(0)
    x = -np.abs(rng.standard_normal(400000) * 8).astype(np.float32)
    e = np.exp(x.astype(np.float64)).astype(np.float32)
    tx, te = torch.from_numpy(x), torch.from_numpy(e)
    out = {}
    jax = _jax()
    if jax is None:
        return {"jax_package": "not importable"}
    import jax.numpy as jnp
    je = np.asarray(jax.jit(jnp.exp)(x))
    jl = np.asarray(jax.jit(jnp.log1p)(e))
    out["exp_torch_differs"] = int((torch.exp(tx).numpy() != je).sum())
    out["exp_port_differs"] = int((TM._xla_exp(tx).numpy() != je).sum())
    out["log1p_torch_differs"] = int((torch.log1p(te).numpy() != jl).sum())
    out["log1p_port_differs"] = int((TM._xla_log1p(te).numpy() != jl).sum())
    return out


def _port_drift(cfg, prompt, got, fp32: bool) -> float:
    model = T.init_lm(cfg, 0, "cpu")
    if not fp32:
        return CS.ssm_decode_vs_forward(np, torch, T, SE, model, cfg,
                                        prompt, got)["rel_err"]
    model.float()
    with CS.Fp32Caches(torch, T):
        return CS.ssm_decode_vs_forward(np, torch, T, SE, model, cfg,
                                        prompt, got)["rel_err"]


def _jax_drift(arch, layers, prompt, got):
    jax = _jax()
    if jax is None:
        return "not importable"
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import transformer as JT
    from repro.models.layers import split_params
    from repro.serve import engine as JE
    cfg = dataclasses.replace(jget(arch).reduced(), num_layers=layers)
    params, _ = split_params(JT.init_lm(jax.random.PRNGKey(0), cfg))
    row = np.concatenate([prompt, got[:-1]]).astype(np.int32)
    fwd = np.asarray(jax.jit(lambda p, t: JT.forward(p, cfg, t)[0])(
        params, row[None])[0, len(prompt) - 1:], np.float32)
    caches = JE.init_caches(cfg, 1, len(prompt) + len(got))
    prefill = jax.jit(JE.make_prefill_step(cfg))
    decode = jax.jit(JE.make_decode_step(cfg))
    logits, caches = prefill(params, {"tokens": jnp.asarray(
        prompt[None].astype(np.int32))}, caches)
    dec = [np.asarray(logits[0, -1], np.float32)]
    for tok in got[:-1]:
        logits, caches = decode(params, jnp.asarray([[int(tok)]]), caches)
        dec.append(np.asarray(logits[0, -1], np.float32))
    return float(np.abs(np.stack(dec) - fwd).max() / np.abs(fwd).max())


def decode_drift() -> dict:
    out = {}
    for arch, layers in ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  num_layers=layers)
        rng = np.random.default_rng(0)
        prompt = rng.integers(0, cfg.vocab_size, 16)
        got = rng.integers(0, cfg.vocab_size, 12)
        out[f"{arch}/{layers}"] = {
            "port_bf16": _port_drift(cfg, prompt, got, False),
            "port_fp32": _port_drift(cfg, prompt, got, True),
            "jax_package_bf16": _jax_drift(arch, layers, prompt, got)}
    return out


def scan_vs_recurrence() -> dict:
    out = {}
    for arch, _ in ARCHS:
        cfg = get_config(arch)
        errs = []
        for seed in range(3):
            CS.SSM_SEQ_SEED, CS.SSM_SEQ_LEN = seed, 512
            (xs, dt, a, B, C), _ = CS.ssd_seq_inputs(torch, TM, cfg,
                                                     torch.device("cpu"))
            y, _ = TM.ssd_chunked(xs, dt, a, B, C, cfg.ssm_chunk)
            ref = CS.ssm_recurrence(torch, xs, dt, a, B, C)
            errs.append(float((y.float() - ref).abs().max()
                              / ref.abs().max()))
        out[arch] = errs
    return out


def main() -> None:
    print(json.dumps({"xla_exp_log1p": xla_exp_log1p(),
                      "decode_drift": decode_drift(),
                      "scan_vs_recurrence": scan_vs_recurrence()}))


if __name__ == "__main__":
    main()
