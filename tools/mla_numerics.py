"""Numerics of the MLA/MTP and encoder-decoder port on the CPU, the numbers
its tolerances and notes rest on.

    PYTHONPATH=src:. python tools/mla_numerics.py [--recipe]

Prints one JSON line with:

  * ``absorbed_vs_materialised``: one deepseek-v3 MLA layer at full width
    (random weights of seeds 0-2), 16 tokens prefilled then 8 absorbed
    decode steps, each step's output against the train path's over all 24
    tokens, the largest difference of max|y| (``chip_smoke.py``'s
    ``MLA_ABSORB_TOL`` rests on it);
  * ``sinusoidal``: whisper's 1,500 x 1,024 table against the jitted
    reference's (when the JAX package is importable): entries that differ
    in float32, the largest difference, and entries that differ once
    rounded to bf16;
  * ``recipe`` (with ``--recipe``; minutes): 10 Adafactor steps of the
    train launcher's recipe (lr 3e-4, warm-up 1 of 10, batch 4 x 64) on
    a deepseek of width 7168 and small other dims (8 heads, 32 experts
    top-8, d_ff 128, 3 dense layers of 2048 and one MoE layer, vocabulary
    4096), the JAX package's losses beside the port's from the same
    weights, at lr 3e-4 and 1e-5.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import pipeline as DP
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as TO
from repro_torch.train import trainer as TR

WIDE = dict(d_model=7168, num_heads=8, num_kv_heads=8, q_lora_rank=256,
            kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32, num_experts=32, experts_per_token=8, d_ff=128,
            dense_d_ff=2048, vocab_size=4096, num_layers=4,
            first_k_dense=3, max_position=512)


def absorbed_vs_materialised() -> float:
    cfg = get_config("deepseek-v3-671b")
    worst = 0.0
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        p = TA.init_attention(gen, cfg, "cpu")
        S, P = 24, 16
        x = torch.randn(1, S, cfg.d_model, generator=gen).to(torch.bfloat16)
        pos = torch.arange(S)[None]
        full, _ = TA.attention_layer(p, cfg, x, pos)
        c = TA.init_kv_cache(cfg, 1, S, "cpu")
        _, c = TA.attention_layer(p, cfg, x[:, :P], pos[:, :P], cache=c,
                                  mode="prefill")
        scale = full[:, P:].float().abs().max()
        for t in range(P, S):
            o, c = TA.attention_layer(p, cfg, x[:, t:t + 1], pos[:, t:t + 1],
                                      cache=c, mode="decode")
            worst = max(worst, float((o.float() - full[:, t:t + 1].float())
                                     .abs().max() / scale))
    return worst


def sinusoidal() -> dict:
    try:
        import jax
        import jax.numpy as jnp
        from repro.models import layers as JL
    except ImportError:
        return {"jax_package": "not importable"}
    j = np.asarray(jax.jit(JL.sinusoidal_positions, static_argnums=(0, 1))(
        1500, 1024))
    t = TL.sinusoidal_positions(1500, 1024)
    jb = np.asarray(jnp.asarray(j).astype(jnp.bfloat16).astype(jnp.float32))
    tb = t.to(torch.bfloat16).float().numpy()
    return {"float32_differ": int((j != t.numpy()).sum()),
            "entries": int(j.size),
            "max_abs_diff": float(np.abs(j - t.numpy()).max()),
            "bf16_differ": int((jb != tb).sum())}


def recipe(lr: float) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro.train import optimizer as JO
    from repro.train import trainer as JTR
    cfg = dataclasses.replace(jget("deepseek-v3-671b").reduced(), **WIDE)
    tcfg = dataclasses.replace(get_config("deepseek-v3-671b").reduced(),
                               **WIDE)
    params = jax.jit(lambda k: JL.split_params(JT.init_lm(k, cfg))[0])(
        jax.random.PRNGKey(0))
    model = T.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    jstep = jax.jit(JTR.make_train_step(
        cfg, schedule=JO.cosine_schedule(lr, 1, 10)))
    tstep = TR.make_train_step(tcfg, schedule=TO.cosine_schedule(lr, 1, 10))
    js = JTR.TrainState(params, JO.Adafactor().init(params),
                        jnp.zeros((), jnp.int32))
    ts = TR.TrainState(model, TO.Adafactor().init(T.param_dict(model)),
                       torch.zeros((), dtype=torch.int32))
    pipe = DP.DataPipeline(DP.SyntheticSource(cfg.vocab_size, 64), 4)
    out = {"jax": [], "port": []}
    for _ in range(10):
        b = pipe.next_batch()
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        out["jax"].append(float(jm["loss"]))
        out["port"].append(float(tm["loss"]))
    return out


def main() -> None:
    out = {"absorbed_vs_materialised": absorbed_vs_materialised(),
           "sinusoidal": sinusoidal()}
    if "--recipe" in sys.argv:
        out["recipe"] = {str(lr): recipe(lr) for lr in (3e-4, 1e-5)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
