"""Port parity for the LM: configs, layers, GQA attention (dense, decode
over a cache, flash prefill, the blocked sliding window and its ring
cache) and the transformer's ``forward`` (dense, SSM and hybrid).

The same seeded inputs go through the JAX package (jitted, on the CPU)
and the port (``device="cpu"``); the weights are the JAX package's
``init_lm`` carried across by ``params_from_numpy``.  bf16 outputs are
compared in fp32, logits against ``max|logit|``.

Each tolerance is the largest difference seen over seeds 0-4 (noted
beside it) with at most 4x headroom.  They are not 0 because XLA keeps
excess precision inside a fusion (``xla_allow_excess_precision``, on by
default): it skips some bf16 roundings that the jnp ops define and the
port performs.  With that flag off, the logits agree to within one bf16
ulp on a few entries and are bitwise equal on most.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs as jlist  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

from _lm_cases import J_ATTN, J_FWD, carried, f32, rel_err, tt  # noqa: E402

SEEDS = range(5)
DENSE = ["qwen3-4b", "glm4-9b", "chatglm3-6b", "granite-20b", "chameleon-34b"]
# the MoE family: test_torch_moe.py; the SSD layer: test_torch_ssm.py;
# MLA and MTP: test_torch_mla.py; the encoder-decoder: test_torch_encdec.py
PORTED = DENSE + ["phi3.5-moe-42b-a6.6b", "mamba2-780m", "hymba-1.5b",
                  "deepseek-v3-671b"]
ENCDEC = "whisper-medium"


def bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


# ---------------------------------------------------------------- configs
def test_configs_equal_field_for_field():
    assert list_archs() == jlist()
    for arch in list_archs():
        c, j = get_config(arch), jget(arch)
        assert dataclasses.asdict(c) == dataclasses.asdict(j), arch
        assert dataclasses.asdict(c.reduced()) == dataclasses.asdict(
            j.reduced()), arch
        assert c.param_count() == j.param_count(), arch
        assert c.active_param_count() == j.active_param_count(), arch
        assert ({k: dataclasses.asdict(v) for k, v in c.shapes().items()}
                == {k: dataclasses.asdict(v) for k, v in j.shapes().items()})
        for p in ("gated_mlp", "is_moe", "d_inner", "ssm_heads",
                  "supports_long_context"):
            assert getattr(c, p) == getattr(j, p), (arch, p)
    for alias in ("qwen3", "glm4", "granite", "chameleon", "chatglm3"):
        assert get_config(alias) == get_config(jget(alias).name)
    assert get_config("qwen3-4b").param_count() == 4_022_272_000


@pytest.mark.parametrize("arch", PORTED + [ENCDEC])
def test_build_plan_matches_jax(arch):
    """Every stack of the plan (deepseek: 3 dense layers, then 58 MoE
    layers stacked) at full and reduced size; the encoder-decoder's
    ``init_encdec`` stacks every encoder and decoder leaf ``[L, ...]`` as
    the reference's ``stack_params`` does."""
    for cfg in (get_config(arch), get_config(arch).reduced()):
        jcfg = jget(arch) if cfg.num_layers > 2 else jget(arch).reduced()
        if cfg.encdec:
            tree = jax.eval_shape(lambda k: JL.split_params(
                JED.init_encdec(k, jcfg))[0], jax.random.PRNGKey(0))
            model = TED.init_encdec(cfg, device="meta")
            for name, n in (("encoder", cfg.enc_layers),
                            ("decoder", cfg.num_layers)):
                assert len(getattr(model, name)) == n
                assert all(v.shape[0] == n for v in jax.tree.leaves(
                    tree[name]))
            continue
        jsps = JT.build_plan(jcfg).stacks
        sps = T.build_plan(cfg).stacks
        assert len(sps) == len(jsps) == (2 if cfg.first_k_dense else 1)
        for sp, jsp in zip(sps, jsps):
            assert (sp.kind, sp.n, sp.windows, sp.scan, sp.d_ff) == (
                jsp.kind, jsp.n, jsp.windows, jsp.scan, jsp.d_ff)


def _jax_leaves(cfg) -> dict:
    """The reference's parameter leaves, keyed by the port's names
    (``T.from_tree``), as (shape, dtype), without allocating."""
    init = JED.init_encdec if cfg.encdec else JT.init_lm
    tree = jax.eval_shape(lambda k: JL.split_params(init(k, cfg))[0],
                          jax.random.PRNGKey(0))
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in T.from_tree(tree).items()}


@pytest.mark.parametrize("arch", PORTED + [ENCDEC])
def test_meta_init_has_reference_shapes(arch):
    """The port's parameters are the reference's leaves, name for name:
    a scan stack's ``[L, ...]`` leaves stacked as there, bf16 matrices and
    fp32 norm scales (deepseek's MTP head and MLA leaves, whisper's
    ``init_encdec`` tree among them)."""
    cfg = get_config(arch)
    init = TED.init_encdec if cfg.encdec else T.init_lm
    named = T.param_dict(init(cfg, device="meta"))
    assert all(t.is_meta for t in named.values())
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in named.items()} == _jax_leaves(jget(arch))
    norms = sum(t.numel() for t in named.values() if t.dtype == torch.float32)
    matrices = sum(t.numel() for t in named.values()) - norms
    if cfg.ssm_state:  # the reference's count takes the conv over d_inner
        # channels (its leaf has d_inner + 2 N) and A, D as 2 H (fp32 here)
        conv = cfg.num_layers * cfg.ssm_conv_width * 2 * cfg.ssm_state
        matrices += 2 * cfg.num_layers * cfg.ssm_heads - conv
    if cfg.mtp_depth:  # the reference counts the MTP block's MLP at d_ff;
        # its leaves are dense_d_ff wide
        matrices -= cfg.mtp_depth * 3 * cfg.d_model * (cfg.dense_d_ff
                                                       - cfg.d_ff)
    if cfg.encdec:  # the reference's count leaves out the learned dec_pos
        # and counts a head beside the embedding (encdec ties the two)
        matrices -= cfg.max_position * cfg.d_model
        matrices += cfg.vocab_size * cfg.d_model * (not cfg.tie_embeddings)
    assert matrices == cfg.param_count()


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("seed", SEEDS)
def test_rms_norm(seed):
    rng = np.random.default_rng(seed)
    x = bf16(rng, (2, 16, 64), 3.0)
    scale = jnp.asarray(rng.uniform(0.5, 1.5, 64), jnp.float32)
    j = jax.jit(JL.rms_norm)(x, scale)
    t = TL.rms_norm(tt(x), tt(scale))
    assert t.dtype == torch.bfloat16
    # seeds 0-4: bitwise equal
    assert np.array_equal(f32(j), f32(t))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_apply_rope(seed, fraction):
    rng = np.random.default_rng(seed)
    x = bf16(rng, (2, 24, 4, 16))
    pos = rng.integers(0, 4096, (2, 24)).astype(np.int32)
    j = jax.jit(lambda a, p: JL.apply_rope(a, p, fraction=fraction,
                                           theta=1e6))(x, pos)
    t = TL.apply_rope(tt(x), torch.from_numpy(pos), fraction=fraction,
                      theta=1e6)
    # seeds 0-4: at most 0.0078 (one bf16 ulp at 1 <= |x| < 2), few entries
    assert np.abs(f32(j) - f32(t)).max() <= 0.03125
    if fraction < 1:  # the dims past the rotated half pass through
        assert np.array_equal(f32(t)[..., 8:], f32(x)[..., 8:])
    xt = tt(x)
    assert TL.apply_rope(xt, torch.from_numpy(pos), theta=0.0) is xt


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("seed", SEEDS)
def test_apply_mlp(seed, act):
    rng = np.random.default_rng(seed)
    p = {"w_in": bf16(rng, (64, 128), 0.125),
         "w_out": bf16(rng, (128, 64), 0.088)}
    if act == "silu":
        p["w_gate"] = bf16(rng, (64, 128), 0.125)
    x = bf16(rng, (2, 16, 64))
    j = jax.jit(lambda p, x: JL.apply_mlp(p, x, act))(p, x)
    t = TL.apply_mlp({k: tt(v) for k, v in p.items()}, tt(x), act)
    # the activations are the jnp ops one by one; seeds 0-4: bitwise equal
    # but for one entry of seed 1 (silu), 4.9e-8 of max|out|
    assert rel_err(j, t) <= 1.9e-7


# -------------------------------------------------------------- attention
def _attn_case(seed, S):
    cfg, tcfg, params, model = carried("qwen3-4b", seed)
    p = params["stacks"][0][0]["attn"]
    tp = model.stacks[0][0].attn
    rng = np.random.default_rng(seed)
    x = bf16(rng, (2, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    return cfg, tcfg, p, tp, x, pos


@pytest.mark.parametrize("seed", SEEDS)
def test_attention_prefill_and_decode(seed):
    S, s_max = 16, 24
    cfg, tcfg, p, tp, x, pos = _attn_case(seed, S + 1)
    jc = JA.init_kv_cache(cfg, 2, s_max)
    tc = TA.init_kv_cache(tcfg, 2, s_max, "cpu")
    jout, jc = J_ATTN(p, cfg, x[:, :S], pos[:, :S], cache=jc,
                      mode="prefill")
    tout, tc = TA.attention_layer(tp, tcfg, tt(x[:, :S]),
                                  torch.from_numpy(pos[:, :S].copy()),
                                  cache=tc, mode="prefill")
    # seeds 0-4: at most 5.6e-4 of max|out| (dense causal path, S = 16)
    assert rel_err(jout, tout) <= 2.2e-3
    assert int(tc.pos) == int(jc.pos) == S
    for a, b in ((jc.k, tc.k), (jc.v, tc.v)):  # seeds 0-4: bitwise equal
        assert np.array_equal(f32(a), f32(b))
    step_pos = pos[:, S:]
    jout, jc = J_ATTN(p, cfg, x[:, S:], step_pos, cache=jc, mode="decode")
    tout, tc = TA.attention_layer(tp, tcfg, tt(x[:, S:]),
                                  torch.from_numpy(step_pos.copy()),
                                  cache=tc, mode="decode")
    # seeds 0-4: bitwise equal, the output and the written K/V
    assert np.array_equal(f32(jout), f32(tout))
    assert int(tc.pos) == int(jc.pos) == S + 1
    assert np.array_equal(f32(jc.k), f32(tc.k))
    assert np.array_equal(f32(jc.v), f32(tc.v))


@pytest.mark.parametrize("seed", [0, 1])
def test_flash_path_matches_jax_and_dense(seed):
    """S = 2,304 > FLASH_THRESHOLD: both packages take the flash path;
    the port's flash equals its dense path on the same q, k, v."""
    S = 2304
    assert S > TA.FLASH_THRESHOLD == JA.FLASH_THRESHOLD
    cfg, tcfg, p, tp, x, pos = _attn_case(seed, S)
    jout, _ = J_ATTN(p, cfg, x, pos, mode="train")
    tout, _ = TA.attention_layer(tp, tcfg, tt(x), torch.from_numpy(pos.copy()))
    # seeds 0-4: at most 7.9e-4 of max|out|
    assert rel_err(jout, tout) <= 3.0e-3
    rng = np.random.default_rng(seed)
    q = tt(bf16(rng, (1, S, 4, 16)))
    k, v = tt(bf16(rng, (1, S, 2, 16))), tt(bf16(rng, (1, S, 2, 16)))
    flash = TA.flash_attention(q, k, v)
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool))
    dense = TA.dense_attention(q, k, v, causal[None, None, None])
    # seeds 0-4: at most 6.1e-3 of max|out| (the online softmax's other
    # rounding of p and of the sums)
    assert rel_err(dense, flash) <= 2.4e-2
    jflash = jax.jit(lambda q, k, v: JA.flash_attention(q, k, v, causal=True))(
        *(jnp.asarray(f32(a), jnp.bfloat16) for a in (q, k, v)))
    # seeds 0-4: at most 2.4e-4 of max|out|
    assert rel_err(jflash, flash) <= 9.6e-4


# --------------------------------------------------------- sliding window
J_SWA_ATTN = jax.jit(JA.attention_layer,
                     static_argnames=("cfg", "mode", "layer_window"))


@pytest.mark.parametrize("S,window", [(600, 200), (40, 32)])
@pytest.mark.parametrize("seed", [0, 1])
def test_swa_attention_blocked_matches_jax(seed, S, window):
    """S > window: query tiles of 256 (S = 600: three, the last padded)
    over W + 256 keys against the JAX function, and against the port's
    dense path under the window's mask (seeds 0-4: within 2.8e-4 and
    3.2e-7 of max|out|; S = 40, one tile, bitwise)."""
    rng = np.random.default_rng(seed)
    q = bf16(rng, (1, S, 4, 16))
    k, v = bf16(rng, (1, S, 2, 16)), bf16(rng, (1, S, 2, 16))
    j = jax.jit(JA.swa_attention_blocked, static_argnums=3)(q, k, v, window)
    t = TA.swa_attention_blocked(tt(q), tt(k), tt(v), window)
    assert t.shape == (1, S, 4, 16) and t.dtype == torch.bfloat16
    assert rel_err(j, t) <= 1.1e-3
    pos = torch.arange(S)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :]
                                             < window)
    dense = TA.dense_attention(tt(q), tt(k), tt(v), mask[None, None, None])
    assert rel_err(dense, t) <= 1.3e-6


def _hymba_attn(seed):
    cfg, tcfg, params, model = carried("hymba-1.5b", seed, num_layers=4)
    assert T.build_plan(tcfg).stacks[0].windows[1] == tcfg.sliding_window
    return (cfg, tcfg, params["stacks"][0][1]["attn"],
            model.stacks[0][1].attn)


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_decode_per_row_positions_match_jax(seed):
    """Two rows prefilled alone to 40 and 23 tokens (a ring of 32: the
    first rolled, the second not yet full), written into one [2] cache
    and decoded 12 steps past the window at their own positions: each
    row's output and ring against the JAX layer decoding that row alone
    at its scalar position (seeds 0-4: bitwise)."""
    cfg, tcfg, p, tp = _hymba_attn(seed)
    W, s_max = tcfg.sliding_window, 64
    rng = np.random.default_rng(seed)
    lens = (40, 23)
    xs = [bf16(rng, (1, n + 12, cfg.d_model)) for n in lens]
    ring = TA.init_kv_cache(tcfg, 2, s_max, "cpu", window=W)
    assert ring.k.shape[1] == W
    ring = ring._replace(pos=torch.zeros(2, dtype=torch.int32))
    jcs = []
    for row, (n, x) in enumerate(zip(lens, xs)):
        pos = np.arange(n, dtype=np.int32)[None]
        jc = JA.init_kv_cache(cfg, 1, s_max, W)
        _, jc = J_SWA_ATTN(p, cfg, x[:, :n], pos, layer_window=W, cache=jc,
                           mode="prefill")
        _, one = TA.attention_layer(
            tp, tcfg, tt(x[:, :n]), torch.from_numpy(pos.copy()),
            layer_window=W, cache=TA.init_kv_cache(tcfg, 1, s_max, "cpu",
                                                  window=W), mode="prefill")
        assert np.array_equal(f32(jc.k), f32(one.k))
        ring.k[row], ring.v[row] = one.k[0], one.v[0]
        ring.pos[row] = one.pos
        jcs.append(jc)
    for step in range(12):
        xt = torch.cat([tt(x[:, n + step:n + step + 1])
                        for n, x in zip(lens, xs)])
        positions = ring.pos[:, None].clone()
        tout, ring = TA.attention_layer(tp, tcfg, xt, positions,
                                        layer_window=W, cache=ring,
                                        mode="decode")
        for row, (n, x) in enumerate(zip(lens, xs)):
            jout, jcs[row] = J_SWA_ATTN(
                p, cfg, x[:, n + step:n + step + 1],
                np.array([[n + step]], np.int32), layer_window=W,
                cache=jcs[row], mode="decode")
            assert np.array_equal(f32(jout[0]), f32(tout[row]))
            assert np.array_equal(f32(jcs[row].k[0]), f32(ring.k[row]))
            assert int(jcs[row].pos) == int(ring.pos[row])
    assert ring.pos.tolist() == [52, 35]


# ---------------------------------------------------------------- forward
FORWARD_CASES = [(a, {}) for a in DENSE] + [("qwen3-4b", {"num_layers": 8})]


@pytest.mark.parametrize("arch,kw", FORWARD_CASES,
                         ids=DENSE + ["qwen3-4b-8layers"])
def test_forward_logits_match_jax(arch, kw):
    """train and prefill logits, and the prefill caches, for each dense
    decoder arch reduced; 8 layers take the stacked layout."""
    B, S = 2, 16
    # of max|logit| and of max|K/V|; seeds 0-4, the logits and every
    # layer's K/V: at most 1.42e-2 with 2 layers, 2.61e-2 with 8
    tol = 1.0e-1 if kw else 5.0e-2
    cfg, tcfg, params, model = carried(arch, 0, **kw)
    assert T.build_plan(tcfg).stacks[0].scan == bool(kw)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, _ = J_FWD(params, cfg, tokens, "train", None)
    tl, _, aux, _ = T.forward(model, tcfg, torch.from_numpy(tokens))
    assert tl.dtype == torch.bfloat16 and float(aux) == 0.0
    assert rel_err(jl, tl) <= tol
    jc = JT.init_cache(cfg, B, S + 4)
    tc = T.init_cache(tcfg, B, S + 4, "cpu")
    jl, jc = J_FWD(params, cfg, tokens, "prefill", jc)
    tl, tc, _, _ = T.forward(model, tcfg, torch.from_numpy(tokens),
                             mode="prefill", caches=tc)
    assert rel_err(jl, tl) <= tol
    jleaves, tleaves = jax.tree.leaves(jc), list(_leaves(tc))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
        if a.ndim > 1:  # K/V
            assert rel_err(a, b) <= tol
        else:  # pos
            assert np.array_equal(np.asarray(a), b.numpy())


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif tree is not None:
        for x in tree:
            yield from _leaves(x)


SSM_FORWARD = [("mamba2-780m", {}), ("mamba2-780m", {"num_layers": 8}),
               ("hymba-1.5b", {}), ("hymba-1.5b", {"num_layers": 4})]


@pytest.mark.parametrize("arch,kw", SSM_FORWARD, ids=[
    "mamba2", "mamba2-8layers", "hymba", "hymba-4layers"])
def test_ssm_hybrid_forward_matches_jax(arch, kw):
    """The SSM and hybrid families reduced: train and prefill logits over
    40 tokens (hymba's window is 32: with 4 layers, layer 1 runs the
    blocked window and its ring keeps the last 32 keys, rolled), the
    prefill caches (a ring and 3 global K/V, SSD states, conv rows), and
    8 layers of mamba2 take the stacked layout (seeds 0-4: the logits
    within 6.4e-2 of max|logit|, every cache 5.0e-2 of its max, both at 4
    layers of hymba; 2.5e-2 and 1.8e-2 in the other cases)."""
    B, S = 2, 40
    cfg, tcfg, params, model = carried(arch, 0, **kw)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, _ = J_FWD(params, cfg, tokens, "train", None)
    tl, _, aux, _ = T.forward(model, tcfg, torch.from_numpy(tokens))
    assert tl.dtype == torch.bfloat16 and float(aux) == 0.0
    assert rel_err(jl, tl) <= 1.3e-1
    jc = JT.init_cache(cfg, B, S + 8)
    tc = T.init_cache(tcfg, B, S + 8, "cpu")
    jl, jc = J_FWD(params, cfg, tokens, "prefill", jc)
    tl, tc, _, _ = T.forward(model, tcfg, torch.from_numpy(tokens),
                             mode="prefill", caches=tc)
    assert rel_err(jl, tl) <= 1.3e-1
    jleaves, tleaves = jax.tree.leaves(jc), list(_leaves(tc))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
        if a.ndim > 1:  # K/V, SSD state, conv rows
            assert rel_err(a, b) <= 1.0e-1
        else:  # pos
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_silu_gradient_is_the_logistic_rule(dtype):
    """``act_fn("silu")``'s backward is ``lax.logistic``'s rule, as
    ``jax.grad`` of the jitted ``jax.nn.silu`` computes it, and stays
    finite where ``exp(-x)`` overflows (x < -88.7; autograd through the
    forward's ops gave NaN there).  Against ``jax.vjp``: bf16 within
    2.2e-37 (subnormal cotangents), fp32 within 2.4e-7 (seed 0)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4000) * 40.0,
                        [-100.0, -89.0, 0.0, 89.0, 100.0]])
    ct = rng.standard_normal(x.size)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    _, vjp = jax.vjp(jax.nn.silu, jnp.asarray(x, jdt))
    jg, = jax.jit(vjp)(jnp.asarray(ct, jdt))
    tx = tt(jnp.asarray(x, jdt)).clone().requires_grad_()
    TL.act_fn("silu")(tx).backward(tt(jnp.asarray(ct, jdt)))
    assert tx.grad.dtype == tx.dtype and torch.isfinite(tx.grad).all()
    assert np.abs(f32(jg) - f32(tx.grad)).max() <= 1e-6
