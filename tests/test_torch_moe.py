"""Port parity for the MoE family (``repro_torch.models.moe`` and the MoE
stack of ``models/transformer.py``) on the reduced phi3.5-moe (d 64, 4
experts top-2, vocab 256): the bucketing, the router (with forced ties),
``apply_moe`` in prefill and decode with drops, the shared-expert branch,
gradients, the whole model's logits in both layouts, a decode step, two
train steps, remat and the weights carried both ways.

The weights are the JAX package's ``init_lm`` carried across
(``_lm_cases.carried``).  Each tolerance is the largest difference seen
over seeds 0-4 (noted beside it) with about 4x headroom.

**Routing flips.**  XLA keeps excess bf16 precision (ROADMAP.md §3), so a
layer's input differs from the port's by a bf16 ulp here and there; where
two of a token's router logits are within that ulp, the packages pick
different experts, and a changed pick moves the bucket ranks (so the
drops) of the later tokens in its group.  The token's output then differs
by O(1), which no tolerance on every entry absorbs.  The whole-model
checks therefore hold most positions to the dense tolerance and bound the
rest (``_hold_positions``), and the layer-level checks take the JAX
side's inputs, where the picks are the same.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as SE  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

from _lm_cases import J_FWD, carried, f32, rel_err, tt  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
SEEDS = range(5)
# jitted once per config and shape, as _lm_cases' functions
J_MOE = jax.jit(JM.apply_moe, static_argnums=1)
J_LOGITS_AUX = jax.jit(lambda p, cfg, t: JT.forward(p, cfg, t)[::2],
                       static_argnums=1)


@functools.partial(jax.jit, static_argnums=3)
def _j_loss_grads(p, x, w, cfg):
    def loss(p, x):
        out, aux = JM.apply_moe(p, cfg, x)
        return jnp.sum(out.astype(jnp.float32) * w) + aux
    return jax.grad(loss, argnums=(0, 1))(p, x)


_J_STEPS: dict = {}


def _j_step(cfg):
    """The reference's train step, jitted once per config."""
    if cfg not in _J_STEPS:
        _J_STEPS[cfg] = jax.jit(JTR.make_train_step(
            cfg, schedule=JO.cosine_schedule(1e-3, 1, 2)))
    return _J_STEPS[cfg]


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


def _moe(seed, **kw):
    """(jax cfg, port cfg, jax layer-0 MoE params, port's)."""
    cfg, tcfg, params, _ = carried(ARCH, seed, **kw)
    p = params["stacks"][0][0]["moe"]
    return cfg, tcfg, p, {k: tt(v) for k, v in p.items()}


def _drops(tcfg, tp, x) -> int:
    """Pairs past their bucket's capacity in ``apply_moe(x)``."""
    G, Tg = TM.groups_of(x)
    _, _, sel = TM.route(tp, tcfg, x.reshape(G, Tg, -1))
    return int((TM._pair_ranks(sel, tcfg.num_experts)
                >= TM.capacity(tcfg, Tg)).sum())


# ---------------------------------------------------------------- buckets
@pytest.mark.parametrize("seed", SEEDS)
def test_pair_ranks_dispatch_and_combine_bitwise(seed):
    """3 groups of 40 tokens on 4 experts, capacity 7 (about 13 pairs an
    expert: most overflow): the ranks bitwise the reference's, the
    buffer and the combine bitwise the op-by-op reference's (under
    ``jit`` XLA fuses the combine's fp32 multiply-add: 2.4e-7-4.8e-7 off,
    seeds 0-4)."""
    E, k, C = 4, 2, 7
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, E, (3, 40, k)).astype(np.int32)
    sel[0, :, 1] = (sel[0, :, 0] + 1) % E  # top-k picks distinct experts
    sel[1:, :, 1] = np.where(sel[1:, :, 1] == sel[1:, :, 0],
                             (sel[1:, :, 0] + 1) % E, sel[1:, :, 1])
    jr = np.asarray(jax.vmap(lambda s: JM._pair_ranks(s, E))(sel))
    ts = torch.from_numpy(sel).long()
    tr = TM._pair_ranks(ts, E)
    assert np.array_equal(jr, tr.numpy())
    assert (jr >= C).sum() > 0  # overflow drops
    x = _bf16(rng, (3, 40, 16))
    jb = jax.vmap(lambda xg, s, r: JM._group_dispatch(xg, s, r, E, C))(
        x, sel, jr)
    tb = TM._group_dispatch(tt(x), ts, tr, E, C)
    assert tb.shape == (E, 3, C, 16)
    assert np.array_equal(f32(jb), f32(tb.permute(1, 0, 2, 3)))
    gate = jnp.asarray(rng.uniform(0, 1, (3, 40, k)), jnp.float32)
    jy = jax.vmap(lambda o, s, r, g: JM._group_combine(o, s, r, g, 40, C))(
        jb, sel, jr, gate)
    ty = TM._group_combine(tb, ts, tr, tt(gate), C)
    assert ty.dtype == torch.float32
    assert np.array_equal(f32(jy), f32(ty))


@pytest.mark.parametrize("seed", SEEDS)
def test_router_ties_go_to_the_lower_expert(seed):
    """Router columns 1, 2 and 3 equal: every token's logits for them tie,
    so a top-2 that reaches them is decided by the tie rule alone (expert
    3 is never picked, 2 only beside 1).  The picks equal
    ``lax.top_k``'s (the lower expert first), the gates within 1.2e-7,
    and the whole layer matches the reference (seeds 0-4: the output
    bitwise, the aux within 1.2e-7)."""
    cfg, tcfg, p, _ = _moe(seed)
    r = np.array(p["router"].astype(jnp.float32))
    r[:, 2] = r[:, 3] = r[:, 1]
    p = dict(p, router=jnp.asarray(r, jnp.bfloat16))
    tp = {k: tt(v) for k, v in p.items()}
    x = _bf16(np.random.default_rng(seed), (2, 16, cfg.d_model))
    logits = (x @ p["router"]).astype(jnp.float32)
    jg, js = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    _, tg, ts = TM.route(tp, tcfg, tt(x))
    assert np.array_equal(np.asarray(js), ts.numpy())
    js = np.asarray(js)
    assert (js != 3).all() and ((js == 2).any(-1) <= (js == 1).any(-1)).all()
    jg = jg / jnp.maximum(jg.sum(-1, keepdims=True), 1e-9)
    assert np.abs(np.asarray(jg) - tg.numpy()).max() <= 1.2e-7
    jo, ja = J_MOE(p, cfg, x)
    to, ta = TM.apply_moe(tp, tcfg, tt(x))
    assert rel_err(jo, to) <= 2e-3
    assert abs(float(ja) - float(ta)) <= 4.8e-7 * float(ja)


# ---------------------------------------------------------------- the layer
MOE_SHAPES = {"prefill": (4, 32), "decode": (16, 1)}


@pytest.mark.parametrize("mode", list(MOE_SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_apply_moe_matches_jax(seed, mode):
    """Prefill (G = B = 4 groups of 32) and decode (one group of 16, C =
    10): the output and the aux loss.  Seeds 0-4: 0-5 dropped pairs a
    call; the output bitwise but for 5.5e-4 / 2.5e-3 of max|out| on one
    or two rows (a bf16 ulp of a product), the aux within 1.2e-7."""
    cfg, tcfg, p, tp = _moe(seed)
    x = _bf16(np.random.default_rng(seed), MOE_SHAPES[mode] + (cfg.d_model,))
    jo, ja = J_MOE(p, cfg, x)
    to, ta = TM.apply_moe(tp, tcfg, tt(x))
    assert to.dtype == torch.bfloat16 and to.shape == tuple(x.shape)
    assert rel_err(jo, to) <= 1e-2
    assert abs(float(ja) - float(ta)) <= 4.8e-7 * float(ja)


def test_apply_moe_drops_in_decode_and_prefill():
    """The cases above do drop pairs: decode of 16 rows (C = 10) and of 2
    rows (C = 1, two rows on one expert lose the later pair)."""
    seen = {}
    for seed in SEEDS:
        _, tcfg, _, tp = _moe(seed)
        rng = np.random.default_rng(seed)
        for name, shape in dict(MOE_SHAPES, decode2=(2, 1)).items():
            x = tt(_bf16(rng, shape + (tcfg.d_model,)))
            seen[name] = seen.get(name, 0) + _drops(tcfg, tp, x)
    assert all(n > 0 for n in seen.values()), seen


@pytest.mark.parametrize("seed", SEEDS)
def test_shared_expert_branch(seed):
    """``num_shared_experts=1``: the shared gated MLP added in fp32 (seeds
    0-4: bitwise but for 2.1e-3 of max|out| on one row)."""
    cfg, tcfg, p, tp = _moe(seed, num_shared_experts=1)
    assert {"shared_w_in", "shared_w_gate", "shared_w_out"} <= set(tp)
    x = _bf16(np.random.default_rng(seed), (2, 16, cfg.d_model))
    jo, ja = J_MOE(p, cfg, x)
    to, ta = TM.apply_moe(tp, tcfg, tt(x))
    assert rel_err(jo, to) <= 1e-2
    assert abs(float(ja) - float(ta)) <= 4.8e-7 * float(ja)


@pytest.mark.parametrize("seed", SEEDS)
def test_apply_moe_gradients_match_jax(seed):
    """d(sum(out * w) + aux) by x and by every leaf, against ``jax.grad``
    (seeds 0-4: each within 1.6e-2 of its max|grad|)."""
    cfg, tcfg, p, tp = _moe(seed, num_shared_experts=1)
    rng = np.random.default_rng(seed)
    x = _bf16(rng, (2, 16, cfg.d_model))
    w = jnp.asarray(rng.standard_normal((2, 16, cfg.d_model)), jnp.float32)
    jgp, jgx = _j_loss_grads(p, x, w, cfg)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = tt(x).clone().requires_grad_()
    out, aux = TM.apply_moe(leaves, tcfg, xt)
    (torch.sum(out.float() * tt(w)) + aux).backward()
    for name, j, t in [("x", jgx, xt.grad)] + [
            (k, jgp[k], leaves[k].grad) for k in sorted(tp)]:
        assert t.dtype == torch.bfloat16 and t.shape == tuple(j.shape), name
        scale = float(np.abs(f32(j)).max())
        assert float(np.abs(f32(j) - f32(t)).max()) <= 6.4e-2 * scale, name


# ------------------------------------------------------------ whole model
def _hold_positions(jl, tl, tol, share) -> None:
    """Logits [B, S, V]: each position's max|diff| over max|logit|; at
    least ``share`` of the positions within ``tol`` (the rest are routing
    flips), and no logit off by more than the largest logit."""
    jl, tl = f32(jl), f32(tl)
    per = np.abs(jl - tl).max(-1) / np.abs(jl).max()
    assert (per <= tol).mean() >= share, np.sort(per)
    assert per.max() <= 1.0, per.max()


LAYOUTS = [2, 8]


@pytest.mark.parametrize("layers", LAYOUTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_forward_logits_match_jax(seed, layers):
    """Train and prefill logits of 2 layers (a list stack) and 8 (the
    stacked ``[L, E, D, F]`` layout), and the aux loss.  Seeds 0-4, of the
    32 positions: >= 93.7% (2 layers) and >= 78.1% (8 layers) within
    the dense tolerance (5e-2, 1e-1 of max|logit|), every one within
    0.74; the aux within 9.8e-4 (relative: a flip moves a pair's
    density by 1/64)."""
    cfg, tcfg, params, model = carried(ARCH, seed, num_layers=layers)
    assert T.build_plan(tcfg).stacks[0].scan == (layers == 8)
    tol, share = (5e-2, 0.75) if layers == 2 else (1e-1, 0.6)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jaux = J_LOGITS_AUX(params, cfg, tokens)
    tl, _, taux, _ = T.forward(model, tcfg, torch.from_numpy(tokens))
    _hold_positions(jl, tl, tol, share)
    assert abs(float(jaux) - float(taux)) <= 4e-3 * float(jaux)
    jc = JT.init_cache(cfg, 2, 20)
    jl, _ = J_FWD(params, cfg, tokens, "prefill", jc)
    tl, _, _, _ = T.forward(model, tcfg, torch.from_numpy(tokens),
                            mode="prefill",
                            caches=T.init_cache(tcfg, 2, 20, "cpu"))
    _hold_positions(jl, tl, tol, share)


@pytest.mark.parametrize("layers", LAYOUTS)
def test_two_row_decode_step_matches_jax(layers, monkeypatch):
    """A prefill of 2 x 12 tokens, then 3 decode steps of the 2 rows (one
    group of 2 tokens, C = 1: when both rows pick an expert, the second
    row's pair drops) by each package's ``make_decode_step``, from the
    JAX prefill's cache carried across: the 6 rows' logits by
    ``_hold_positions`` (seeds 0-4: every row within 1.8e-2 of max|logit|
    at 2 layers; at 8 layers >= 5 of 6 within 4.9e-2, a flip 0.36), and
    the steps do drop pairs."""
    dropped, total = [], 0
    apply = TM.apply_moe

    def counted(p, cfg, x):
        dropped.append(_drops(cfg, p, x))
        return apply(p, cfg, x)
    monkeypatch.setattr(TM, "apply_moe", counted)
    jstep = None
    for seed in SEEDS:
        cfg, tcfg, params, model = carried(ARCH, seed, num_layers=layers)
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        _, jc = J_FWD(params, cfg, tokens, "prefill",
                      JT.init_cache(cfg, 2, 16))
        tc = _port_cache(jax.tree.leaves(jc), layers)
        jstep = jstep or jax.jit(JE.make_decode_step(cfg))
        step = SE.make_decode_step(tcfg)
        del dropped[:]
        jls, tls = [], []
        for _ in range(3):
            tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
            jl, jc = jstep(params, tok, jc)
            tl, tc = step(model, torch.from_numpy(tok), tc)
            jls.append(f32(jl))
            tls.append(f32(tl))
        _hold_positions(np.concatenate(jls, 1), np.concatenate(tls, 1),
                        *((5e-2, 0.75) if layers == 2 else (1e-1, 0.6)))
        assert len(dropped) == 3 * layers
        total += sum(dropped)
    assert total > 0


def _port_cache(leaves, layers):
    """The JAX cache's leaves (k, v, pos a layer, or the stacked three) as
    the port's cache tree."""
    from repro_torch.models import attention as TA
    leaves = [tt(np.asarray(a)) for a in leaves]
    if layers >= T.MIN_SCAN:
        return (T.LayerCache(TA.KVCache(*leaves), None),)
    return (tuple(T.LayerCache(TA.KVCache(*leaves[3 * i:3 * i + 3]), None)
                  for i in range(layers)),)


# --------------------------------------------------------------- training
def _batches(rng, n, vocab):
    return [{"tokens": rng.integers(0, vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, vocab, (4, 16)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_two_train_steps_match_jax(seed):
    """2 AdamW steps (remat "full", the config's) from the carried weights:
    per step the loss, the aux and the grad norm, then every parameter.
    Seeds 0-4: the loss within 5.8e-4, the aux 3.1e-4, the grad norm
    1.4e-2 (relative; routing flips move a few tokens), each parameter
    within 3 x the summed step sizes plus a bf16 ulp below 0.5 (a flipped
    update direction; at most 2.0e-3 apart)."""
    cfg, tcfg, params, model = carried(ARCH, seed)
    jstep = _j_step(cfg)
    tstep = TR.make_train_step(tcfg, schedule=TO.cosine_schedule(1e-3, 1, 2))
    js = JTR.TrainState(params, JO.AdamW().init(params),
                        jnp.zeros((), jnp.int32))
    ts = TR.TrainState(model, TO.AdamW().init(T.param_dict(model)),
                       torch.zeros((), dtype=torch.int32))
    lrs = []
    for b in _batches(np.random.default_rng(seed), 2, cfg.vocab_size):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        assert set(tm) == set(jm) >= {"loss", "aux", "nll", "grad_norm"}
        for key, tol in (("loss", 2.4e-3), ("aux", 1.2e-3),
                         ("grad_norm", 5.6e-2)):
            j, t = float(jm[key]), float(tm[key])
            assert abs(j - t) <= tol * abs(j), (key, j, t)
        lrs.append(float(tm["lr"]))
    bound = 3 * sum(lrs) + 2.0 ** -9
    jn = T.from_tree(js.params)
    for k, p in T.param_dict(ts.params).items():
        assert np.abs(f32(jn[k]) - f32(p)).max() <= bound, k


@pytest.mark.parametrize("layers", LAYOUTS)
def test_remat_full_equals_none(layers):
    """The recomputed forward picks the same experts: the loss, the aux
    and every gradient bitwise with ``remat="full"`` and ``"none"``."""
    model = T.init_lm(dataclasses.replace(get_config(ARCH).reduced(),
                                          num_layers=layers), 0, "cpu")
    model.requires_grad_(True)
    rng = np.random.default_rng(1)
    tok, lab = (torch.from_numpy(rng.integers(0, 256, (2, 16)))
                for _ in range(2))
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(model.cfg, remat=remat)
        for p in model.parameters():
            p.grad = None
        total, metrics = T.lm_loss(model, cfg, tok, lab)
        total.backward()
        out[remat] = (total.detach(), metrics["aux"].detach(),
                      {k: p.grad for k, p in T.param_dict(model).items()})
    assert torch.equal(out["full"][0], out["none"][0])
    assert torch.equal(out["full"][1], out["none"][1])
    assert float(out["none"][1]) > 0
    for k, g in out["none"][2].items():
        assert torch.equal(out["full"][2][k], g), k


# ---------------------------------------------------------------- weights
@pytest.mark.parametrize("layers", LAYOUTS)
def test_weights_cross_both_ways(layers):
    """JAX -> port: ``params_to_numpy(params_from_numpy(tree))`` is the
    tree, leaf for leaf, bytes for bytes.  Port -> JAX: the port's own
    random weights, carried into the JAX package, give its forward the
    port's logits (the forward test's rule)."""
    cfg, tcfg, params, model = carried(ARCH, 0, num_layers=layers)
    back = T.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.asarray(a).tobytes() == b.tobytes()
    own = T.init_lm(tcfg, 3, "cpu")
    tree = jax.tree.map(jnp.asarray, T.params_to_numpy(own))
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(
        np.int32)
    jl, _ = J_FWD(tree, cfg, tokens, "train", None)
    tl = T.forward(own, tcfg, torch.from_numpy(tokens))[0]
    _hold_positions(jl, tl, 5e-2 if layers == 2 else 1e-1,
                    0.75 if layers == 2 else 0.6)
