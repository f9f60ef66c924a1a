"""Port parity for deepseek-v3's MLA and MTP (reduced widths): the MLA
layer in train and prefill (dense, and flash above 2,048 tokens with q
and k 24 wide and v 16), forward and gradients; the absorbed decode over
the packed compressed cache, and a two-row decode at different per-row
positions against the reference run a row at a time; the MTP head's
loss and gradients against ``jax.grad(lm_loss)``; the reduced model's
logits (a list stack and the stacked ``[L, ...]`` MoE layout) and two
Adafactor train steps against the JAX train step; Adafactor in pieces
against the whole-leaf update; a compressed cache's checkpoint round
trip between the packages.

The same seeded inputs go through the JAX package (jitted, on the CPU)
and the port (``device="cpu"``), the weights the JAX package's carried
by ``params_from_numpy``.  Each tolerance is the largest difference seen
over seeds 0-4 (noted beside it) with about 4x headroom; they are not 0
because XLA keeps excess bf16 precision inside a fusion (ROADMAP.md §3).
The whole-model checks take ``capacity_factor=16`` (no pair dropped, as
``tests/test_models_smoke.py`` does) and hold most positions, not every
one: the excess precision flips a route at a router near tie now and
then (``tests/test_torch_moe.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.ft import checkpoint as JC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.ft import checkpoint as TC  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

from _lm_cases import J_ATTN, J_FWD, carried, f32, rel_err, tt  # noqa: E402

ARCH = "deepseek-v3-671b"
SEEDS = range(5)
NO_DROP = {"capacity_factor": 16.0}


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


def _attn(seed, **kw):
    """(jax cfg, port cfg, layer 0's MLA params: jax, port)."""
    cfg, tcfg, params, _ = carried(ARCH, seed, **kw)
    p = params["stacks"][0][0]["attn"]
    return cfg, tcfg, p, {k: tt(v) for k, v in p.items()}


def _positions(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                           (B, S)).copy()


_J_GRADS: dict = {}


def _j_layer_grads(cfg, mode):
    """d/d(params, x) of sum(out * w) through the reference's MLA layer,
    jitted once per config and mode."""
    if (cfg, mode) not in _J_GRADS:
        def loss(p, x, pos, w):
            out, _ = JA.attention_layer(p, cfg, x, pos, mode=mode)
            return jnp.sum(out.astype(jnp.float32) * w)
        _J_GRADS[cfg, mode] = jax.jit(jax.grad(loss, argnums=(0, 1)))
    return _J_GRADS[cfg, mode]


# ------------------------------------------------------------- MLA layer
@pytest.mark.parametrize("S", [16, 2100])
@pytest.mark.parametrize("seed", [0, 1])
def test_mla_layer_train_prefill_and_gradients_match_jax(seed, S):
    """Train and prefill outputs (dense at 16 tokens, flash at 2,100) and
    the prefill's packed cache, then the gradients of sum(out * w) as
    d(params), d(x).  Seeds 0-4: outputs within 1.8e-3 of max|out|; the
    cache bitwise but on <= 1.4e-4 of its entries, those one bf16 ulp
    (1.9e-3 of max|c|); gradients within 7.4e-3 of each max|grad|."""
    cfg, tcfg, jp, tp = _attn(seed)
    B = 1 if S > 2048 else 2
    rng = np.random.default_rng(seed)
    x = _bf16(rng, (B, S, cfg.d_model))
    pos = _positions(B, S)
    jout, _ = J_ATTN(jp, cfg, x, pos, mode="train")
    tout, _ = TA.attention_layer(tp, tcfg, tt(x), torch.from_numpy(pos))
    assert tout.shape == (B, S, cfg.d_model)
    assert rel_err(jout, tout) <= 8e-3
    jc = JA.init_kv_cache(cfg, B, S + 4)
    jpre, jc = J_ATTN(jp, cfg, x, pos, cache=jc, mode="prefill")
    tc = TA.init_kv_cache(tcfg, B, S + 4, "cpu")
    tpre, tc = TA.attention_layer(tp, tcfg, tt(x), torch.from_numpy(pos),
                                  cache=tc, mode="prefill")
    assert tc.v is None and int(tc.pos) == S
    assert rel_err(jpre, tpre) <= 8e-3
    jk, tk = f32(jc.k), f32(tc.k)
    assert (jk != tk).mean() <= 6e-4
    assert np.abs(jk - tk).max() <= 8e-3 * np.abs(jk).max()

    w = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), jnp.float32)
    jg, jgx = _j_layer_grads(cfg, "train")(jp, x, pos, w)
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xg = tt(x).clone().requires_grad_(True)
    out, _ = TA.attention_layer(tpg, tcfg, xg, torch.from_numpy(pos))
    torch.sum(out.float() * tt(w)).backward()
    assert rel_err(jgx, xg.grad) <= 3e-2
    for k, v in tpg.items():
        assert rel_err(jg[k], v.grad) <= 3e-2, k


def _decode_steps(J, cfg, tcfg, jp, tp, rng, B, S, steps):
    """Prefill S tokens, then ``steps`` decode steps in both packages:
    (jax outputs, port outputs, jax cache, port cache)."""
    s_max = S + steps + 3
    x = _bf16(rng, (B, S, cfg.d_model))
    jc = JA.init_kv_cache(cfg, B, s_max)
    _, jc = J_ATTN(jp, cfg, x, _positions(B, S), cache=jc, mode="prefill")
    tc = TA.init_kv_cache(tcfg, B, s_max, "cpu")
    _, tc = TA.attention_layer(tp, tcfg, tt(x),
                               torch.from_numpy(_positions(B, S)),
                               cache=tc, mode="prefill")
    jo, to = [], []
    for t in range(steps):
        xt = _bf16(rng, (B, 1, cfg.d_model))
        pt = _positions(B, 1, S + t)
        j, jc = J_ATTN(jp, cfg, xt, pt, cache=jc, mode="decode")
        o, tc = TA.attention_layer(tp, tcfg, tt(xt), torch.from_numpy(pt),
                                   cache=tc, mode="decode")
        jo.append(j)
        to.append(o)
    return jo, to, jc, tc


@pytest.mark.parametrize("seed", SEEDS)
def test_absorbed_decode_matches_jax(seed):
    """12 tokens prefilled, then 4 absorbed decode steps (fp32 scores
    against the compressed rows and the rope rows): each step's output
    and the packed cache bitwise the reference's (seeds 0-4), the
    position 16."""
    cfg, tcfg, jp, tp = _attn(seed)
    rng = np.random.default_rng(seed)
    jo, to, jc, tc = _decode_steps(J_ATTN, cfg, tcfg, jp, tp, rng, 2, 12, 4)
    for j, t in zip(jo, to):
        assert np.array_equal(f32(j), f32(t))
    assert np.array_equal(f32(jc.k), f32(tc.k))
    assert int(jc.pos) == int(tc.pos) == 16


@pytest.mark.parametrize("seed", SEEDS)
def test_two_row_decode_at_different_positions_matches_jax(seed):
    """Two rows prefilled to 5 and 9 tokens (one per-row ``pos``, as the
    slot server keeps it) decode 3 steps together; the reference, whose
    decode writes at one scalar position, runs each row alone.  Each
    row's output bitwise the reference's (seeds 0-4) and the port's own
    row run alone; each row's cache rows bitwise the reference's."""
    cfg, tcfg, jp, tp = _attn(seed)
    rng = np.random.default_rng(seed)
    lens, steps, s_max = (5, 9), 3, 16
    xs = [_bf16(rng, (1, n, cfg.d_model)) for n in lens]
    dx = [_bf16(rng, (2, 1, cfg.d_model)) for _ in range(steps)]
    # the port: both rows in one cache with pos [5, 9]
    tc = TA.init_kv_cache(tcfg, 2, s_max, "cpu")
    for r, (n, x) in enumerate(zip(lens, xs)):
        one = TA.init_kv_cache(tcfg, 1, s_max, "cpu")
        TA.attention_layer(tp, tcfg, tt(x), torch.from_numpy(_positions(1, n)),
                           cache=one, mode="prefill")
        tc.k[r] = one.k[0]
    tc = tc._replace(pos=torch.tensor(lens, dtype=torch.int32))
    both = []
    for t in range(steps):
        pt = torch.tensor([[n + t] for n in lens], dtype=torch.int32)
        o, tc = TA.attention_layer(tp, tcfg, tt(dx[t]), pt, cache=tc,
                                   mode="decode")
        both.append(o)
    assert tc.pos.tolist() == [n + steps for n in lens]
    for r, (n, x) in enumerate(zip(lens, xs)):
        jc = JA.init_kv_cache(cfg, 1, s_max)
        _, jc = J_ATTN(jp, cfg, x, _positions(1, n), cache=jc,
                       mode="prefill")
        alone = TA.init_kv_cache(tcfg, 1, s_max, "cpu")
        _, alone = TA.attention_layer(tp, tcfg, tt(x),
                                      torch.from_numpy(_positions(1, n)),
                                      cache=alone, mode="prefill")
        for t in range(steps):
            xt = dx[t][r:r + 1]
            pt = _positions(1, 1, n + t)
            j, jc = J_ATTN(jp, cfg, xt, pt, cache=jc, mode="decode")
            a, alone = TA.attention_layer(tp, tcfg, tt(xt),
                                          torch.from_numpy(pt), cache=alone,
                                          mode="decode")
            assert np.array_equal(f32(j), f32(both[t][r:r + 1])), (r, t)
            assert torch.equal(a, both[t][r:r + 1]), (r, t)
        assert np.array_equal(f32(jc.k[0]), f32(tc.k[r]))


# ------------------------------------------------------------ whole model
def _hold_positions(jl, tl, tol, share) -> None:
    """Logits [B, S, V]: each position's max|diff| over max|logit|; at
    least ``share`` of the positions within ``tol`` (the rest are routing
    flips), and no logit off by more than the largest logit."""
    jl, tl = f32(jl), f32(tl)
    per = np.abs(jl - tl).max(-1) / np.abs(jl).max()
    assert (per <= tol).mean() >= share, np.sort(per)
    assert per.max() <= 1.0, per.max()


@pytest.mark.parametrize("layers", [2, 9])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_prefill_and_decode_logits_match_jax(seed, layers):
    """The reduced deepseek (MLA in every layer; 2 layers: a dense and an
    MoE list stack; 9: a dense layer and a stacked ``[8, ...]`` MoE stack
    with a stacked compressed cache): train and prefill logits, seeds
    0-4: every position within 1.6e-2 of max|logit| at 2 layers; at 9,
    >= 91.7% within 5e-2 (the dense tolerance), every one within 0.67
    (a route flipped in an early layer moves its row).  Then 3 decode
    steps: at 2 layers at least 5 of the 6 rows within 5e-2 (seeds 0-4:
    at most one flipped row, 0.75; the rest within 1.7e-2), every one
    within 1.0; at 9 the stacked cache's per-layer positions and no
    ``v``."""
    cfg, tcfg, params, model = carried(ARCH, seed, num_layers=layers,
                                       **NO_DROP)
    stacked = T.build_plan(tcfg).stacks[-1].scan
    assert stacked == (layers == 9)
    tol, share = (5e-2, 1.0) if layers == 2 else (5e-2, 0.75)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = J_FWD(params, cfg, tokens, "train", None)
    tl = T.forward(model, tcfg, torch.from_numpy(tokens))[0]
    _hold_positions(jl, tl, tol, share)
    jc = JT.init_cache(cfg, 2, 16)
    jl, jc = J_FWD(params, cfg, tokens, "prefill", jc)
    tc = T.init_cache(tcfg, 2, 16, "cpu")
    tl, tc, _, _ = T.forward(model, tcfg, torch.from_numpy(tokens),
                             mode="prefill", caches=tc)
    _hold_positions(jl, tl, tol, share)
    j_dec = jax.jit(lambda p, t, pos, c: JT.forward(
        p, cfg, t, positions=pos, mode="decode", caches=c)[:2])
    rows = []
    for t in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = _positions(2, 1, 12 + t)
        tl, tc, _, _ = T.forward(model, tcfg, torch.from_numpy(tok),
                                 positions=torch.from_numpy(pos),
                                 mode="decode", caches=tc)
        if not stacked:
            jl, jc = j_dec(params, tok, pos, jc)
            rows.append(np.abs(f32(jl) - f32(tl)).max(-1).ravel()
                        / np.abs(f32(jl)).max())
    if not stacked:  # a flipped route moves its row at that step
        rows = np.concatenate(rows)
        assert (rows <= tol).sum() >= 5 and rows.max() <= 1.0, rows
    if stacked:
        kv = tc[-1].kv
        assert kv.v is None and kv.k.shape == (
            8, 2, 16, tcfg.kv_lora_rank + tcfg.qk_rope_head_dim)
        assert kv.pos.tolist() == [15] * 8


_J_LOSS: dict = {}


def _j_loss_grads(cfg):
    if cfg not in _J_LOSS:
        _J_LOSS[cfg] = jax.jit(jax.value_and_grad(
            lambda p, t, y: JT.lm_loss(p, cfg, t, y), has_aux=True))
    return _J_LOSS[cfg]


@pytest.mark.parametrize("seed", SEEDS)
def test_mtp_loss_and_gradients_match_jax(seed):
    """``lm_loss`` with the MTP head (weight 0.3 on ``mtp``).  The
    gradients on one MLA layer with a dense MLP (``first_k_dense`` 1: no
    router, so no route can flip) plus the head: every leaf's within
    0.13 of its max|grad| (seeds 0-4: at most 3.2e-2, the MLA norms'),
    the losses within 5e-4 (1.1e-4).  Then the reduced model (a dense and
    an MoE layer): nll, mtp and the total within 3e-3 (7.3e-4), the aux
    1.2e-2 (2.8e-3: seed 2 flips a route)."""
    rng = np.random.default_rng(seed)
    tok, lab = (rng.integers(0, 256, (2, 16)).astype(np.int32)
                for _ in range(2))
    for kw, tol in (({"num_layers": 1, "first_k_dense": 1}, None),
                    (NO_DROP, {"aux": 1.2e-2})):
        cfg, tcfg, params, model = carried(ARCH, seed, **kw)
        (_, jm), jg = _j_loss_grads(cfg)(params, tok, lab)
        model.requires_grad_(True)
        total, tm = T.lm_loss(model, tcfg, torch.from_numpy(tok),
                              torch.from_numpy(lab))
        assert set(tm) == set(jm) == {"nll", "aux", "mtp", "loss"}
        parts = (tm["nll"] + tm["aux"] + 0.3 * tm["mtp"]).detach()
        assert abs(float(tm["loss"].detach()) - float(parts)) <= 1e-5
        for key in tm:
            j, t = float(jm[key]), float(tm[key].detach())
            limit = 5e-4 if tol is None else tol.get(key, 3e-3)
            assert abs(j - t) <= limit * abs(j) + 1e-9, (key, j, t)
        if tol is not None:
            continue
        total.backward()
        jn = T.from_tree(jg)
        named = T.param_dict(model)
        assert set(jn) == set(named)
        assert sum(k.startswith("mtp.") for k in jn) == 15
        for k, p in named.items():
            assert rel_err(jn[k], p.grad) <= 0.13, k


_J_STEPS: dict = {}


def _j_step(cfg):
    if cfg not in _J_STEPS:
        _J_STEPS[cfg] = jax.jit(JTR.make_train_step(
            cfg, schedule=JO.cosine_schedule(1e-3, 1, 2)))
    return _J_STEPS[cfg]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_adafactor_train_steps_match_jax(seed):
    """2 Adafactor steps (the config's optimizer, remat "full") from the
    carried weights: per step the loss, the aux, the ``mtp`` term and the
    grad norm, then every parameter.  Seeds 0-4: the loss and ``mtp``
    within 2e-3 (at most 4.7e-4), the aux 4e-3 (9.1e-4), the grad norm
    3.6e-2 (8.8e-3), all relative; each parameter within 3 x the summed
    step sizes plus a bf16 ulp below 0.5 (at most 3.9e-3 against 5.0e-3:
    a flipped update direction)."""
    cfg, tcfg, params, model = carried(ARCH, seed, **NO_DROP)
    assert tcfg.optimizer == "adafactor"
    jstep = _j_step(cfg)
    tstep = TR.make_train_step(tcfg, schedule=TO.cosine_schedule(1e-3, 1, 2))
    js = JTR.TrainState(params, JO.Adafactor().init(params),
                        jnp.zeros((), jnp.int32))
    ts = TR.TrainState(model, TO.Adafactor().init(T.param_dict(model)),
                       torch.zeros((), dtype=torch.int32))
    rng = np.random.default_rng(seed)
    lrs = []
    for _ in range(2):
        b = {k: rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        assert set(tm) == set(jm) >= {"loss", "aux", "mtp", "grad_norm"}
        for key, tol in (("loss", 2e-3), ("mtp", 2e-3), ("aux", 4e-3),
                         ("grad_norm", 3.6e-2)):
            j, t = float(jm[key]), float(tm[key])
            assert abs(j - t) <= tol * abs(j), (key, j, t)
        lrs.append(float(tm["lr"]))
    bound = 3 * sum(lrs) + 2.0 ** -9
    jn = T.from_tree(js.params)
    for k, p in T.param_dict(ts.params).items():
        assert np.abs(f32(jn[k]) - f32(p)).max() <= bound, k


# ------------------------------------------------------------- Adafactor
def _adafactor_run(piece, monkeypatch, params, grads, steps=3):
    monkeypatch.setattr(TO, "PIECE", piece)
    p = {k: v.clone() for k, v in params.items()}
    opt = TO.Adafactor(weight_decay=0.01)
    st = opt.init(p)
    for i in range(steps):
        g = {k: (v.float() * (i + 1)).to(v.dtype) for k, v in grads.items()}
        opt.update(g, st, p, torch.tensor(1e-2))
    return p, st


@pytest.mark.parametrize("seed", [0, 1])
def test_adafactor_in_pieces_matches_whole_leaf(seed, monkeypatch):
    """``PIECE`` set to 48 elements, so every leaf but the smallest is
    updated in pieces: a stack of factored matrices ([6, 5, 7], [2, 3,
    5, 4]: whole matrices a piece) and the unfactored leaves bitwise the
    whole-leaf update; a two-dim leaf ([40, 9], [130, 2]: row blocks) its
    parameters and row moment bitwise, its column moment (a sum over the
    blocks) within 4 float32 ulps; the 12-element leaf takes the
    whole-leaf path."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"stack": (6, 5, 7), "stack4": (2, 3, 5, 4), "rows": (40, 9),
              "tall": (130, 2), "vec": (300,), "small": (3, 4)}
    params = {k: torch.randn(s, generator=g).to(torch.bfloat16)
              for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=g).to(torch.bfloat16)
             for k, s in shapes.items()}
    pw, sw = _adafactor_run(1 << 26, monkeypatch, params, grads)
    pp, sp = _adafactor_run(48, monkeypatch, params, grads)
    assert all(params[k].numel() > 48 for k in shapes if k != "small")
    for k in shapes:
        assert torch.equal(pw[k], pp[k]), k
        assert torch.equal(sw.vr[k], sp.vr[k]), k
        assert torch.equal(sw.v[k], sp.v[k]), k
        if k in ("rows", "tall"):
            torch.testing.assert_close(sp.vc[k], sw.vc[k], rtol=4.8e-7,
                                       atol=0)
        else:
            assert torch.equal(sw.vc[k], sp.vc[k]), k


def test_adafactor_pieces_only_above_piece(monkeypatch):
    """A leaf of exactly ``PIECE`` elements keeps the whole-leaf path (its
    arithmetic is ``tests/test_torch_train.py``'s, held to the JAX
    package's); one more element takes the pieces."""
    seen = []
    orig = TO.Adafactor._update_in_pieces

    def spy(self, p, g, state, k, beta2, lr):
        seen.append(k)
        return orig(self, p, g, state, k, beta2, lr)
    monkeypatch.setattr(TO.Adafactor, "_update_in_pieces", spy)
    monkeypatch.setattr(TO, "PIECE", 48)
    g = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s, generator=g).to(torch.bfloat16)
              for k, s in (("at", (8, 6)), ("above", (7, 7)),
                           ("vec", (49,)))}
    opt = TO.Adafactor()
    opt.update({k: torch.ones_like(v) for k, v in params.items()},
               opt.init(params), params, torch.tensor(1e-2))
    assert seen == ["above", "vec"]


# ------------------------------------------------------------ checkpoint
def test_compressed_cache_checkpoint_crosses_both_ways(tmp_path):
    """An MLA ``KVCache`` (``v`` None) in a ``LayerCache`` tree, prefilled
    by the port: saved by the port and restored by both packages, then
    saved by the JAX package and restored by the port; the packed rows
    bitwise, ``v`` None every time."""
    cfg, tcfg, params, model = carried(ARCH, 0, num_layers=2)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    caches = T.init_cache(tcfg, 2, 10, "cpu")
    _, caches, _, _ = T.forward(model, tcfg, torch.from_numpy(tokens),
                                mode="prefill", caches=caches)
    kv = caches[0][0].kv
    assert kv.v is None and int(kv.pos) == 6
    TC.CheckpointManager(str(tmp_path / "t")).save(1, caches)
    back, _ = TC.CheckpointManager(str(tmp_path / "t")).restore(device="cpu")
    jback, _ = JC.CheckpointManager(str(tmp_path / "t")).restore()
    for got in (back[0][0].kv, jback[0][0].kv):
        assert type(got).__name__ == "KVCache" and got.v is None
        assert np.array_equal(f32(got.k), f32(kv.k))
    JC.CheckpointManager(str(tmp_path / "j")).save(2, jback)
    again, _ = TC.CheckpointManager(str(tmp_path / "j")).restore(
        device="cpu")
    assert isinstance(again[0][0].kv, TA.KVCache) and again[0][0].kv.v is None
    assert torch.equal(again[0][0].kv.k, kv.k)
    assert int(again[0][0].kv.pos) == 6
