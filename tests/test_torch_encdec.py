"""Port parity for the encoder-decoder (whisper-medium reduced: 2 + 2
layers, d 64, 16 frames): the sinusoidal table, ``encode``,
``encdec_prefill`` and ``encdec_decode`` with the decoder's cache,
``generate(features=...)``, ``encdec_loss`` and its gradients, one train
step, and a ``DecLayerCache`` checkpoint crossing between the packages.

The same seeded inputs go through the JAX package (each function jitted
once, on the CPU) and the port (``device="cpu"``), the weights the JAX
package's ``init_encdec`` carried by ``encdec.params_from_numpy``.  Each
tolerance is the largest difference seen over seeds 0-4 (noted beside
it) with about 4x headroom; they are not 0 because XLA keeps excess bf16
precision inside a fusion (ROADMAP.md §3).
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
from repro.ft import checkpoint as JC  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.ft import checkpoint as TC  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as SE  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

from _lm_cases import f32, rel_err, same_or_near_tie, tt  # noqa: E402

ARCH = "whisper-medium"
SEEDS = range(5)
J_INIT = jax.jit(lambda key, cfg: JL.split_params(JED.init_encdec(key, cfg))[0],
                 static_argnums=1)
J_ENCODE = jax.jit(JED.encode, static_argnums=1)
J_PREFILL = jax.jit(JED.encdec_prefill, static_argnums=1)
J_DECODE = jax.jit(JED.encdec_decode, static_argnums=1)
J_TEACHER = jax.jit(lambda p, cfg, f, t: JED.decode_stack(
    p, cfg, t, jnp.broadcast_to(jnp.arange(t.shape[1])[None], t.shape),
    JED.encode(p, cfg, f), None, "train")[0], static_argnums=1)
J_LOSS_GRADS = jax.jit(jax.value_and_grad(
    lambda p, cfg, f, t, y: JED.encdec_loss(p, cfg, f, t, y),
    has_aux=True), static_argnums=1)


def carried(seed=0, **kw):
    """(jax cfg, port cfg, jax params, port model), whisper reduced."""
    cfg = dataclasses.replace(jget(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    params = J_INIT(jax.random.PRNGKey(seed), cfg)
    model = TED.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                  "cpu")
    return cfg, tcfg, params, model


def _features(rng, cfg, B=2):
    return jnp.asarray(rng.standard_normal((B, cfg.enc_seq, cfg.d_model)),
                       jnp.bfloat16)


def _tokens(rng, cfg, B=2, S=8):
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------ the table
@pytest.mark.parametrize("n,d", [(16, 64), (1500, 1024)])
def test_sinusoidal_positions_match_jax(n, d):
    """The frequencies are bitwise the jitted reference's (XLA's folded
    constant and its CPU ``exp``); XLA's CPU ``sin``/``cos`` are another
    approximation than torch's, so the fp32 table differs by one ulp of
    the angle on some entries (whisper's 1500 x 1024: 4.8% of them, at
    most 6.0e-8; 16 x 64: 9.4e-7): within 4e-6.  Rounded to bf16, as
    ``encode`` adds it to the features, it is bitwise the reference's."""
    j = np.asarray(jax.jit(JL.sinusoidal_positions, static_argnums=(0, 1))(
        n, d))
    t = TL.sinusoidal_positions(n, d)
    assert t.shape == (n, d) and t.dtype == torch.float32
    assert np.abs(j - t.numpy()).max() <= 4e-6
    jb = jnp.asarray(j).astype(jnp.bfloat16)
    assert np.array_equal(f32(jb), f32(t.to(torch.bfloat16)))


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("seed", SEEDS)
def test_encode_matches_jax(seed):
    """The encoder's states: the table added to the bf16 features, two
    bidirectional blocks, ``enc_norm``.  Seeds 0-4: within 3.6e-2 of
    max|h| (at most 9.1e-3)."""
    cfg, tcfg, params, model = carried(seed)
    f = _features(np.random.default_rng(seed), cfg)
    j = J_ENCODE(params, cfg, f)
    t = TED.encode(model, tcfg, tt(f))
    assert t.shape == (2, cfg.enc_seq, cfg.d_model) and t.dtype == torch.bfloat16
    assert rel_err(j, t) <= 3.6e-2


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_and_decode_match_jax(seed):
    """``encdec_prefill`` of 8 tokens, then 4 ``encdec_decode`` steps: the
    logits within 4e-2 of max|logit| (seeds 0-4: at most 1.0e-2), the
    decoder's positions 8 then 12 in every layer, the cross K/V of the
    prefill within 4e-2 of their max (1.0e-2)."""
    cfg, tcfg, params, model = carried(seed)
    rng = np.random.default_rng(seed)
    f, tok = _features(rng, cfg), _tokens(rng, cfg)
    jc = JED.init_dec_cache(cfg, 2, 16)
    jl, jc = J_PREFILL(params, cfg, f, tok, jc)
    tc = TED.init_dec_cache(tcfg, 2, 16, "cpu")
    tl, tc = TED.encdec_prefill(model, tcfg, tt(f), torch.from_numpy(tok), tc)
    assert tl.shape == (2, 1, cfg.vocab_size)
    assert rel_err(jl, tl) <= 4e-2
    assert tc.kv_self.pos.tolist() == [8] * cfg.num_layers
    for a, b in ((jc.k_cross, tc.k_cross), (jc.v_cross, tc.v_cross)):
        assert rel_err(a, b) <= 4e-2
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = J_DECODE(params, cfg, nxt, jc)
        tl, tc = TED.encdec_decode(model, tcfg, torch.from_numpy(nxt), tc)
        assert rel_err(jl, tl) <= 4e-2
    assert tc.kv_self.pos.tolist() == [12] * cfg.num_layers


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_with_features_matches_jax(seed):
    """``generate(features=...)``, 8 prompt tokens, 8 new: each row equal
    to the reference's, or at its first difference the two tokens within
    a bf16 near tie of the full teacher-forced forward; and each served
    token the port's own teacher-forced argmax or a near tie (seeds 0-4:
    every row equal)."""
    cfg, tcfg, params, model = carried(seed)
    rng = np.random.default_rng(seed)
    f, tok = _features(rng, cfg), _tokens(rng, cfg)
    jout = np.asarray(JE.generate(params, cfg, jnp.asarray(tok), 8,
                                  features=f))
    tout = SE.generate(model, tcfg, tok, 8, features=tt(f))
    assert tout.shape == (2, 16)

    for r in range(2):  # equal, or a near tie at the first difference
        def logits(rows, r=r):
            return f32(J_TEACHER(params, cfg, f[r:r + 1], jnp.asarray(rows)))
        same_or_near_tie(logits, jout[r:r + 1], tout[r:r + 1], 8)
    t_logits = f32(TED.decode_stack(
        model, tcfg, torch.from_numpy(tout[:, :-1]),
        torch.arange(15)[None].expand(2, 15),
        TED.encode(model, tcfg, tt(f)), None, "train")[0])
    for t in range(8, 16):
        for r in range(2):
            best = int(t_logits[r, t - 1].argmax())
            assert (best == int(tout[r, t])
                    or t_logits[r, t - 1, best]
                    - t_logits[r, t - 1, tout[r, t]] < 0.15), (r, t)


# ------------------------------------------------------------ training
@pytest.mark.parametrize("seed", SEEDS)
def test_encdec_loss_and_gradients_match_jax(seed):
    """``encdec_loss`` (remat "full" on the port's layers: no value
    moves) and every parameter's gradient, ``dec_pos`` and both stacks'
    included.  Seeds 0-4: the loss within 2.4e-4 (relative; at most
    5.4e-5), each gradient within 8.6e-2 of its max|grad| (at most
    2.2e-2)."""
    cfg, tcfg, params, model = carried(seed)
    rng = np.random.default_rng(seed)
    f, tok, lab = _features(rng, cfg), _tokens(rng, cfg), _tokens(rng, cfg)
    (jl, jm), jg = J_LOSS_GRADS(params, cfg, f, tok, lab)
    model.requires_grad_(True)
    loss, tm = TED.encdec_loss(model, tcfg, tt(f), torch.from_numpy(tok),
                               torch.from_numpy(lab))
    loss.backward()
    assert set(tm) == set(jm) == {"nll", "loss"}
    assert abs(float(jl) - float(loss.detach())) <= 2.4e-4 * abs(float(jl))
    jn = T.from_tree(jg)
    named = T.param_dict(model)
    assert set(jn) == set(named) and "dec_pos" in named
    for k, p in named.items():
        assert rel_err(jn[k], p.grad) <= 8.6e-2, k


@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_matches_jax(seed):
    """Two steps of the reference's train step (AdamW, the config's) with
    ``features`` in the batch, from the carried weights: the loss and
    the grad norm within 4.5e-3 (relative; seeds 0-4: at most 1.1e-3),
    each parameter within 3 x the summed step sizes plus a bf16 ulp below
    0.5 (at most 2.0e-3)."""
    cfg, tcfg, params, model = carried(seed)
    jstep = jax.jit(JTR.make_train_step(
        cfg, schedule=JO.cosine_schedule(1e-3, 1, 2)))
    tstep = TR.make_train_step(tcfg, schedule=TO.cosine_schedule(1e-3, 1, 2))
    js = JTR.TrainState(params, JO.AdamW().init(params),
                        jnp.zeros((), jnp.int32))
    ts = TR.TrainState(model, TO.AdamW().init(T.param_dict(model)),
                       torch.zeros((), dtype=torch.int32))
    rng = np.random.default_rng(seed)
    lrs = []
    for _ in range(2):
        b = {"tokens": _tokens(rng, cfg, 4), "labels": _tokens(rng, cfg, 4),
             "features": _features(rng, cfg, 4)}
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, {**b, "features": tt(b["features"])})
        for key in ("loss", "grad_norm"):
            j, t = float(jm[key]), float(tm[key])
            assert abs(j - t) <= 4.5e-3 * abs(j), (key, j, t)
        lrs.append(float(tm["lr"]))
    bound = 3 * sum(lrs) + 2.0 ** -9
    jn = T.from_tree(js.params)
    for k, p in T.param_dict(ts.params).items():
        assert np.abs(f32(jn[k]) - f32(p)).max() <= bound, k


def test_train_state_checkpoint_round_trip(tmp_path):
    """An encoder-decoder ``TrainState`` saved by the port after one step
    and restored: ``from_checkpoint`` builds an ``EncDec`` bitwise the
    saved one; the JAX package restores the same file as its tree."""
    tcfg = get_config(ARCH).reduced()
    state = TR.init_state(tcfg, 0, "cpu")
    rng = np.random.default_rng(0)
    b = {"tokens": _tokens(rng, tcfg), "labels": _tokens(rng, tcfg),
         "features": tt(_features(rng, tcfg))}
    state, _ = TR.make_train_step(tcfg)(state, b)
    cm = TC.CheckpointManager(str(tmp_path))
    cm.save(1, TR.to_checkpoint(state))
    tree, _ = cm.restore(device="cpu")
    back = TR.from_checkpoint(tcfg, tree, "cpu")
    assert isinstance(back.params, TED.EncDec)
    for k, v in T.param_dict(state.params).items():
        assert torch.equal(v, T.param_dict(back.params)[k]), k
    jtree, _ = JC.CheckpointManager(str(tmp_path)).restore()
    assert set(T.from_tree(jtree.params)) == set(T.param_dict(back.params))


# ---------------------------------------------------------- checkpoints
def test_dec_layer_cache_checkpoint_crosses_both_ways(tmp_path):
    """A prefilled ``DecLayerCache`` (stacked self K/V, cross K/V):
    saved by the port and restored by both packages as a
    ``DecLayerCache``, then saved by the JAX package and restored by the
    port; every leaf bitwise."""
    cfg, tcfg, params, model = carried(0)
    rng = np.random.default_rng(0)
    f, tok = _features(rng, cfg), _tokens(rng, cfg)
    tc = TED.init_dec_cache(tcfg, 2, 12, "cpu")
    _, tc = TED.encdec_prefill(model, tcfg, tt(f), torch.from_numpy(tok), tc)
    TC.CheckpointManager(str(tmp_path / "t")).save(1, tc)
    back, _ = TC.CheckpointManager(str(tmp_path / "t")).restore(device="cpu")
    jback, _ = JC.CheckpointManager(str(tmp_path / "t")).restore()
    assert isinstance(back, TED.DecLayerCache)
    assert type(jback).__name__ == "DecLayerCache"
    JC.CheckpointManager(str(tmp_path / "j")).save(2, jback)
    again, _ = TC.CheckpointManager(str(tmp_path / "j")).restore(
        device="cpu")
    for got in (back, again):
        assert isinstance(got.kv_self, type(tc.kv_self))
        for a, b in zip(TC._flatten_with_paths(tc).values(),
                        TC._flatten_with_paths(got).values()):
            assert torch.equal(a, b) and a.dtype == b.dtype
    assert np.array_equal(f32(jback.k_cross), f32(tc.k_cross))
