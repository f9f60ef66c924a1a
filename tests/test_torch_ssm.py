"""Port parity for mamba2's SSD layer (``models/ssm.py``): the pieces
(``_segsum``, ``_causal_conv``, softplus), ``ssd_chunked`` (whole,
``states_only``, two halves chained through ``s0``) and its gradients,
``apply_ssm`` in train, prefill and decode, decode from a carried cache,
and the sequence-parallel SSD on 4 gloo ranks against ``shard_map`` on 4
CPU devices, forward and gradients.

The same seeded numpy inputs go through the JAX package (jitted, on the
CPU) and the port (``device="cpu"``).  fp32 paths are held to 1e-5 of
max|y| or to the largest difference seen over the seeds noted beside a
tolerance, with about 4x headroom; bf16 paths to stated tolerances (XLA
keeps excess precision inside bf16 fusions, ROADMAP.md §3).  The
multi-rank cases run once for the file (the ``seq_parallel`` fixture):
one JAX subprocess (``tests/_ssm_jax_ref.py``) and one ``RankPool``
(``tests/_ssm_ranks.py``).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _ssm_ranks  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding as TS  # noqa: E402
from repro_torch.launch import mesh as TMS  # noqa: E402
from repro_torch.models import moe_a2a as TA2A  # noqa: E402
from repro_torch.models import ssm as TM  # noqa: E402

from _lm_cases import f32, rel_err, tt  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
SEEDS = range(3)
ARCH = "mamba2-780m"
SSD_ARGS = ("x", "dt", "a", "B", "C")

J_SSD = jax.jit(JS.ssd_chunked, static_argnames=("chunk", "states_only"))
J_SSM = jax.jit(JS.apply_ssm, static_argnames=("cfg", "mode"))


def _ssd_inputs(seed, b=2, S=64, H=4, P=8, N=8, a_log_hi=0.5):
    """fp32 (x, dt, a, B, C): dt a softplus, a = -exp(a_log)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    a = -np.exp(rng.uniform(-0.5, a_log_hi, H)).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32)
    C = rng.standard_normal((b, S, N)).astype(np.float32)
    return x, dt, a, B, C


def _t(args):
    return [torch.from_numpy(np.array(a)) for a in args]


# ----------------------------------------------------------------- pieces
@pytest.mark.parametrize("seed", SEEDS)
def test_segsum_matches_jax(seed):
    x = -np.abs(np.random.default_rng(seed).standard_normal(
        (2, 3, 16))).astype(np.float32)
    j = np.asarray(jax.jit(JS._segsum)(x))
    t = TM._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(j), np.isneginf(t))
    assert np.isneginf(t[..., 0, 1]).all() and not np.isinf(t[..., 1, 0]).any()
    fin = np.isfinite(j)
    # seeds 0-4: within 2.0e-7 (XLA's cumsum adds in another order)
    assert np.abs(j[fin] - t[fin]).max() <= 8e-7 * np.abs(j[fin]).max()


@pytest.mark.parametrize("prev", [False, True], ids=["zeros", "prev"])
@pytest.mark.parametrize("seed", SEEDS)
def test_causal_conv_matches_jax(seed, prev):
    rng = np.random.default_rng(seed)
    xbc = jnp.asarray(rng.standard_normal((2, 12, 24)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 24)) * 0.5, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(24) * 0.1, jnp.float32)
    pv = (jnp.asarray(rng.standard_normal((2, 3, 24)), jnp.bfloat16)
          if prev else None)
    j = jax.jit(JS._causal_conv)(xbc, w, b, pv)
    t = TM._causal_conv(tt(xbc), tt(w), tt(b),
                        None if pv is None else tt(pv))
    assert t.dtype == torch.bfloat16
    # seeds 0-4: bitwise (the taps summed in bf16 in the reference's order)
    assert np.array_equal(f32(j), f32(t))


def test_softplus_is_bitwise_jax():
    """``softplus`` and its gradient bitwise ``jax.nn.softplus`` jitted on
    the CPU, over [-30, 40], N(0, 8) draws and the edges (the
    exp/log1p branch points, overflow, infinities, NaN)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.linspace(-30, 40, 200001), rng.standard_normal(200000) * 8,
        [-88.5, -90.0, -100.0, 89.0, 0.0, -0.0, 0.8813736, 20.0, 21.0,
         np.inf, -np.inf, np.nan]]).astype(np.float32)
    j = np.asarray(jax.jit(jax.nn.softplus)(x))
    tx = torch.from_numpy(x).requires_grad_()
    t = TM.softplus(tx)
    assert np.array_equal(j, t.detach().numpy(), equal_nan=True)
    g = np.asarray(jax.jit(jax.grad(lambda v: jax.nn.softplus(v).sum()))(x))
    t.sum().backward()
    assert np.array_equal(g, tx.grad.numpy(), equal_nan=True)
    # torch's own softplus is not the reference's above its threshold
    f = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    assert not np.array_equal(j, f, equal_nan=True)


# ------------------------------------------------------------ ssd_chunked
@pytest.mark.parametrize("seed", SEEDS)
def test_ssd_chunked_matches_jax(seed):
    """The whole scan, ``states_only`` and two halves chained through
    ``s0``, fp32: each within 1e-5 of max|y| (and of max|s|)."""
    args = _ssd_inputs(seed)
    jy, js = J_SSD(*args, chunk=16)
    ty, ts = TM.ssd_chunked(*_t(args), 16)
    assert rel_err(jy, ty) <= 1e-5 and rel_err(js, ts) <= 1e-5
    none, so = TM.ssd_chunked(*_t(args), 16, states_only=True)
    _, jso = J_SSD(*args, chunk=16, states_only=True)
    assert none is None and rel_err(jso, so) <= 1e-5
    half = args[0].shape[1] // 2
    x, dt, a, B, C = _t(args)
    y1, s1 = TM.ssd_chunked(x[:, :half], dt[:, :half], a, B[:, :half],
                            C[:, :half], 16)
    y2, s2 = TM.ssd_chunked(x[:, half:], dt[:, half:], a, B[:, half:],
                            C[:, half:], 16, s0=s1)
    assert rel_err(jy, torch.cat([y1, y2], dim=1)) <= 1e-5
    assert rel_err(js, s2) <= 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_ssd_gradients_match_jax(seed):
    """``jax.grad`` of ``sum(y * ct) + sum(s_final * cs)`` with respect to
    x, dt, a, B and C against autograd, fp32: each within 1.6e-5 of its
    max|grad| (seeds 0-4: at most 3.7e-6)."""
    args = _ssd_inputs(seed)
    rng = np.random.default_rng(seed + 10)
    ct = rng.standard_normal(args[0].shape).astype(np.float32)
    cs = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)

    def loss(*a):
        y, s = JS.ssd_chunked(*a, 16)
        return jnp.sum(y * ct) + jnp.sum(s * cs)
    jg = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*args)
    targs = [t.requires_grad_() for t in _t(args)]
    y, s = TM.ssd_chunked(*targs, 16)
    (torch.sum(y * torch.from_numpy(ct))
     + torch.sum(s * torch.from_numpy(cs))).backward()
    for name, j, t in zip(SSD_ARGS, jg, targs):
        assert rel_err(j, t.grad) <= 1.6e-5, name


def test_ssd_backward_is_finite_at_full_width_ranges():
    """The full-width chunk (128) and ranges: |a| up to e^3 (a_log up to
    3), dt softplus of N(1, 2) draws, so the masked upper triangle of
    ``_segsum`` holds differences of thousands; the gradients are finite
    (``exp`` is taken after the mask) and match ``jax.grad``'s (seed 0:
    within 2.4e-5 of max|grad|: sums over 128 positions in fp32)."""
    x, _, a, B, C = _ssd_inputs(0, b=1, S=256, H=2, P=4, N=4, a_log_hi=3.0)
    rng = np.random.default_rng(7)
    dt = np.asarray(jax.jit(jax.nn.softplus)(
        (rng.standard_normal((1, 256, 2)) * 2 + 1).astype(np.float32)))
    args = (x, dt, a, B, C)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    diff = -(np.cumsum(dt * a, axis=1)[:, -1]).max()
    assert diff > 1000  # exp of the unmasked difference would overflow
    jg = jax.jit(jax.grad(lambda *v: jnp.sum(JS.ssd_chunked(*v, 128)[0] * ct),
                          argnums=tuple(range(5))))(*args)
    targs = [t.requires_grad_() for t in _t(args)]
    torch.sum(TM.ssd_chunked(*targs, 128)[0] * torch.from_numpy(ct)).backward()
    for name, j, t in zip(SSD_ARGS, jg, targs):
        assert torch.isfinite(t.grad).all(), name
        assert rel_err(j, t.grad) <= 9.6e-5, name


# -------------------------------------------------------------- apply_ssm
def _layer(seed):
    """The reduced mamba2 layer's leaves (the JAX ``init_ssm``, a_log and
    dt_bias drawn so the decay varies by head), as JAX and port dicts."""
    cfg = jget(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    p = JL.split_params({"s": JS.init_ssm(jax.random.PRNGKey(seed),
                                          cfg)})[0]["s"]
    rng = np.random.default_rng(seed)
    p["a_log"] = jnp.asarray(rng.uniform(-1, 1, cfg.ssm_heads), jnp.float32)
    p["dt_bias"] = jnp.asarray(rng.standard_normal(cfg.ssm_heads),
                               jnp.float32)
    return cfg, tcfg, p, {k: tt(np.asarray(v)) for k, v in p.items()}


def _carried(c):
    return TM.SSMCache(tt(np.asarray(c.state)), tt(np.asarray(c.conv)))


@pytest.mark.parametrize("S", [2, 24, 32], ids=["S2", "S24", "S32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_apply_ssm_modes_match_jax(seed, S):
    """Train and prefill (S = 24 pads to whole chunks of 16; S = 2 is
    shorter than the conv window, its tail padded), the prefill's cache,
    then 3 decode steps each from the JAX package's cache carried across
    (seeds 0-4: train and prefill within 6.8e-5 of max|y|, the prefill's
    state 6.8e-7 of max|state| and conv rows 4.3e-9; every decode output
    and conv row bitwise, the state within 1.7e-7)."""
    cfg, tcfg, p, tp = _layer(seed)
    rng = np.random.default_rng(seed + 1)
    u = jnp.asarray(rng.standard_normal((2, S + 3, cfg.d_model)),
                    jnp.bfloat16)
    jy, _ = J_SSM(p, cfg, u[:, :S], None, "train")
    ty, none = TM.apply_ssm(tp, tcfg, tt(u[:, :S]))
    assert none is None and rel_err(jy, ty) <= 2.7e-4
    jy, jc = J_SSM(p, cfg, u[:, :S], JS.init_ssm_cache(cfg, 2), "prefill")
    ty, tc = TM.apply_ssm(tp, tcfg, tt(u[:, :S]),
                          TM.init_ssm_cache(tcfg, 2, "cpu"), "prefill")
    assert rel_err(jy, ty) <= 2.7e-4
    assert tc.state.dtype == torch.float32 and tc.conv.dtype == torch.bfloat16
    assert rel_err(jc.state, tc.state) <= 2.7e-6
    assert rel_err(jc.conv, tc.conv) <= 1.7e-8
    for t in range(S, S + 3):
        jy, jn = J_SSM(p, cfg, u[:, t:t + 1], jc, "decode")
        ty, tn = TM.apply_ssm(tp, tcfg, tt(u[:, t:t + 1]), _carried(jc),
                              "decode")
        assert np.array_equal(f32(jy), f32(ty)), t
        assert rel_err(jn.state, tn.state) <= 6.8e-7, t
        assert np.array_equal(f32(jn.conv), f32(tn.conv)), t
        jc = jn


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_from_carried_cache_matches_the_scan(seed):
    """The port alone: a prefill of 21 tokens, then 11 decode steps from
    its own carried cache, against train mode over all 32 tokens (the
    recurrence against the chunked scan; seeds 0-4: within 2.1e-2 of
    max|y|)."""
    _, tcfg, _, tp = _layer(seed)
    rng = np.random.default_rng(seed + 2)
    u = tt(jnp.asarray(rng.standard_normal((2, 32, tcfg.d_model)),
                       jnp.bfloat16))
    full, _ = TM.apply_ssm(tp, tcfg, u)
    y, cache = TM.apply_ssm(tp, tcfg, u[:, :21],
                            TM.init_ssm_cache(tcfg, 2, "cpu"), "prefill")
    outs = [y]
    for t in range(21, 32):
        y, cache = TM.apply_ssm(tp, tcfg, u[:, t:t + 1], cache, "decode")
        outs.append(y)
    assert rel_err(full, torch.cat(outs, dim=1)) <= 6.4e-2


# ------------------------------------------------- sequence-parallel SSD
# (mesh, batch): data 1 x model 4 (the sequence over 4 ranks), data 2 x
# model 2 (the batch over data, the sequence over 2 ranks); 64 tokens in
# chunks of 8, so 2-4 chunks a rank
SEQ_CASES = [((1, 4), 1), ((2, 2), 2)]
SEQ_CHUNK, SEQ_LEN = 8, 64
LAYER_SHAPE = (1, 4)  # the reduced mamba2 layer: 16 tokens (a chunk) a rank


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _place(blocks: list, shape, meshes) -> np.ndarray:
    out = np.zeros(shape, np.float32)
    for b, mesh in zip(blocks, meshes):
        TA2A.rank_block(out, mesh)[...] = b.numpy()
    return out


@pytest.fixture(scope="module")
def seq_parallel(tmp_path_factory):
    """Every multi-rank case, seed 0, once: the JAX subprocess and the
    4 gloo ranks.  Returns (the JAX outputs, the port's per case)."""
    tmp = tmp_path_factory.mktemp("ssd")
    rng = np.random.default_rng(0)
    src, ssd = {}, []
    for i, (shape, b) in enumerate(SEQ_CASES):
        args = _ssd_inputs(i, b=b, S=SEQ_LEN)
        ct = rng.standard_normal(args[0].shape).astype(np.float32)
        src.update({f"ssd_shape{i}": np.asarray(shape),
                    f"ssd_chunk{i}": np.asarray(SEQ_CHUNK),
                    f"ssd_ct{i}": ct})
        src.update({f"ssd_{n}{i}": v for n, v in zip(SSD_ARGS, args)})
        ssd.append((shape, args, ct))
    cfg, tcfg, p, tp = _layer(0)
    u = jnp.asarray(rng.standard_normal((2, 64, cfg.d_model)), jnp.bfloat16)
    ct = rng.standard_normal(u.shape).astype(np.float32)
    src.update({"layer_shape": np.asarray(LAYER_SHAPE), "layer_u": _bits(u),
                "layer_ct": ct})
    for k, v in p.items():
        v = np.asarray(v)
        src[f"layer_p_{k}"] = _bits(v) if v.dtype.name == "bfloat16" else v
    np.savez(tmp / "in.npz", **src)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE),
                    os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, str(HERE / "_ssm_jax_ref.py"),
                            str(tmp / "in.npz"), str(tmp / "out.npz")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        with TMS.RankPool(4, backend="gloo", device="cpu",
                          init_method=f"file://{tmp / 'store'}",
                          timeout_s=120) as pool:
            got = [pool.run(_ssm_ranks.ssd_seq_parallel,
                            dict(zip(("data", "model"), shape)), _t(args),
                            SEQ_CHUNK, torch.from_numpy(ct_))
                   for shape, args, ct_ in ssd]
            layer = pool.run(_ssm_ranks.ssm_layer,
                             dict(zip(("data", "model"), LAYER_SHAPE)),
                             tcfg, tp, tt(u), torch.from_numpy(ct))
        _, err = ref.communicate(timeout=180)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with np.load(tmp / "out.npz") as f:
        want = dict(f)
    return want, ssd, got, layer, u


def _meshes(shape):
    names = ("data", "model")
    return [TS.Mesh(dict(zip(names, shape)), r) for r in range(4)]


def test_ssd_seq_parallel_matches_jax_mesh(seq_parallel):
    """Each rank's block of y against ``_ssd_seq_parallel_call`` under the
    same 4-device mesh, fp32: within 1e-5 of max|y| (seed 0: 2.2e-7)."""
    want, ssd, got, _, _ = seq_parallel
    for i, ((shape, args, _), ranks) in enumerate(zip(ssd, got)):
        y = _place([r[0] for r in ranks], args[0].shape, _meshes(shape))
        assert rel_err(want[f"ssd_y{i}"], y) <= 1e-5, shape


def test_ssd_seq_parallel_gradients_match_jax(seq_parallel):
    """The gradients through the all-gather of the rank summaries (its
    backward a reduce-scatter): each rank's blocks of x, dt, B, C placed,
    a's summed over the ranks, against ``jax.grad`` through
    ``shard_map``: within 1e-5 of each max|grad| (seed 0: 1.4e-6, a's)."""
    want, ssd, got, _, _ = seq_parallel
    for i, ((shape, args, _), ranks) in enumerate(zip(ssd, got)):
        meshes = _meshes(shape)
        for j, name in enumerate(SSD_ARGS):
            blocks = [r[1][j] for r in ranks]
            g = (sum(b.numpy() for b in blocks) if name == "a"
                 else _place(blocks, args[j].shape, meshes))
            assert rel_err(want[f"ssd_g_{name}{i}"], g) <= 1e-5, (shape,
                                                                   name)


def test_apply_ssm_under_mesh_matches_jax(seq_parallel):
    """The reduced mamba2 layer in train mode on data 1 x model 4 (16
    tokens a rank: the conv's first rows from the previous rank, the SSD
    sequence-parallel): each rank's output block, its input gradient and
    every leaf's gradient (summed over the ranks) against the JAX
    package's ``apply_ssm`` under the same mesh (seed 0: the output within
    2.3e-3 of max|y|, the gradients 9.5e-3 of max|grad|, conv_b's)."""
    want, _, _, layer, u = seq_parallel
    meshes = _meshes(LAYER_SHAPE)
    y = _place([r[0] for r in layer], u.shape, meshes)
    gu = _place([r[1] for r in layer], u.shape, meshes)
    assert rel_err(want["layer_y"], y) <= 9.0e-3
    assert rel_err(want["layer_g_u"], gu) <= 3.8e-2
    for k in layer[0][2]:
        g = sum(r[2][k].numpy() for r in layer)
        assert rel_err(want[f"layer_g_{k}"], g) <= 3.8e-2, k
