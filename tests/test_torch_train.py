"""Port parity for LM training, piece by piece: the data pipeline, the
schedule and the clip, AdamW and Adafactor, the losses, the flash
attention backward, and the gradient compression (``ef_compress`` and
``compressed_psum`` over 4 gloo ranks against ``shard_map`` on 4 CPU
devices).

The same seeded inputs go through the JAX package (jitted, on the CPU,
unless a test says otherwise) and the port (``device="cpu"``).  Each
tolerance is the largest difference seen over seeds 0-4 (noted beside
it) with about 4x headroom, or a count of float32 ulps.  Under ``jit``
XLA's CPU backend contracts ``a * b + c`` into one fused multiply-add
(checked: the reference's AdamW ``b1 * m + (1 - b1) * g`` is
``fma(b1, m, round((1 - b1) * g))`` on every element of seeds 0-4), while
the port's torch ops round each product, as the jnp source is written;
so the optimizers are held bitwise to the op-by-op (eager) JAX functions
and to the jitted ones within ulps.  The gradient compression is spelled
as the jitted function computes it (``dist/compression.py``) and is held
bitwise to it.
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
import ml_dtypes  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.dist import compression as JC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.dist import compression as TC  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

import _train_ranks  # noqa: E402
from _lm_cases import f32, rel_err, tt  # noqa: E402

SEEDS = range(5)
HERE = pathlib.Path(__file__).resolve().parent


def ulps(a, b) -> int:
    """The largest distance between ``a`` and ``b`` in float32 ulps."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def bf16_ulps(a, b) -> int:
    def ordered(x):
        i = np.asarray(x).astype(ml_dtypes.bfloat16).view(np.uint16)
        i = i.astype(np.int64)
        return np.where(i >= 0x8000, -(i & 0x7FFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def ulps_of(a, b) -> int:
    """``ulps`` or ``bf16_ulps`` by the port tensor ``b``'s dtype."""
    return (bf16_ulps if b.dtype == torch.bfloat16 else ulps)(
        f32(a), f32(b))


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_batches_byte_identical(seed, tmp_path):
    """SyntheticSource and FileSource batches, sharded, and across a
    snapshot/restore, are the reference's bytes."""
    src = (JD.SyntheticSource(1000, 16, seed), TD.SyntheticSource(1000, 16, seed))
    path = tmp_path / "tokens.bin"
    np.random.default_rng(seed).integers(0, 60000, 4000).astype(
        np.uint16).tofile(path)
    files = (JD.FileSource(str(path), 60000, 32), TD.FileSource(str(path),
                                                                60000, 32))
    for js, ts in (src, files):
        for shard in range(2):
            jp = JD.DataPipeline(js, 8, shard_index=shard, num_shards=2)
            tp = TD.DataPipeline(ts, 8, shard_index=shard, num_shards=2)
            for i in range(5):
                if i == 3:  # resume a fresh pipeline from the snapshot
                    snap = tp.snapshot()
                    assert snap == jp.snapshot()
                    tp = TD.DataPipeline(ts, 8, shard_index=shard,
                                         num_shards=2)
                    tp.restore(snap)
                jb, tb = jp.next_batch(), tp.next_batch()
                for k in ("tokens", "labels"):
                    assert tb[k].dtype == jb[k].dtype == np.int32
                    assert tb[k].tobytes() == jb[k].tobytes(), (shard, i, k)
            assert tp.state.offset == jp.state.offset == 40
    with pytest.raises(ValueError, match="does not split"):
        TD.DataPipeline(src[1], 6, num_shards=4)


# ------------------------------------------------------ schedule and clip
@pytest.mark.parametrize("base,warmup,total", [(3e-4, 10, 100), (1e-3, 1, 7),
                                               (3e-4, 5, 50)])
def test_cosine_schedule(base, warmup, total):
    j = jax.jit(JO.cosine_schedule(base, warmup, total))
    t = TO.cosine_schedule(base, warmup, total)
    for step in range(total + 3):
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        # within one float32 ulp of base_lr (XLA's cos and its fused
        # products against torch's)
        assert abs(float(got) - float(j(step))) <= base * 2.0 ** -23, step


def _tree(rng) -> dict:
    """A value tree of the reference's kinds of leaf: bf16 matrices,
    fp32 vectors, a stacked [L, ...] stack and a tuple stack, a matrix
    with a dim of 1 (not factored by Adafactor)."""
    return {"embed": rng.standard_normal((32, 16)).astype(ml_dtypes.bfloat16),
            "final_norm": rng.uniform(0.5, 1.5, 16).astype(np.float32),
            "stacks": (
                {"norm1": rng.uniform(0.5, 1.5, (8, 16)).astype(np.float32),
                 "attn": {"w_q": (rng.standard_normal((8, 16, 24)) * 0.2
                                  ).astype(ml_dtypes.bfloat16),
                          "q_norm": rng.uniform(0.5, 1.5, (8, 4)
                                                ).astype(np.float32)}},
                ({"w": rng.standard_normal((16, 1)).astype(np.float32),
                  "v": rng.standard_normal(5).astype(np.float32)},))}


def _grads(rng, tree, n):
    return [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.01
                                    ).astype(x.dtype), tree)
            for _ in range(n)]


def _named(tree) -> dict:
    return {k: tt(v).clone() for k, v in T.from_tree(tree).items()}


@pytest.mark.parametrize("max_norm", [1e-3, 10.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_global_norm_and_clip(seed, max_norm):
    rng = np.random.default_rng(seed)
    g = _grads(rng, _tree(rng), 1)[0]
    jg, jn = jax.jit(lambda t: JO.clip_by_global_norm(t, max_norm))(g)
    tg = _named(g)
    out, tn = TO.clip_by_global_norm(tg, max_norm)
    assert out is tg  # in place
    # seeds 0-4: the norm within 3 ulps (the sum's order), the clipped
    # leaves within 5 (the scale's ulps), the bf16 leaves bitwise
    assert ulps(jn, tn.numpy()) <= 12
    for k, v in T.from_tree(jg).items():
        assert tg[k].dtype == tt(v).dtype
        assert ulps_of(v, tg[k]) <= (0 if tg[k].dtype == torch.bfloat16
                                     else 20), k


# ------------------------------------------------------------- optimizers
OPTS = {"adamw": {}, "adafactor": {}, "adafactor_wd": {"weight_decay": 0.1}}


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("name", list(OPTS))
@pytest.mark.parametrize("seed", SEEDS)
def test_optimizer_three_updates(seed, name, jit):
    """3 updates from the same params, grads and state: the parameters,
    every moment and the step.  Covers AdamW's decay on ``ndim >= 2``
    only (the stacked norm scales are decayed, the vectors not) and
    Adafactor's factored (stacked, 2-D) and unfactored (1-D, a dim of 1)
    leaves."""
    kind = name.split("_")[0]
    jopt = {"adamw": JO.AdamW, "adafactor": JO.Adafactor}[kind](**OPTS[name])
    topt = TO.get_optimizer(kind, **OPTS[name])
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    jp, js = params, jopt.init(params)
    tp = _named(params)
    ts = topt.init(tp)
    update = jax.jit(jopt.update) if jit else jopt.update
    for i, g in enumerate(_grads(rng, params, 3)):
        lr = np.float32(1e-2 * (i + 1))
        jp, js = update(g, js, jp, jnp.float32(lr))
        out, ts = topt.update(_named(g), ts, tp, torch.tensor(lr))
        assert out is tp
    assert int(ts.step) == int(js.step) == 3
    worst = {"params": 0, "state": 0}
    for k, v in T.from_tree(jp).items():
        assert tp[k].dtype == tt(v).dtype
        worst["params"] = max(worst["params"], ulps_of(v, tp[k]))
    for field in ts._fields[1:]:
        for k, v in T.from_tree(getattr(js, field)).items():
            t = getattr(ts, field)[k]
            assert t.shape == v.shape and t.dtype == torch.float32
            if kind == "adamw" and jit:  # fused vs rounded: near-zero
                # moments are many ulps apart; seeds 0-4: 1.7e-7 of max
                assert rel_err(v, t) <= 7e-7, (field, k)
            else:
                worst["state"] = max(worst["state"], ulps(v, t.numpy()))
    if kind == "adamw" and not jit:
        # the op-by-op reference: seeds 0-4 bitwise
        assert worst == {"params": 0, "state": 0}
    else:
        # seeds 0-4: params at most 12 ulps (jit, an fp32 leaf) and 1 bf16
        # ulp; Adafactor's moments at most 3 ulps (its means' order)
        assert worst["params"] <= 48 and worst["state"] <= 12, worst


def test_adafactor_factoring_follows_the_leaf_shapes():
    params = _named(_tree(np.random.default_rng(0)))
    st = TO.Adafactor().init(params)
    assert tuple(st.vr["stacks.0.norm1"].shape) == (8,)  # [L, d] factored
    assert tuple(st.vc["stacks.0.norm1"].shape) == (16,)
    assert tuple(st.vr["stacks.0.attn.w_q"].shape) == (8, 16)
    assert tuple(st.vc["stacks.0.attn.w_q"].shape) == (8, 24)
    assert tuple(st.v["stacks.1.0.w"].shape) == (16, 1)  # a dim of 1
    assert tuple(st.v["final_norm"].shape) == (16,)
    assert tuple(st.v["embed"].shape) == (1,)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("seed", SEEDS)
def test_chunked_softmax_xent(seed, z_loss):
    """S = 24 with chunk 10: the reference's ``c -= 1`` search picks 8."""
    rng = np.random.default_rng(seed)
    B, S, D, V = 2, 24, 32, 96
    h = jnp.asarray(rng.standard_normal((B, S, D)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((D, V)) * 0.2, jnp.bfloat16)
    y = rng.integers(0, V, (B, S)).astype(np.int32)
    jl, (jh, jw) = jax.jit(jax.value_and_grad(
        lambda h, w: JL.chunked_softmax_xent(h, w, y, chunk=10,
                                             z_loss=z_loss),
        argnums=(0, 1)))(h, w)
    th, tw = tt(h).requires_grad_(), tt(w).requires_grad_()
    tl = TL.chunked_softmax_xent(th, tw, torch.from_numpy(y), chunk=10,
                                 z_loss=z_loss)
    tl.backward()
    assert tl.dtype == torch.float32 and tl.ndim == 0
    # seeds 0-4: the loss within 9.4e-8 (relative), the gradients 2.3e-3
    # and 2.8e-4 of max|grad| (one bf16 ulp of a few entries)
    assert abs(float(jl) - tl.item()) <= 4e-7 * abs(float(jl))
    assert rel_err(jh, th.grad) <= 9.2e-3
    assert rel_err(jw, tw.grad) <= 1.2e-3


def test_chunked_loss_recomputes_each_chunk():
    """Each chunk's logits are recomputed in the backward: saved tensors
    stay O(chunk * V), not O(S * V)."""
    B, S, D, V, c = 2, 64, 16, 1000, 8
    h = torch.randn(B, S, D, requires_grad=True)
    w = torch.randn(D, V, requires_grad=True)
    y = torch.randint(0, V, (B, S))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TL.chunked_softmax_xent(h, w, y, chunk=c)
    assert max(saved) < B * S * V  # a full logits tensor is never saved
    loss.backward()
    assert torch.isfinite(h.grad).all() and torch.isfinite(w.grad).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("seed", SEEDS)
def test_cross_entropy(seed, z_loss, masked):
    rng = np.random.default_rng(seed)
    logits = jnp.asarray(rng.standard_normal((2, 24, 96)) * 3, jnp.bfloat16)
    y = rng.integers(0, 96, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.7).astype(np.float32) if masked else None
    jl, jg = jax.jit(jax.value_and_grad(lambda lg: JL.cross_entropy(
        lg, y, None if mask is None else jnp.asarray(mask),
        z_loss=z_loss)))(logits)
    tl_in = tt(logits).requires_grad_()
    tl = TL.cross_entropy(tl_in, torch.from_numpy(y),
                          None if mask is None else torch.from_numpy(mask),
                          z_loss=z_loss)
    tl.backward()
    # seeds 0-4: the loss within 2.3e-7 (relative), the gradient 1.5e-5 of
    # max|grad|
    assert abs(float(jl) - tl.item()) <= 1e-6 * abs(float(jl))
    assert rel_err(jg, tl_in.grad) <= 6e-5


# ----------------------------------------------------------------- flash
FLASH_CASES = [(True, 0, 40, 40), (False, 0, 24, 40), (True, 8, 24, 40)]


@pytest.mark.parametrize("causal,q_offset,sq,sk", FLASH_CASES,
                         ids=["causal", "full", "causal-offset"])
@pytest.mark.parametrize("seed", SEEDS)
def test_flash_forward_and_backward(seed, causal, q_offset, sq, sk):
    """GQA (4 query heads on 2 KV heads), chunk 16 over 40 keys (the last
    chunk padded): ``(out, lse)`` and the autograd backward against the
    reference's ``_flash_scan`` and ``jax.vjp`` of its
    ``flash_attention`` (the ``custom_vjp``), and against autograd
    through the port's dense attention."""
    rng = np.random.default_rng(seed)
    chunk = 16

    def bf(*shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    q, k, v, do = bf(1, sq, 4, 16), bf(1, sk, 2, 16), bf(1, sk, 2, 16), \
        bf(1, sq, 4, 16)

    def jflash(q, k, v):
        return JA.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  chunk=chunk)
    jo, jlse = jax.jit(lambda q, k, v: JA._flash_scan(
        q, k, v, causal, q_offset, chunk))(q, k, v)
    jgrads = jax.jit(lambda q, k, v, do: jax.vjp(jflash, q, k, v)[1](do))(
        q, k, v, do)
    tq, tk, tv = (tt(a).requires_grad_() for a in (q, k, v))
    to, tlse = TA._flash_scan(tq.detach(), tk.detach(), tv.detach(), causal,
                              q_offset, chunk)
    out = TA.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                             chunk=chunk)
    assert torch.equal(out, to) and out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, (tq, tk, tv), tt(do))
    # seeds 0-4: out within 5.9e-4 of max|out|, lse within 4.8e-7, dq/dk/dv
    # within 1.0e-3 of max|grad| (one bf16 ulp of a few entries: XLA's
    # fused multiply-adds; the op-by-op reference gives out bitwise)
    assert rel_err(jo, to) <= 2.4e-3
    assert np.abs(f32(jlse) - tlse.numpy()).max() <= 2e-6
    for a, b in zip(jgrads, grads):
        assert b.dtype == torch.bfloat16 and b.shape == tuple(a.shape)
        assert rel_err(a, b) <= 4.1e-3
    qp = q_offset + np.arange(sq)
    allow = (np.arange(sk)[None, :] <= qp[:, None]) if causal else \
        np.ones((sq, sk), bool)
    dense = TA.dense_attention(tq, tk, tv, torch.from_numpy(allow)[None, None,
                                                                  None])
    dgrads = torch.autograd.grad(dense, (tq, tk, tv), tt(do))
    # seeds 0-4: out within 9.5e-3 and the gradients 7.8e-3 of max|.| (the
    # online softmax's other roundings); chip_smoke.py's
    # LM_FLASH_GRAD_TOL is this tolerance
    assert rel_err(dense, out) <= 3.2e-2
    for a, b in zip(dgrads, grads):
        assert rel_err(a, b) <= 3.2e-2


def test_flash_saves_only_its_inputs_and_outputs():
    """The autograd graph keeps (q, k, v, out, lse), never a score chunk."""
    q = torch.randn(1, 64, 4, 8, requires_grad=True)
    k = torch.randn(1, 64, 2, 8, requires_grad=True)
    v = torch.randn(1, 64, 2, 8, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = TA.flash_attention(q, k, v, chunk=16)
    assert sorted(saved) == sorted([(1, 64, 4, 8), (1, 64, 2, 8),
                                    (1, 64, 2, 8), (1, 64, 4, 8),
                                    (1, 2, 2, 64)])
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("seed", SEEDS)
def test_ef_compress_bitwise(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 33)) * 0.1).astype(np.float32)
    e = (rng.standard_normal((64, 33)) * 1e-3).astype(np.float32)
    for err in (None, e):
        jd, je = jax.jit(JC.ef_compress)(x, err)
        td, te = TC.ef_compress(torch.from_numpy(x),
                                None if err is None else torch.from_numpy(err))
        assert np.asarray(jd).tobytes() == td.numpy().tobytes()
        assert np.asarray(je).tobytes() == te.numpy().tobytes()
    jq, js = jax.jit(JC.quantize_int8)(x)
    tq, ts = TC.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and np.array_equal(np.asarray(jq), tq.numpy())
    assert np.float32(js) == ts.numpy()
    # a tree: the port's parameter dict, zero errors to start, then carried
    tree = _tree(rng)
    g = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    jd, je = jax.jit(JC.ef_compress_tree)(g, None)
    jd, je = jax.jit(JC.ef_compress_tree)(jd, je)
    named = {k: torch.from_numpy(np.array(v)) for k, v in
             T.from_tree(g).items()}
    td, te = TC.ef_compress_tree(named, None)
    td, te = TC.ef_compress_tree(td, te)
    for want, got in ((jd, td), (je, te)):
        for k, v in T.from_tree(want).items():
            assert np.asarray(v).tobytes() == got[k].numpy().tobytes(), k


_PSUM_JAX = '''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist.compat import shard_map
from repro.dist.compression import compressed_psum
xs, errors = np.load(sys.argv[1])["xs"], np.load(sys.argv[1])["errors"]
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))

def body(x, e):
    mean, res = compressed_psum(x[0], "data", e if e is None else e[0])
    return mean[None], res[None]

def run(x, e):
    spec = P("data")
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                             out_specs=(spec, spec)))(x, e)

out, err = {}, None
for i, x in enumerate(xs):
    e = errors if i == 1 else err
    if e is None:
        mean, err = jax.jit(shard_map(lambda x: body(x, None), mesh=mesh,
                                      in_specs=(P("data"),),
                                      out_specs=(P("data"), P("data"))))(x)
    else:
        mean, err = run(x, e)
    out[f"mean{i}"], out[f"res{i}"] = np.asarray(mean), np.asarray(err)
np.savez(sys.argv[2], **out)
'''


def test_compressed_psum_matches_shard_map(tmp_path):
    """3 rounds (no residual, a given one, the carried one) on 4 gloo
    ranks against the reference inside ``shard_map`` on 4 CPU devices:
    every rank's mean and residual bitwise."""
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((3, 4, 24, 17)) * 0.1).astype(np.float32)
    errors = (rng.standard_normal((4, 24, 17)) * 1e-3).astype(np.float32)
    np.savez(tmp_path / "in.npz", xs=xs, errors=errors)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), os.environ.get("PYTHONPATH",
                                                             "")]))
    ref = subprocess.Popen([sys.executable, "-c", _PSUM_JAX,
                            str(tmp_path / "in.npz"),
                            str(tmp_path / "out.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        with TM.RankPool(4, backend="gloo", device="cpu",
                         init_method=f"file://{tmp_path / 'store'}",
                         timeout_s=120) as pool:
            got = pool.run(_train_ranks.psum_rounds, xs, errors)
        _, err = ref.communicate(timeout=120)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with np.load(tmp_path / "out.npz") as f:
        want = dict(f)
    for rank, rounds in enumerate(got):
        for i, (mean, res) in enumerate(rounds):
            assert mean.tobytes() == want[f"mean{i}"][rank].tobytes(), (rank, i)
            assert res.tobytes() == want[f"res{i}"][rank].tobytes(), (rank, i)
    # every rank holds the same mean
    assert all(np.array_equal(r[2][0], got[0][2][0]) for r in got)
