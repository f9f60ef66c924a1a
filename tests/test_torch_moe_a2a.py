"""Port parity for expert parallelism and the sharding rules:
``models/moe_a2a.py`` on 4 gloo ranks against the JAX package's
``shard_map`` all-to-all on a mesh of 4 CPU devices, forward and
gradients, the grouped dispatch of an expert count the model axis does
not divide (4 experts on 3 ranks) against GSPMD's, ``ShardingRules``
against the JAX resolver, and the logical-axes trees
(``transformer.param_axes``, both optimizers' ``state_axes``) against the
JAX package's.

The JAX side runs in one subprocess (``tests/_moe_jax_ref.py``, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), the port's in
one ``RankPool`` of spawned ranks (``tests/_moe_ranks.py``), as
``tests/test_torch_dist.py`` does; every mesh case runs once for the
file (the ``a2a`` fixture).
"""
import dataclasses
import math
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

import _moe_ranks  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.dist import sharding as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding as TS  # noqa: E402
from repro_torch.launch import mesh as TMS  # noqa: E402
from repro_torch.models import moe_a2a as TA2A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402

from _lm_cases import carried, f32, rel_err, tt  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ARCH = "phi3.5-moe-42b-a6.6b"
LEAVES = ("router", "w_in", "w_gate", "w_out")
# seeds 0-4: every gradient within 6.5e-3 of its max|grad| (the router's
# summed over ranks in another order), the indivisible case's output within
# 3.8e-4 of max|y|; about 4x headroom
A2A_GRAD_TOL, INDIV_Y_TOL = 2.6e-2, 1.6e-3
# (mesh, skewed router, sequence): data 2 x model 2 with FSDP (D and d_ff
# divide by 2), the router pushing every token to expert 0 so pairs drop
# at the sender and at the receiver; data 1 x model 4, one expert a rank;
# data 1 x model 3, the reduced config's 4 experts indivisible (the
# grouped dispatch over every expert, each row's 12 tokens gathered from 3
# ranks)
A2A_CASES = [((2, 2), True, 16), ((1, 4), False, 16), ((1, 3), False, 12)]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _a2a_inputs(seed: int):
    """The layer's weights (the JAX ``init_lm``'s layer 0), x [4, S, D]
    and the output's cotangent for each case, as JAX arrays."""
    cfg, _, params, _ = carried(ARCH, seed)
    base = params["stacks"][0][0]["moe"]
    rng = np.random.default_rng(seed)
    cases = []
    for _, skew, S in A2A_CASES:
        x = rng.standard_normal((4, S, cfg.d_model))
        p = dict(base)
        if skew:
            x[..., 0] = 4.0
            r = np.array(base["router"].astype(jnp.float32))
            r[0] = 0.0
            r[0, 0] = 1.0
            p["router"] = jnp.asarray(r, jnp.bfloat16)
        ct = rng.standard_normal(x.shape).astype(np.float32)
        cases.append((p, jnp.asarray(x, jnp.bfloat16), ct))
    return cfg, cases


def _keep(sel: np.ndarray, tp: int, E: int, cap: int) -> tuple:
    """The reference's routing replayed in numpy, for the blocks ``sel``
    [tp, T_l, k] of the ranks of one model row: each pair kept at the
    sender (its rank among the pairs bound for its owner < cap) and at
    the receiver (its rank among the received pairs of its expert <
    C_loc).  Returns (keep [tp, T_l, k], sender drops, receiver drops)."""
    E_loc = E // tp
    n, T_l, k = sel.shape
    C_loc = max(int(np.ceil(tp * cap / E_loc)), 8)
    slots = np.full((tp, tp, cap), -1)  # [owner, source, slot] -> pair id
    sent = np.zeros(sel.shape, bool)
    for s in range(n):
        count = np.zeros(tp, int)
        for t in range(T_l):
            for j in range(k):
                o = sel[s, t, j] // E_loc
                if count[o] < cap:
                    slots[o, s, count[o]] = (s * T_l + t) * k + j
                    sent[s, t, j] = True
                count[o] += 1
    keep = np.zeros(sel.size, bool)
    for o in range(tp):
        seen = np.zeros(E_loc, int)
        for pair in slots[o].reshape(-1):
            if pair < 0:
                continue
            e = sel.reshape(-1)[pair] % E_loc
            keep[pair] = seen[e] < C_loc
            seen[e] += 1
    keep = keep.reshape(sel.shape)
    return keep, int((~sent).sum()), int((sent & ~keep).sum())


def _place_weight_grads(grads: list, meshes: list, cfg) -> dict:
    """Each rank's weight gradients as global arrays: a slice a rank holds
    alone (its experts, its FSDP block) placed, a leaf every rank holds
    whole (the router; every leaf when the experts are indivisible)
    summed over the ranks."""
    out = {}
    for name in LEAVES:
        for g, mesh in zip(grads, meshes):
            g = g[name].numpy()
            tp = mesh.shape["model"]
            if name == "router" or cfg.num_experts % tp:
                out[name] = out.get(name, 0) + g
                continue
            fsdp = TA2A.fsdp_axes(mesh, cfg, cfg.d_model)
            parts = math.prod(mesh.shape[a] for a in fsdp)
            full = out.setdefault(name, np.zeros(
                (g.shape[0] * tp, g.shape[1] * parts, g.shape[2]), np.float32))
            e0 = mesh.coords["model"] * g.shape[0]
            d0 = (mesh.index(fsdp) if fsdp else 0) * g.shape[1]
            full[e0:e0 + g.shape[0], d0:d0 + g.shape[1]] = g
    return out


def run_a2a(tmp_path, seed: int) -> list:
    """Every case on the port's 4 ranks and in the JAX subprocess; returns
    each case's dict: ``y`` (max|diff| / max|y|), ``aux`` (the aux's
    relative difference), ``sender`` and ``receiver`` (the pairs dropped,
    for the all-to-all cases), and ``grads`` (each gradient's max|diff| /
    its max|grad|, x's and each leaf's)."""
    cfg, cases = _a2a_inputs(seed)
    tcfg = get_config(ARCH).reduced()
    assert cfg.fsdp and tcfg.fsdp
    src = {}
    for i, ((shape, _, _), (p, x, ct)) in enumerate(zip(A2A_CASES, cases)):
        src[f"shape{i}"] = np.asarray(shape)
        src[f"x{i}"] = _bits(x)
        src[f"ct{i}"] = ct
        for name in LEAVES:
            src[f"{name}{i}"] = _bits(p[name])
    np.savez(tmp_path / "in.npz", **src)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE),
                    os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, str(HERE / "_moe_jax_ref.py"),
                            str(tmp_path / "in.npz"),
                            str(tmp_path / "out.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        with TMS.RankPool(4, backend="gloo", device="cpu",
                          init_method=f"file://{tmp_path / 'store'}",
                          timeout_s=120) as pool:
            got = [[r for r in pool.run(
                _moe_ranks.moe_layer, dict(zip(("data", "model"), shape)),
                tcfg, {k: tt(v) for k, v in p.items()}, tt(x),
                torch.from_numpy(ct)) if r is not None]
                for (shape, _, _), (p, x, ct) in zip(A2A_CASES, cases)]
        _, err = ref.communicate(timeout=180)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with np.load(tmp_path / "out.npz") as f:
        want = dict(f)
    stats = []
    for i, ((shape, skew, _), (p, x, _)) in enumerate(zip(A2A_CASES,
                                                         cases)):
        mesh_shape = dict(zip(("data", "model"), shape))
        y = np.zeros(want[f"y{i}"].shape, np.float32)
        gx = np.zeros(want[f"g_x{i}"].shape, np.float32)
        sels, auxes, meshes = {}, [], []
        for rank, (block, aux, coords, _, gxb) in enumerate(got[i]):
            mesh = TS.Mesh(mesh_shape, rank)
            meshes.append(mesh)
            assert coords == mesh.coords
            TA2A.rank_block(y, mesh)[...] = block.numpy()
            TA2A.rank_block(gx, mesh)[...] = gxb.numpy()
            auxes.append(aux)
            xb = TA2A.rank_block(f32(x), mesh)
            logits = (jnp.asarray(xb, jnp.bfloat16) @ p["router"]).astype(
                jnp.float32)
            sels.setdefault(mesh.coords["data"], {})[mesh.coords["model"]] = \
                np.asarray(jax.lax.top_k(logits, 2)[1]).reshape(-1, 2)
        jy, jaux = want[f"y{i}"], float(want[f"aux{i}"])
        assert len(set(auxes)) == 1  # every rank holds the global aux
        gw = _place_weight_grads([r[3] for r in got[i]], meshes, tcfg)
        grads = {"x": rel_err(want[f"g_x{i}"], gx)}
        grads.update({name: rel_err(want[f"g_{name}{i}"], gw[name])
                      for name in LEAVES})
        res = {"y": float(np.abs(jy - y).max() / np.abs(jy).max()),
               "aux": abs(auxes[0] - jaux) / jaux, "grads": grads}
        tp = shape[1]
        if cfg.num_experts % tp == 0:
            T_l = x.size // cfg.d_model // (shape[0] * tp)
            cap = max(int(np.ceil(cfg.capacity_factor * T_l * 2 / tp)), 8)
            drops = [_keep(np.stack([row[m] for m in range(tp)]), tp,
                           cfg.num_experts, cap)[1:] for row in sels.values()]
            res["sender"], res["receiver"] = (sum(d[j] for d in drops)
                                              for j in (0, 1))
        stats.append(res)
    return stats


@pytest.fixture(scope="module")
def a2a(tmp_path_factory):
    """Every mesh case of seed 0, run once for the file."""
    return run_a2a(tmp_path_factory.mktemp("a2a"), 0)


def test_moe_a2a_matches_jax_mesh(a2a):
    """The layer on data 2 x model 2 (FSDP, skewed router: pairs drop at
    the sender and at the receiver, as the numpy replay of the routing
    counts them) and on data 1 x model 4: every rank's output block
    against the JAX package's ``apply_moe`` under the same mesh, and the
    global aux (every rank the same).  Seed 0; seeds 0-4 (3-9 pairs
    dropped at the senders, 18-22 at the receivers of the skewed case):
    the output bitwise but for 2.3e-8 and 3.8e-4 of max|y| (a bf16 ulp
    of a product), the aux within 1.2e-7 (relative)."""
    skewed, plain = a2a[:2]
    assert skewed["sender"] > 0 and skewed["receiver"] > 0
    assert max(skewed["y"], plain["y"]) <= 1.6e-3
    assert max(skewed["aux"], plain["aux"]) <= 4.8e-7


def test_moe_a2a_gradients_match_jax(a2a):
    """The backward through the all-to-alls and the FSDP all-gather (each
    rank's share of ``sum(y * ct) + aux``): x's gradient and every leaf's
    (a rank's expert slices placed, the router's summed over the ranks)
    against ``jax.grad`` through ``shard_map``, of each max|grad|.
    Seeds 0-4: at most 6.5e-3 (the router's, summed in another order);
    the experts' mostly bitwise."""
    for case in a2a[:2]:
        assert max(case["grads"].values()) <= A2A_GRAD_TOL, case["grads"]


def test_indivisible_experts_match_jax_mesh(a2a):
    """4 experts on a model axis of 3: each row's tokens gathered from the
    3 ranks, dispatched over every expert and this rank's block kept,
    against GSPMD's grouped dispatch under the same mesh; the output, the
    aux and the gradients (seeds 0-4: the output within 3.8e-4 of max|y|,
    the aux 1.2e-7, the gradients 6.4e-3 of max|grad|)."""
    case = a2a[2]
    assert case["y"] <= INDIV_Y_TOL and case["aux"] <= 4.8e-7
    assert max(case["grads"].values()) <= A2A_GRAD_TOL, case["grads"]


def test_mesh_coordinates_and_groups(tmp_path):
    """``Mesh.build`` on 4 gloo ranks as data 2 x model 2: row-major
    coordinates, and an all-gather over each axis returns the ranks of
    that row or column, in coordinate order."""
    with TMS.RankPool(4, backend="gloo", device="cpu",
                      init_method=f"file://{tmp_path / 'store'}",
                      timeout_s=120) as pool:
        got = pool.run(_moe_ranks.mesh_groups, {"data": 2, "model": 2})
    for rank, (coords, by_axis) in enumerate(got):
        d, m = divmod(rank, 2)
        assert coords == {"data": d, "model": m}
        assert by_axis["data"] == [m, 2 + m]
        assert by_axis["model"] == [2 * d, 2 * d + 1]
        assert by_axis["data,model"] == [0, 1, 2, 3]


# -------------------------------------------------------- sharding rules
def _jax_axes(cfg):
    """The reference's logical-axes tree of ``cfg``'s parameters (traced,
    never allocated)."""
    out = {}

    def values(key):
        vals, axes = JL.split_params(JT.init_lm(key, cfg))
        out["axes"] = axes
        return vals
    shapes = jax.eval_shape(values, jax.random.PRNGKey(0))
    return out["axes"], shapes


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=JO.is_axes)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2), (4, 1)])
def test_sharding_rules_resolve_matches_jax(mesh_shape):
    """Every parameter of phi3.5-moe at full width (a 32-layer scan stack)
    and of qwen3-4b, resolved on the mesh: the port's tuples equal
    ``tuple(P(...))`` of the JAX resolver, and the fallback logs are
    equal entry for entry; an ``override`` to replicate the experts."""
    names = ("data", "model")
    tmesh = TS.Mesh(dict(zip(names, mesh_shape)))

    class _Shape:  # the JAX resolver reads only ``mesh.shape``
        shape = dict(zip(names, mesh_shape))
    for arch in (ARCH, "qwen3-4b"):
        axes, shapes = _jax_axes(jget(arch))
        pairs = list(zip(_leaves(axes), jax.tree.leaves(shapes)))
        for jr, tr in ((JS.ShardingRules(), TS.ShardingRules()),
                       (JS.ShardingRules().override(experts=((),)),
                        TS.ShardingRules().override(experts=((),)))):
            for i, (ax, sd) in enumerate(pairs):
                want = tuple(jr.resolve(_Shape, ax, sd.shape, tag=str(i)))
                got = tr.resolve(tmesh, ax, sd.shape, tag=str(i))
                assert got == want, (arch, ax, sd.shape)
            assert tr.log == jr.log and tr.log is not None


@pytest.mark.parametrize("layers", [2, 8, 32])
def test_param_axes_matches_jax(layers):
    """``transformer.param_axes`` is the reference's axes tree (list and
    scan layouts), and names every parameter the port's model has."""
    cfg = dataclasses.replace(jget(ARCH), num_layers=layers)
    tcfg = dataclasses.replace(get_config(ARCH), num_layers=layers)
    axes, _ = _jax_axes(cfg)
    got = T.param_axes(tcfg)
    assert got == axes
    named = T.param_dict(T.init_lm(tcfg, device="meta"))
    flat = {}

    def walk(prefix, node):
        if TO.is_axes(node):
            flat[prefix[:-1]] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        else:
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
    walk("", got)
    assert set(flat) == set(named)
    assert all(len(flat[k]) == t.ndim for k, t in named.items())


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", [ARCH, "qwen3-4b"])
def test_state_axes_match_jax(arch, optimizer):
    """Both optimizers' ``state_axes`` and the trainer's ``state_axes``
    (the second value of the reference's ``init_state``) equal the JAX
    trees, and ``is_axes`` agrees on every node."""
    cfg = dataclasses.replace(jget(arch).reduced(), optimizer=optimizer,
                              num_layers=8)
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               optimizer=optimizer, num_layers=8)
    axes, _ = _jax_axes(cfg)
    jopt, topt = JO.get_optimizer(optimizer), TO.get_optimizer(optimizer)
    assert topt.state_axes(T.param_axes(tcfg)) == jopt.state_axes(axes)
    _, jstate_axes = JTR.init_state(cfg, jax.random.PRNGKey(0))
    assert TR.state_axes(tcfg) == jstate_axes
    for x in [(), (None,), ("a", None), ("a", 1), [("a",)], {"a": ("b",)}]:
        assert TO.is_axes(x) == JO.is_axes(x), x
