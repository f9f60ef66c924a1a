"""Parity of the port's roofline (``repro_torch/roofline/``) with the JAX
package's, on the CPU.

  * ``_wire_bytes``, ``parse_collectives`` and ``model_flops`` are
    arithmetic and text parsing: equal to the reference's exactly;
  * each layer kind's probe (the port's code on meta tensors under
    ``CostMode``) against the reference's probe on a one-device mesh, at
    full width and S 512: the products equal the reference function's
    jaxpr products exactly (what it asks for before XLA optimises), and
    the total is held to XLA's ``cost_analysis`` within ``TOL`` after
    the named gaps of each case;
  * the optimizer probe's one-piece count on meta against the pieced
    update run on real tensors;
  * the engine tick's recorded wire against the reference's
    ``analyze(compiled)`` at 4 workers (a JAX subprocess on 4 CPU
    devices, ``tests/_roofline_jax_ref.py``).

Run with ``-s`` to see each probe's FLOPs and its eager bytes over XLA's.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import _roofline_ref as R  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.roofline import analysis as JA  # noqa: E402
from repro.roofline import probes as JP  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_graph_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.roofline import analysis as TA  # noqa: E402
from repro_torch.roofline import probes as TP  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
PORT = HERE.parent / "src" / "repro_torch"

# copied from tests/test_roofline.py
HLO_SAMPLE = """
  %all-reduce = f32[1024]{0} all-reduce(%x), channel_id=1, replica_groups=[4,2]<=[8], use_global_device_ids=true, to_apply=%add
  %ag = bf16[8,128]{1,0} all-gather(%y), channel_id=2, replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[64]{0} reduce-scatter(%z), channel_id=3, replica_groups=[1,8]<=[8], to_apply=%add
  %a2a = bf16[16,32]{1,0} all-to-all(%w), channel_id=4, replica_groups=[2,4]<=[8]
  %cp = f32[256]{0} collective-permute(%v), channel_id=5, source_target_pairs={{0,1}}
  %ard = f32[12]{0} all-reduce-done(%ar)
"""


def _as_dicts(cols) -> list:
    return [dataclasses.asdict(c) for c in cols]


@pytest.mark.parametrize("op", JA.COLLECTIVE_OPS + ("unknown",))
def test_wire_bytes_match_jax(op):
    for n in (1, 2, 4, 16):
        for b in (0, 1, 1000, 4096, 1 << 31):
            assert TA._wire_bytes(op, b, n) == JA._wire_bytes(op, b, n)


def test_parse_collectives_matches_jax():
    assert _as_dicts(TA.parse_collectives(HLO_SAMPLE)) == \
        _as_dicts(JA.parse_collectives(HLO_SAMPLE))
    for dt, dims in (("bf16", "8,128"), ("f32", ""), ("s8", "3"),
                     ("weird", "2,2")):
        assert TA._shape_bytes(dt, dims) == JA._shape_bytes(dt, dims)


def test_parse_collectives_of_a_compiled_module_matches_jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.compat import shard_map
    mesh = jax.sharding.Mesh(jax.devices()[:1], ("d",))

    def f(x):
        return jax.lax.psum(x, "d"), jax.lax.all_gather(x, "d")

    text = jax.jit(shard_map(f, mesh=mesh, in_specs=P(), out_specs=P(),
                             check_vma=False)
                   ).lower(jnp.zeros((128,), jnp.float32)).compile().as_text()
    assert _as_dicts(TA.parse_collectives(text)) == \
        _as_dicts(JA.parse_collectives(text))


def test_model_flops_match_jax():
    for arch in list_archs():
        for name in J_SHAPES:
            jc, tc = j_config(arch), t_config(arch)
            sh = J_SHAPES[name]
            assert TA.model_flops(tc, T_SHAPES[name], sh.kind) == \
                JA.model_flops(jc, sh, sh.kind), (arch, name)


def test_analyze_terms_on_the_cards_peaks():
    cols = TA.parse_collectives(HLO_SAMPLE)
    r = TA.analyze({"flops": 989e12, "bytes": 3.35e12, "collectives": cols})
    assert r.compute_s == 1.0 and r.memory_s == 1.0
    assert r.collective_s == sum(c.wire_bytes for c in cols) / 450e9
    assert r.dominant == "compute"
    lm = TA.analyze({"flops": 1.0, "bytes": 3.35e13, "collectives": None})
    assert lm.collective_wire_bytes is None and lm.collective_s is None
    assert lm.dominant == "memory"
    assert set(r.to_dict()) == {f.name for f in dataclasses.fields(
        JA.Roofline)}


def test_no_tpu_constant_in_the_port():
    """The reference's v5e peaks (197e12, 819e9, 50e9) appear nowhere in
    the port."""
    tpu = re.compile(r"(?<![\d.])(197e12|819e9|50e9)\b|ICI_BW")
    for f in PORT.rglob("*.py"):
        assert not tpu.search(f.read_text()), f


# ----------------------------------------------------------------------
# Probes: one per layer kind, full width, B 1, S 512
# ----------------------------------------------------------------------
B, S = 1, 512
# the total is held to XLA's within this, after each case's named gap
TOL = 0.03


def _dead_forward(cfg, d_in: int) -> float:
    """The forward of a layer's last product, ``[B*S, d_in] @ [d_in, D]``:
    its value feeds only the summed output whose gradient the probe asks
    for, so after differentiation XLA drops it as dead code; the port's
    eager forward computes it."""
    return 2.0 * B * S * d_in * cfg.d_model


# name, arch, kind, window, dense d_ff, the port's FLOPs minus XLA's
# that the named gap explains (as a function of the config)
LAYER_CASES = [
    # the MLP's w_out forward
    ("dense", "qwen3-4b", "dense", 0, False,
     lambda c: _dead_forward(c, c.d_ff)),
    # the routed combine comes last, not a product: no dead forward
    ("moe", "phi3.5-moe-42b-a6.6b", "moe", 0, False, lambda c: 0.0),
    # the out_proj forward; and XLA:CPU computes its bf16 dots in f32,
    # converting every operand (1.70e9 converted elements, 1 FLOP each,
    # 3.7% of its total; the port converts nothing for a product)
    ("ssm", "mamba2-780m", "ssm", 0, False,
     lambda c: _dead_forward(c, c.d_inner) - 1.70e9),
    ("hybrid", "hymba-1.5b", "hybrid", 1024, False,
     lambda c: _dead_forward(c, c.d_ff)),
    ("mla_dense", "deepseek-v3-671b", "dense", 0, True,
     lambda c: _dead_forward(c, c.dense_d_ff)),
    ("mla_moe", "deepseek-v3-671b", "moe", 0, False, lambda c: 0.0),
]


def _report(name, got, ref_flops, ref_bytes):
    print(f"\n[probe] {name}: port {got['flops']:.4e} FLOPs "
          f"({got['product_flops']:.4e} products), XLA {ref_flops:.4e}; "
          f"port bytes / XLA bytes {got['bytes'] / ref_bytes:.3f}")


@pytest.mark.parametrize("name,arch,kind,window,dense,gap", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_train_layer_probe_matches_jax(name, arch, kind, window, dense,
                                       gap):
    dr = R.jax_dryrun()
    jc, tc = j_config(arch), t_config(arch)
    d_ff = (jc.dense_d_ff or jc.d_ff) if dense else jc.d_ff
    mesh = R.one_device_mesh()
    ref = JP.probe_train_layer(jc, mesh, dr.rules_for(jc, mesh), B, S, kind,
                               window, d_ff)
    got = TP.probe_train_layer(tc, B, S, kind, window, d_ff)
    _report(name, got, ref["flops"], ref["bytes"])
    want, outer = R.train_layer_products(jc, B, S, kind, window, d_ff)
    # the SSD's three-operand einsums ("bcjn,bcjh,bcjhp->bchnp",
    # "bcin,bcih,bchnp->bcihp") and their gradients: JAX contracts some
    # pairs as dot_generals with nothing contracted or with no free dim on
    # one side, torch.einsum as broadcast multiplies and sums, which are
    # elementwise work here
    assert got["product_flops"] == want
    assert (outer > 0) == (kind in ("ssm", "hybrid"))
    assert abs(got["flops"] - gap(tc) - ref["flops"]) <= TOL * ref["flops"]


def test_whisper_decoder_layer_probe_matches_jax():
    dr = R.jax_dryrun()
    jc, tc = j_config("whisper-medium"), t_config("whisper-medium")
    mesh = R.one_device_mesh()
    ref = JP._probe_dec_layer_train(jc, mesh, dr.rules_for(jc, mesh), B, S)
    got = TP._probe_dec_layer_train(tc, B, S)
    _report("whisper_dec", got, ref["flops"], ref["bytes"])
    assert got["product_flops"] == R.dec_layer_products(jc, B, S)[0]
    # the MLP's w_out forward is dead code to XLA
    dead = _dead_forward(tc, tc.d_ff)
    assert abs(got["flops"] - dead - ref["flops"]) <= TOL * ref["flops"]


def test_embed_loss_probe_matches_jax():
    dr = R.jax_dryrun()
    jc, tc = j_config("qwen3-4b"), t_config("qwen3-4b")
    mesh = R.one_device_mesh()
    ref = JP.probe_embed_loss(jc, mesh, dr.rules_for(jc, mesh), B, S,
                              with_grad=True)
    got = TP.probe_embed_loss(tc, B, S, with_grad=True)
    _report("embed+loss", got, ref["flops"], ref["bytes"])
    assert got["product_flops"] == R.embed_loss_products(jc, B, S)[0]
    # the chunk's logits product runs four times in the port (forward,
    # torch.utils.checkpoint's recompute, the two gradients) and three in
    # XLA, which merges the checkpointed recompute with the forward
    logits = 2.0 * B * S * tc.d_model * tc.vocab_size
    assert abs(got["flops"] - logits - ref["flops"]) <= TOL * ref["flops"]


def test_decode_probes_match_jax():
    """The decode layer (B 2, cache 512) and the logits head: the products
    are the textbook ones; XLA:CPU adds one convert a bf16 weight element
    (it computes bf16 dots in f32), which the port does not do."""
    dr = R.jax_dryrun()
    jc, tc = j_config("qwen3-4b"), t_config("qwen3-4b")
    mesh = R.one_device_mesh()
    rules = dr.rules_for(jc, mesh)
    ref = JP.probe_logits(jc, mesh, rules, 2)
    got = TP.probe_logits(tc, 2)
    _report("logits", got, ref["flops"], ref["bytes"])
    head = tc.d_model * tc.vocab_size
    assert got["product_flops"] == 2 * 2 * head
    assert abs(got["flops"] + head - ref["flops"]) <= TOL * ref["flops"]
    ref = JP.probe_serve_layer(jc, mesh, rules, 2, 512, "dense", 0, jc.d_ff,
                               1)
    got = TP.probe_serve_layer(tc, 2, 512, "dense", 0, tc.d_ff, 1)
    _report("decode layer", got, ref["flops"], ref["bytes"])
    blk = TP.transformer_mod.init_block(tc, "dense", tc.d_ff, device="meta")
    weights = sum(p.numel() for p in blk.parameters() if p.ndim == 2)
    assert abs(got["flops"] + weights - ref["flops"]) <= TOL * ref["flops"]


# the optimizers' elementwise FLOPs over XLA's, at most: the port's eager
# passes convert each piece's gradient and parameter to fp32 apart from
# the clip's (XLA fuses the update and converts once: 18.0 FLOPs a
# parameter against the port's 22.0 for AdamW), and Adafactor's pieced
# update (a leaf above PIECE elements, here the [256, 7168, 2048] expert
# leaves) computes each piece's update twice, once for the leaf's RMS and
# once to apply it (``Adafactor._apply``), where the whole-leaf
# reference computes it once
OPT_RATIO = {"qwen3-4b": 1.25, "deepseek-v3-671b": 2.25}


@pytest.mark.parametrize("arch,layers", [("qwen3-4b", 2),
                                         ("deepseek-v3-671b", 4)])
def test_optimizer_probe_matches_jax(arch, layers):
    dr = R.jax_dryrun()
    jc = dataclasses.replace(j_config(arch), num_layers=layers)
    tc = dataclasses.replace(t_config(arch), num_layers=layers)
    mesh = R.one_device_mesh()
    ref = JP.probe_optimizer(jc, mesh, dr.rules_for(jc, mesh))
    got = TP.probe_optimizer(tc)
    _report(f"optimizer {arch} L={layers}", got, ref["flops"], ref["bytes"])
    assert got["product_flops"] == 0
    assert ref["flops"] <= got["flops"] <= OPT_RATIO[arch] * ref["flops"]


@pytest.mark.parametrize("opt_name,shape", [
    ("adamw", (6, 40, 16)), ("adafactor", (6, 40, 16)),
    ("adafactor", (96, 40)), ("adafactor", (3000,))])
def test_optimizer_one_piece_count_matches_the_pieced_update(
        monkeypatch, opt_name, shape):
    """Trap: the updates walk a leaf in ``PIECE``-element pieces (some ten
    thousand at deepseek-v3's width); on meta a leaf is one piece through
    the same path.  A small leaf on real tensors with a small ``PIECE``
    goes through many pieces; its count equals the meta count, but for
    the scalar work each further piece adds (its partial sums)."""
    monkeypatch.setattr(TOPT, "PIECE", 512)
    opt = TOPT.get_optimizer(opt_name)

    def count(device):
        p = {"w": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
        g = {"w": torch.ones(shape, dtype=torch.bfloat16, device=device)}
        st = opt.init(p)
        lr = torch.tensor(1e-3, device=device)
        with TP.CostMode() as m:
            g, _ = TOPT.clip_by_global_norm(g, 1.0)
            opt.update(g, st, p, lr)
        return m.cost()

    whole, pieced = count("meta"), count("cpu")
    n = int(torch.tensor(shape).prod())
    assert n > 512
    assert abs(pieced["flops"] - whole["flops"]) <= 0.02 * whole["flops"]
    assert abs(pieced["bytes"] - whole["bytes"]) <= 0.02 * whole["bytes"]


# ----------------------------------------------------------------------
# The engine tick's wire at 4 workers
# ----------------------------------------------------------------------
GRAPH_CELLS = ("asymp_cc_prod", "asymp_cc_crowded_prod")


@pytest.fixture(scope="module")
def jax_ticks(tmp_path_factory):
    out = tmp_path_factory.mktemp("roof") / "ticks.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"),
                                           str(HERE)]))
    subprocess.run([sys.executable, str(HERE / "_roofline_jax_ref.py"),
                    str(out), *GRAPH_CELLS], env=env, check=True,
                   capture_output=True, timeout=600)
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", GRAPH_CELLS)
def test_tick_wire_matches_jax(jax_ticks, name):
    """The all-to-alls are the reference's exactly (op, bytes, ranks,
    count).  The one difference is the tick's counters: XLA combines the
    four (crowded: five) int32 ``psum``s into one all-reduce of 16 (20)
    bytes; the port sums them as one packed int64 vector, 32 (40)
    bytes."""
    ref = jax_ticks[name]
    mode = TP.CostMode()
    info = TE.lower_tick_for_mesh(get_graph_config(name), 4, cost=mode)
    got = TA.fold_collectives(mode.collectives)
    assert {k: info[k] for k in ref["info"]} == ref["info"]
    # the reference's HLO text parses the same through either parser
    assert _as_dicts(TA.parse_collectives(ref["hlo"])) == ref["collectives"]
    a2a = [c for c in _as_dicts(got) if c["op"] == "all-to-all"]
    assert a2a == [c for c in ref["collectives"] if c["op"] == "all-to-all"]
    red = [c for c in got if c.op == "all-reduce"]
    ref_red = [c for c in ref["collectives"] if c["op"] == "all-reduce"]
    assert len(red) == len(ref_red) == 1 and red[0].count == 1
    assert red[0].result_bytes == 2 * ref_red[0]["result_bytes"]
    wire = sum(c.wire_bytes for c in got)
    assert wire - ref["wire"] == red[0].wire_bytes - ref_red[0]["wire_bytes"]
    assert mode.cost()["bytes"] > 0
