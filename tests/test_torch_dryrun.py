"""Parity of the port's dry run (``repro_torch/launch/dryrun.py``, the
production mesh, the cache axes) with the JAX package's, on the CPU.

  * the cache-axes trees (``cache_axes``, ``dec_cache_axes``) equal the
    reference's for every arch;
  * every leaf of the parameters, the train state, the batch and the
    caches, for every arch x shape on one pod (16 x 16) and two (2 x 16 x
    16): its global shape, its spec and one rank's block equal the
    reference's ``NamedSharding(AbstractMesh(...), spec).shard_shape``
    over its ``sharding_tree``, and the rules' fallback log equals the
    reference's (as a multiset: the two packages walk their trees in
    other orders);
  * the CLI writes a record and ``roofline/report.py`` renders it;
  * every top-level function and class of ``src/repro`` has a counterpart
    in ``src/repro_torch``, but for a listed few that have none by design.

``lower_cell`` itself, the gate of every cell, runs in
``tests/test_torch_dryrun_cells.py``.
"""
import ast
import json
import pathlib

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _roofline_ref as R  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.roofline import report as TR  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"pod1": ((16, 16), ("data", "model"), False),
          "pod2": ((2, 16, 16), ("pod", "data", "model"), True)}


def _jax_path(keys) -> tuple:
    out = []
    for k in keys:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(getattr(k, attr))
                break
    return tuple(out)


def _axes_leaves(tree, is_axes, path=()) -> dict:
    """An axes tree's leaves by path (dict keys, indices, NamedTuple
    fields), ``None`` subtrees skipped."""
    if tree is None:
        return {}
    if is_axes(tree):
        return {path: tuple(tree)}
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = zip(getattr(tree, "_fields", range(len(tree))), tree)
    for k, v in items:
        out.update(_axes_leaves(v, is_axes, path + (k,)))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_cache_axes_match_jax(arch):
    jc, tc = j_config(arch), t_config(arch)
    if jc.encdec:
        want, got = JED.dec_cache_axes(jc), TED.dec_cache_axes(tc)
    else:
        want, got = JT.cache_axes(jc), TT.cache_axes(tc)
    want = _axes_leaves(want, JOPT.is_axes)
    assert _axes_leaves(got, TOPT.is_axes) == want
    if not tc.encdec:
        # the port's one difference: the slot server's position a row
        slots = _axes_leaves(TT.cache_axes(tc, slots=True), TOPT.is_axes)
        for path, ax in slots.items():
            if path[-1] == "pos":
                assert ax == want[path] + ("batch",)
            else:
                assert ax == want[path]


def _jax_trees(dr, jc):
    """The reference's (name, shapes, axes) of every tree a cell takes."""
    trees = [("state",) + dr.state_shapes_and_axes(jc),
             ("params",) + dr.params_shapes_and_axes(jc)]
    for name, sh in J_SHAPES.items():
        trees.append((f"batch {name}",) + dr.batch_specs(jc, sh))
        if sh.kind != "train" and (name != "long_500k"
                                   or jc.supports_long_context):
            trees.append((f"cache {name}",)
                         + dr.cache_specs(jc, sh.global_batch, sh.seq_len))
    return trees


def _port_trees(tc):
    state = TD.state_shapes_and_axes(tc)
    trees = [("state",) + state, ("params",) + TD.params_shapes_and_axes(tc)]
    for name, sh in T_SHAPES.items():
        trees.append((f"batch {name}",) + TD.batch_specs(tc, sh))
        if sh.kind != "train" and (name != "long_500k"
                                   or tc.supports_long_context):
            trees.append((f"cache {name}",)
                         + TD.cache_specs(tc, sh.global_batch, sh.seq_len))
    return trees


@pytest.mark.parametrize("arch", list_archs())
def test_per_rank_blocks_match_jax(arch):
    """Every leaf's global shape, spec and per-rank block, and the
    fallback log, on both meshes.  The trees have no leaf of another
    shape: the port's per-row ``pos`` lives only in the slot server
    (``cache_axes(slots=True)``), not in ``init_cache``."""
    dr = R.jax_dryrun()
    jc, tc = j_config(arch), t_config(arch)
    jtrees, ttrees = _jax_trees(dr, jc), _port_trees(tc)
    for sizes, names, multi in MESHES.values():
        jmesh = AbstractMesh(sizes, names)
        tmesh = TM.make_production_mesh(multi_pod=multi)
        assert tuple(tmesh.shape.items()) == tuple(jmesh.shape.items())
        jrules, trules = dr.rules_for(jc, jmesh), TD.rules_for(tc, tmesh)
        assert jrules.log == trules.log  # the arch's own overrides
        for (name, js, ja), (_, ts, ta) in zip(jtrees, ttrees):
            tag = name.split()[0]
            jsh = dr.sharding_tree(jmesh, jrules, ja, js, tag)
            want = {}
            flat = jax.tree_util.tree_flatten_with_path(js)[0]
            for (path, sds), (_, ns) in zip(
                    flat, jax.tree_util.tree_flatten_with_path(jsh)[0]):
                spec = tuple(ns.spec) + (None,) * (len(sds.shape)
                                                   - len(ns.spec))
                want[_jax_path(path)] = (tuple(sds.shape), spec,
                                         tuple(NamedSharding(
                                             jmesh, P(*spec)).shard_shape(
                                                 sds.shape)),
                                         sds.dtype.itemsize)
            tsh = TD.sharding_tree(tmesh, trules, ta, ts, tag)
            shapes = dict(TD.leaves(ts))
            got = {p: (tuple(shapes[p].shape), sh.spec, sh.block,
                       shapes[p].element_size())
                   for p, sh in TD.leaves(tsh)}
            assert got == want, (arch, name, sizes)
        assert sorted(map(repr, trules.log)) == sorted(map(repr, jrules.log))


def test_meshes():
    pod1, pod2 = TM.make_production_mesh(), TM.make_production_mesh(
        multi_pod=True)
    assert pod1.shape == {"data": 16, "model": 16} and not pod1.groups
    assert pod2.shape == {"pod": 2, "data": 16, "model": 16}
    local = TM.make_local_mesh()
    assert local.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        TM.make_local_mesh(model=2)


def test_cli_writes_a_record_and_the_report_renders_it(tmp_path):
    assert TD.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                    "--out", str(tmp_path)]) == 0
    assert TD.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                    "--out", str(tmp_path)]) == 0
    assert TD.main(["--graph", "asymp_cc_prod", "--out",
                    str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "mamba2-780m__long_500k__pod1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["peaks"]["peak_flops"] == 989e12
    assert rec["memory"]["temp_bytes"] is None
    assert rec["roofline"]["collective_wire_bytes"] is None
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["model_flops_per_chip"] * 256 == rec["model_flops_global"]
    graph = json.loads((tmp_path / "graph_asymp_cc_prod__pod1.json")
                       .read_text())
    assert graph["roofline"]["collective_wire_bytes"] > 0
    lines = TR.render(TR.load(str(tmp_path), False))
    row = next(line for line in lines if line.startswith("| mamba2-780m"))
    cells = [c.strip() for c in row.split("|")[1:-1]]
    assert cells[2] == "ok" and cells[6] == "-"  # no collective term
    assert float(cells[10]) > 0.9  # products are most of the FLOPs
    assert any("skip(full-attn)" in line for line in lines)
    assert any(line.startswith("| asymp_cc_prod") for line in lines)


# ----------------------------------------------------------------------
# Completeness: every reference name has a counterpart
# ----------------------------------------------------------------------
BY_DESIGN = {
    # a shard_map / axis-type shim over JAX versions; the port's
    # collectives are torch.distributed calls
    "dist/compat.py": "*",
    # scan unrolling for XLA's cost analysis, which counts a while
    # loop's body once; the port's loops are Python loops
    "models/flags.py": "*",
    "roofline/probes.py": {
        "_unrolled": "the same flag, set around a probe",
        "_cost_of": "reads XLA's cost_analysis; CostMode.cost counts",
        "_sds": "ShapeDtypeStruct stand-ins; the probes run on meta",
        "_sharding_tree": "dryrun.sharding_tree serves the probes"},
    "models/layers.py": {
        # the reference's params are Param(value, axes) leaves split into
        # two trees; the port's are nn.Parameters in modules, their axes
        # a separate tree (transformer.param_axes)
        "Param": "nn.Parameter", "is_param": "nn.Parameter",
        "split_params": "param_dict / param_axes",
        "stack_params": "transformer.stack_layers",
        "ones_param": "init_norm", "zeros_param": "torch.zeros"},
    "ft/checkpoint.py": {
        "_named_tuple_registry": "a JAX pytree registry of the state's "
                                 "NamedTuples for restore; the port "
                                 "rebuilds them from their fields"},
    "models/attention.py": {
        "_flash_fwd": "jax.custom_vjp's forward rule: _Flash.forward",
        "_flash": "the custom_vjp function: _Flash / flash_attention"},
    "models/transformer.py": {
        "_use_scan": "StackPlan.scan from MIN_SCAN alone (no unroll flag)"},
    "models/ssm.py": {
        "_ssd_seq_parallel": "_ssd_seq_parallel_call (an autograd "
                             "Function around the collective)"},
    "launch/mesh.py": {
        "make_worker_mesh": "make_worker_group: one process a shard"},
    "kernels/semiring_spmv.py": {
        "_spmv_kernel": "the Pallas body; csrc/semiring_spmv.cu's kernels"},
}


def _top_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body if isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def test_every_reference_name_has_a_counterpart():
    ref, port = REPO / "src" / "repro", REPO / "src" / "repro_torch"
    missing, excused = [], set()
    for f in sorted(ref.rglob("*.py")):
        rel = f.relative_to(ref).as_posix()
        mine = port / rel
        have = _top_names(mine) if mine.exists() else set()
        allowed = BY_DESIGN.get(rel, {})
        for name in sorted(_top_names(f) - have):
            if allowed == "*" or name in allowed:
                excused.add((rel, name))
            else:
                missing.append(f"{rel}::{name}")
    assert not missing, missing
    listed = {(rel, n) for rel, names in BY_DESIGN.items()
              if names != "*" for n in names}
    assert listed <= excused  # no stale entry
