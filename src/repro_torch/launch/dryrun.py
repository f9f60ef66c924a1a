"""Dry run of every (arch x shape x mesh) cell, and of the engine tick
(the counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step on 512 placeholder
devices with GSPMD shardings and records XLA's memory and cost analyses.
The port has no compiler and no GSPMD, so it keeps the numbers, not the
calls.  For each cell this module:

  1. takes the production mesh as a shape (16 x 16, or 2 x 16 x 16:
     ``launch/mesh.py::make_production_mesh``) and the arch's rules
     (:func:`rules_for`, the reference's overrides and log);
  2. builds every input on ``"meta"`` (parameters, optimizer state,
     batch, KV/SSM caches: nothing allocated) with its logical axes, and
     resolves each leaf's spec and one rank's block of it
     (:func:`sharding_tree`);
  3. runs the port's train, prefill or decode step once on those meta
     tensors at the cell's global shapes: the gate, where a step whose
     shapes do not flow at full size fails;
  4. records one rank's argument, output and donated bytes (the
     counterparts of XLA's ``memory_analysis``; there is no compiler to
     schedule temporaries, so ``temp_bytes`` is ``None``), the model
     FLOPs, the sharding fallbacks and, on one pod, the probe-composed
     roofline on the H100's peaks (``roofline/probes.py``).  The LM
     step's collectives are GSPMD's in the reference; the port has no
     GSPMD and models none, so ``collective_wire_bytes`` is ``None``.

The engine tick's cell (:func:`lower_graph_cell`) runs one rank's tick
under fake tensors (``core/engine.py::lower_tick_for_mesh``), recording
its explicit collectives, FLOPs and bytes.  Nothing here needs a device.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k [--multipod]
  python -m repro_torch.launch.dryrun --all [--multipod] [--arch-filter moe]
  python -m repro_torch.launch.dryrun --graph asymp_cc_prod
  python -m repro_torch.launch.dryrun --graph asymp_cc_crowded_prod

Records go to ``experiments/dryrun_torch/<cell>.json``; a cell that
fails is recorded with ``status: "FAIL: ..."`` and the sweep goes on.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, NamedTuple

import torch

from repro_torch.configs import SHAPES, get_config, get_graph_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import ShardingRules, block_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as transformer_mod
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import probes
from repro_torch.serve import engine as serve_engine
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer as trainer_mod

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
META = torch.device("meta")
PEAKS = {"device": "NVIDIA H100 SXM", "peak_flops": roofline.PEAK_FLOPS,
         "hbm_bytes_per_s": roofline.HBM_BW,
         "link_bytes_per_s": roofline.LINK_BW,
         "source": "NVIDIA H100 SXM data sheet, dense bf16, 700 W"}


# ======================================================================
def rules_for(cfg: ModelConfig, mesh=None) -> ShardingRules:
    """Arch-aware rule overrides, logged as the reference logs them.

    Head-count divisibility is decided *semantically* here: sharding the
    flattened H*hd projection when H doesn't divide the model axis would
    split shards across head boundaries, so those archs replicate
    attention heads instead (hymba: 25 heads; granite MQA: kv=1;
    chatglm/glm4: kv=2; phi/qwen/chameleon: kv=8)."""
    rules = ShardingRules()
    over = {}
    if not cfg.fsdp:
        over["fsdp"] = ((),)
    if mesh is not None and cfg.num_heads:
        tp = mesh.shape.get("model", 1)
        if cfg.num_heads % tp != 0:
            over["q_proj"] = ((),)
            over["act_heads"] = ((),)
            rules.log.append(("rules", "q_proj", cfg.num_heads, (),
                              f"heads {cfg.num_heads} %% model {tp}"))
        if cfg.num_kv_heads % tp != 0 and not cfg.use_mla:
            over["kv_proj"] = ((),)
            over["kv_heads"] = ((),)
            rules.log.append(("rules", "kv_proj", cfg.num_kv_heads, (),
                              f"kv_heads {cfg.num_kv_heads} %% model {tp}"))
    if mesh is not None and cfg.ssm_state:
        tp = mesh.shape.get("model", 1)
        if cfg.ssm_heads % tp != 0:
            over["ssm_heads"] = ((),)
    if over:
        rules = rules.override(**over)
    return rules


def _map2(fn, axes, tree):
    """``fn(axes_leaf, leaf)`` over an axes tree and the tree of tensors it
    names (dicts, tuples and NamedTuples; ``None`` where both are)."""
    if tree is None:
        return None
    if opt_mod.is_axes(axes):
        return fn(axes, tree)
    if isinstance(axes, dict):
        return {k: _map2(fn, axes[k], tree[k]) for k in axes}
    parts = [_map2(fn, a, t) for a, t in zip(axes, tree)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


class Sharded(NamedTuple):
    """A leaf's spec on the mesh and one rank's block shape of it."""
    spec: tuple
    block: tuple


def sharding_tree(mesh, rules: ShardingRules, axes_tree, shapes_tree,
                  tag: str):
    """axes tree x tree of tensors -> tree of :class:`Sharded`: each
    leaf's spec on ``mesh`` and one rank's block shape of it (each
    dimension divided by the product of its mesh axes)."""
    def mk(a, t):
        spec = rules.resolve(mesh, a, tuple(t.shape), tag)
        return Sharded(spec, block_shape(mesh, spec, tuple(t.shape)))
    return _map2(mk, axes_tree, shapes_tree)


def leaves(tree, path: tuple = ()):
    """``(path, leaf)`` of a tree of dicts, tuples and NamedTuples (path
    entries: dict keys, tuple indices, NamedTuple field names); ``None``
    skipped, a :class:`Sharded` kept whole."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, tuple) and not isinstance(tree, Sharded):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def rank_bytes(shapes_tree, sharded_tree) -> int:
    """One rank's bytes of a tree of tensors laid out as
    :func:`sharding_tree` says."""
    sizes = {p: t.element_size() for p, t in leaves(shapes_tree)}
    total = 0
    for p, sh in leaves(sharded_tree):
        total += math.prod(sh.block) * sizes[p]
    return total


def state_shapes_and_axes(cfg: ModelConfig, state=None):
    """(the train state's tree of meta tensors, its logical axes): the
    reference's ``TrainState`` layout (``trainer.to_checkpoint``), from
    ``init_state(cfg, device="meta")`` unless ``state`` is given."""
    if state is None:
        state = trainer_mod.init_state(cfg, device=META)
    return trainer_mod.to_checkpoint(state), trainer_mod.state_axes(cfg)


def params_shapes_and_axes(cfg: ModelConfig, model=None):
    """(the parameters' tree of meta tensors, its logical axes), from
    ``model`` or a model made on ``"meta"``."""
    if model is None:
        init = (encdec_mod.init_encdec if cfg.encdec
                else transformer_mod.init_lm)
        model = init(cfg, device=META)
    axes = (encdec_mod.param_axes(cfg) if cfg.encdec
            else transformer_mod.param_axes(cfg))
    return transformer_mod.to_tree(transformer_mod.param_dict(model)), axes


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple[dict, dict]:
    """(meta tensors, logical axes) for the input batch of a train step."""
    B, S = shape.global_batch, shape.seq_len
    tok = lambda: torch.empty((B, S), dtype=torch.int32, device=META)  # noqa: E731
    shapes = {"tokens": tok(), "labels": tok()}
    axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.encdec:
        shapes["features"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                         dtype=torch.bfloat16, device=META)
        axes["features"] = ("batch", None, None)
    return shapes, axes


def cache_specs(cfg: ModelConfig, batch: int, s_max: int):
    """(the serving cache's tree of meta tensors, its logical axes)."""
    if cfg.encdec:
        return (encdec_mod.init_dec_cache(cfg, batch, s_max, META),
                encdec_mod.dec_cache_axes(cfg))
    return (transformer_mod.init_cache(cfg, batch, s_max, META),
            transformer_mod.cache_axes(cfg))


# ======================================================================
class CellInputs(NamedTuple):
    """A cell's inputs on meta (``feed``: the batch, or the decode step's
    ``{"token"}``) and, in ``trees``, each input tree beside its
    :class:`Sharded` tree (in the reference's order of resolution);
    ``trees[donated]`` is the tree the step donates (the train state, or
    the caches)."""
    state: Any
    params: Any
    caches: Any
    feed: dict
    trees: list
    donated: int


def cell_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                rules: ShardingRules) -> CellInputs:
    """Every input of the cell's step on meta, resolved on ``mesh``."""
    B = shape.global_batch
    state = params = caches = None
    batch, b_axes = batch_specs(cfg, shape)
    if shape.kind == "train":
        state = trainer_mod.init_state(cfg, device=META)
        s_shapes, s_axes = state_shapes_and_axes(cfg, state)
        trees = [(s_shapes, sharding_tree(mesh, rules, s_axes, s_shapes,
                                          "state"))]
        donated = 0
    else:
        params = (encdec_mod.init_encdec if cfg.encdec
                  else transformer_mod.init_lm)(cfg, device=META)
        p_shapes, p_axes = params_shapes_and_axes(cfg, params)
        caches, c_axes = cache_specs(cfg, B, shape.seq_len)
        trees = [(p_shapes, sharding_tree(mesh, rules, p_axes, p_shapes,
                                          "params")),
                 (caches, sharding_tree(mesh, rules, c_axes, caches,
                                        "cache"))]
        donated = 1
    if shape.kind == "decode":
        feed = {"token": torch.empty((B, 1), dtype=torch.int32, device=META)}
        feed_axes = {"token": ("batch", None)}
    else:
        keep = [k for k in batch if shape.kind == "train" or k != "labels"]
        feed = {k: batch[k] for k in keep}
        feed_axes = {k: b_axes[k] for k in keep}
    trees.append((feed, sharding_tree(mesh, rules, feed_axes, feed,
                                      "batch")))
    return CellInputs(state, params, caches, feed, trees, donated)


def _run_step(cfg: ModelConfig, shape: ShapeConfig, ci: CellInputs):
    """The port's step once on meta at the cell's global shapes; returns
    its outputs (the gate: a shape that does not flow raises here)."""
    if shape.kind == "train":
        return trainer_mod.make_train_step(cfg)(ci.state, ci.feed)
    if shape.kind == "prefill":
        return serve_engine.make_prefill_step(cfg)(ci.params, ci.feed,
                                                   ci.caches)
    return serve_engine.make_decode_step(cfg)(ci.params, ci.feed["token"],
                                              ci.caches)


def rank_blocks(trees, device) -> list:
    """One rank's block of every leaf of ``trees`` (:attr:`CellInputs.
    trees`), uninitialised on ``device``: what the rank holds."""
    out = []
    for tensors, sharded in trees:
        dtypes = {p: t.dtype for p, t in leaves(tensors)}
        out += [torch.empty(sh.block, dtype=dtypes[p], device=device)
                for p, sh in leaves(sharded)]
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The dry run of one cell: its record (see the module docstring)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skip(full-attn)"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules_for(cfg, mesh)
    t0 = time.time()
    ci = cell_inputs(cfg, shape, mesh, rules)
    out = _run_step(cfg, shape, ci)
    t_lower = time.time() - t0
    donated = rank_bytes(*ci.trees[ci.donated])
    if shape.kind == "train":
        output = donated + 4 * len(out[1])  # the metrics, fp32 scalars
    else:
        logits = out[0]
        l_spec = rules.resolve(mesh, ("batch", None, "vocab"),
                               tuple(logits.shape), "logits")
        output = donated + math.prod(block_shape(
            mesh, l_spec, tuple(logits.shape))) * logits.element_size()
    argument = sum(rank_bytes(t, sh) for t, sh in ci.trees)

    mf = roofline.model_flops(cfg, shape, shape.kind)
    chips = 512 if multi_pod else 256
    record = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "chips": chips, "lower_s": round(t_lower, 2),
        "memory": {
            "argument_bytes": argument, "output_bytes": output,
            "temp_bytes": None, "alias_bytes": donated,
            "peak_per_device_gb": round(
                (argument + output - donated) / 2**30, 3),
            "note": "one rank's blocks of the step's inputs and outputs; "
                    "no compiler schedules temporaries, so temp_bytes is "
                    "null and the peak leaves them out"},
        "model_flops_global": mf,
        "model_flops_per_chip": mf / chips,
        "sharding_fallbacks": [
            {"tag": t, "axis": a, "dim": d, "reason": r}
            for (t, a, d, ch, r) in rules.log[:40]],
        "peaks": PEAKS,
    }
    if not multi_pod:
        t0 = time.time()
        pc = probes.cell_costs(cfg, shape, mesh, rules, ci.state)
        roof = roofline.analyze({"flops": pc["flops"], "bytes": pc["bytes"],
                                 "collectives": None})
        record["roofline"] = {
            "flops": pc["flops"], "product_flops": pc["product_flops"],
            "bytes_accessed": pc["bytes"], "collective_wire_bytes": None,
            "compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": None, "dominant": roof.dominant,
            "collective_note": "the LM step's collectives are GSPMD's in "
                               "the reference; the port has no GSPMD and "
                               "models none",
            "pieces": pc["pieces"]}
        record["probe_s"] = round(time.time() - t0, 2)
        record["useful_flops_ratio"] = (
            (mf / chips) / pc["flops"] if pc["flops"] else 0.0)
    else:
        record["roofline"] = {"note": "multi-pod gate only; see pod1 record"}
    return record


# ======================================================================
def lower_graph_cell(name: str, multi_pod: bool) -> dict:
    """Dry-run the ASYMP engine tick at the production mesh's rank count:
    the tick's ``info``, one rank's argument bytes, and the roofline of its
    counted FLOPs, bytes and recorded collectives."""
    from repro_torch.core import engine as ge
    cfg = get_graph_config(name)
    n_workers = 512 if multi_pod else 256
    t0 = time.time()
    mode = probes.CostMode()
    info = ge.lower_tick_for_mesh(cfg, n_workers, cost=mode)
    c = mode.cost()
    roof = roofline.analyze({"flops": c["flops"], "bytes": c["bytes"],
                             "collectives": roofline.fold_collectives(
                                 mode.collectives)})
    return {
        "arch": name, "shape": f"V={cfg.num_vertices} deg={cfg.avg_degree}",
        "multi_pod": multi_pod, "status": "ok", "chips": n_workers,
        "lower_s": round(time.time() - t0, 2),
        "memory": {"argument_bytes": info["argument_bytes"],
                   "temp_bytes": None},
        "roofline": roof.to_dict(), "peaks": PEAKS, "engine": info,
    }


# ======================================================================
def _cell_tag(arch: str, shape_name: str, multi_pod: bool) -> str:
    return f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"


def run_cells(cells, multi_pod: bool, out_dir: str) -> list[dict]:
    """Every cell's record, each written to ``out_dir``; a record already
    there is read instead of rerun."""
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch, shape_name in cells:
        tag = _cell_tag(arch, shape_name, multi_pod)
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path):
            print(f"[skip-cached] {tag}")
            with open(path) as f:
                results.append(json.load(f))
            continue
        print(f"[lower] {tag} ...", flush=True)
        try:
            record = lower_cell(arch, shape_name, multi_pod)
            if record["status"] == "ok":
                rf = record["roofline"]
                print(f"  argument/rank={record['memory']['argument_bytes']}"
                      f" dominant={rf.get('dominant')} "
                      f"lower={record['lower_s']}s", flush=True)
        except Exception as e:  # noqa: BLE001 — record failures, keep going
            record = {"arch": arch, "shape": shape_name,
                      "multi_pod": multi_pod,
                      "status": f"FAIL: {type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-2000:]}
            print(f"  FAILED: {e}")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        results.append(record)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--graph", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--arch-filter", default="")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.graph:
        os.makedirs(args.out, exist_ok=True)
        record = lower_graph_cell(args.graph, args.multipod)
        tag = f"graph_{args.graph}__{'pod2' if args.multipod else 'pod1'}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
        print(json.dumps({k: v for k, v in record.items()
                          if k != "roofline"}, indent=1))
        print("dominant:", record["roofline"]["dominant"])
        return 0

    if args.all:
        cells = [(a, s) for a in list_archs() if args.arch_filter in a
                 for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all, or --graph)")
        cells = [(args.arch, args.shape)]
    results = run_cells(cells, args.multipod, args.out)
    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"].startswith("skip"))
    fail = len(results) - ok - skip
    print(f"\n== dry-run summary: {ok} ok, {skip} skipped(reasoned), "
          f"{fail} FAILED ==")
    for r in results:
        if r["status"].startswith("FAIL"):
            print(" ", r["arch"], r["shape"], r["status"][:200])
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
