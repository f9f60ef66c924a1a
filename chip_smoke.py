#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it ends; any failed check exits non-zero:

  1. environment: torch, the card, ``nvidia-smi`` name and power limit;
  2. build: compile ``csrc/semiring_spmv.cu`` with nvcc, print ptxas' report;
  3. the kernel against its plain PyTorch version on the same inputs —
     every (semiring, dtype) of the sweep at 1/3/8 blocks, the all-padding
     block, the max clamp, and the RMAT 2^18 pull stream of the main path;
     idempotent semirings exactly, ``plus_times`` within rtol/atol 1e-5
     (its sum order differs) — then its time there beside the plain
     version's, one ``scatter_reduce_`` call's and the bytes bound;
  4. the main path at full size: ``asymp_cc_large`` (RMAT 2^18, 8 shards)
     to convergence on the prioritized engine, the kernel-backed BSP
     baseline, and the dense pagerank oracle (the kernel's plus_times
     form); engine labels must equal BSP labels, and the kernel's launches
     must equal the BSP rounds and the pagerank iterations; then a
     profiled window of engine ticks (device time by op, busy share);
  5. the ``benchmarks/bench_speed.py --smoke`` configs (RMAT 2^12): the
     fixpoints against the union-find and labelprop oracles, and the
     tick/message counts beside the JAX package's committed baselines;
  6. ``{"kernels": [...]}``, then the card's nvidia-smi line, then the last
     line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # non-tensor float32; int32 compares taken alike
SWEEP = [("min", "int32"), ("min", "float32"), ("min_plus", "float32"),
         ("max", "int32"), ("max", "float32"), ("max_min", "float32"),
         ("or", "int32"), ("plus_times", "float32")]
# bench_speed smoke counts in benchmarks/baselines/BENCH_speed.json
SMOKE_BASELINE = {"cc": (120, 129164), "labelprop": (121, 129566)}
PAGERANK_ITERS = 5
PROFILE_WARM_TICKS, PROFILE_TICKS = 100, 20


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **kw) -> None:
    print(f"[chip_smoke] {phase}: " + json.dumps(kw, default=str), flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b) -> float:
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, 0.0, (a - b).abs()).max()) if a.numel() \
        else 0.0


def spmv_inputs(np, torch, rng, n, dtype, dst=None):
    if dtype == "int32":
        vals = rng.integers(0, 10_000, n).astype(np.int32)
    else:
        vals = rng.uniform(0.0, 10.0, n).astype(np.float32)
    if dst is None:
        dst = rng.integers(-1, 128, n).astype(np.int32)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return put(vals), put(dst), put(w)


def bound_of(semiring, n, n_blocks, weighted):
    """Least time for one call: each input read once, the output written
    once, against one combine and one reduce per edge."""
    nbytes = n * (4 + 4 + (4 if weighted else 0)) + n_blocks * 128 * 4
    ops = n * (1 if semiring in ("min", "max", "or") else 2)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False: "
              "this script runs the port on a CUDA card", flush=True)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.configs import get_graph_config
        from repro_torch.configs.base import GraphConfig
        from repro_torch.core import engine as E
        from repro_torch.core import graph as G
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import ref as R
        from repro_torch.kernels import semiring_spmv as K
    except ImportError as e:
        print(f"[chip_smoke] FAIL: the port is not beside this script "
              f"({e})", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    say("environment", torch=torch.__version__, cuda=torch.version.cuda,
        device=kind, count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- 2. build ----
    built = _build.build("semiring_spmv")
    _build.load("semiring_spmv")
    say("build", seconds=round(built["seconds"], 3), cached=built["cached"],
        library=os.path.relpath(built["path"], ROOT))
    for line in built["report"].splitlines():
        if "ptxas" in line and ("Used" in line or "spill" in line
                                or "Compiling" in line):
            print(f"[chip_smoke] ptxas: {line.strip()}", flush=True)

    # ---- 3. kernel vs plain version ----
    rng = np.random.default_rng(0)
    worst = {"idempotent": 0.0, "plus_times": 0.0}

    def compare(semiring, kp, rp, where):
        err = max_abs_err(torch, kp, rp)
        fam = "plus_times" if semiring == "plus_times" else "idempotent"
        worst[fam] = max(worst[fam], err)
        if semiring == "plus_times":
            check(torch.allclose(kp, rp, rtol=1e-5, atol=1e-5),
                  f"plus_times differs from its plain version ({where}): "
                  f"max abs err {err}")
        else:
            check(torch.equal(kp, rp), f"{semiring} differs from its plain "
                                       f"version ({where}): max abs err {err}")

    n_small = 0
    for semiring, dtype in SWEEP:
        for n_blocks in (1, 3, 8):
            for weighted in (True, False):
                v, d, w = spmv_inputs(np, torch, rng, n_blocks * 512, dtype)
                w = w if weighted else None
                kp = K.spmv_partials(v, d, w, semiring=semiring)
                rp = R.spmv_partials_ref(v, d, w, semiring=semiring)
                torch.cuda.synchronize()
                compare(semiring, kp, rp, f"{dtype}, {n_blocks} blocks")
                n_small += 1
    pad_v = torch.zeros(512, device=dev)
    pad_d = torch.full((512,), -1, dtype=torch.int32, device=dev)
    check(bool(torch.isinf(K.spmv_partials(pad_v, pad_d, None,
                                           semiring="min")).all()),
          "all-padding block is not the min identity")
    clamp_v = torch.full((512,), -5.0, device=dev)
    clamp_d = torch.zeros(512, dtype=torch.int32, device=dev)
    kc = K.spmv_partials(clamp_v, clamp_d, None, semiring="max")
    check(torch.equal(kc, R.spmv_partials_ref(clamp_v, clamp_d, None,
                                              semiring="max"))
          and float(kc[0, 0]) == 0.0, "max does not clamp at the identity")
    say("kernel_sweep", cases=n_small + 2, worst_abs_err=worst)

    cfg_large = get_graph_config("asymp_cc_large")
    t0 = time.perf_counter()
    graph = G.build_sharded_graph(cfg_large)
    build_graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pg = ops.build_pulled_graph(graph)
    build_pulled_s = time.perf_counter() - t0
    n_edges, n_blocks = len(pg.edge_src), pg.n_blocks
    say("host_build", config=cfg_large.name, vertices=graph.num_vertices,
        directed_edges=graph.num_edges, edges_on_largest_shard=graph.es,
        pulled_edges=n_edges, blocks=n_blocks,
        build_sharded_graph_s=round(build_graph_s, 3),
        build_pulled_graph_s=round(build_pulled_s, 3))

    forms = []
    dst_main = pg.edge_dst_local
    # the BSP path's own form first: min on int32 labels, no weights
    for semiring, dtype, weighted in [("min", "int32", False)] + [
            (s, d, True) for s, d in SWEEP]:
        v, d, w = spmv_inputs(np, torch, rng, n_edges, dtype, dst=dst_main)
        w = w if weighted else None
        kp = K.spmv_partials(v, d, w, semiring=semiring)
        rp = R.spmv_partials_ref(v, d, w, semiring=semiring)
        torch.cuda.synchronize()
        compare(semiring, kp, rp, f"{dtype}, RMAT 2^18 stream")
        err = max_abs_err(torch, kp, rp)
        ms = cuda_ms(torch, lambda: K.spmv_partials(v, d, w,
                                                    semiring=semiring), 20)
        plain_ms = cuda_ms(torch, lambda: R.spmv_partials_ref(
            v, d, w, semiring=semiring), 5)
        # the library yardstick: one scatter_reduce_ over precomputed
        # (block*TILE + dst) segments and combined values
        agg = K.for_semiring(semiring)
        ident = K._identity(semiring, v.dtype)
        cand = K._combine(semiring, v, (w if w is not None
                                        else torch.ones_like(v)).to(v.dtype))
        block = torch.arange(n_edges, device=dev) // 512
        seg = torch.where(d >= 0, block * 128 + d.long(), n_blocks * 128)
        reduce = {"min": "amin", "max": "amax", "or": "amax",
                  "sum": "sum"}[agg.name]
        lib_out = torch.full((n_blocks * 128 + 1,), ident, dtype=v.dtype,
                             device=dev)
        library_ms = cuda_ms(torch, lambda: lib_out.scatter_reduce_(
            0, seg, cand, reduce=reduce, include_self=True), 5)
        check(torch.equal(lib_out[:-1].view(n_blocks, 128), kp)
              or semiring == "plus_times", f"library yardstick disagrees "
                                           f"({semiring})")
        bound_ms, bound_by, nbytes = bound_of(semiring, n_edges, n_blocks,
                                              weighted)
        form = {"semiring": semiring, "dtype": dtype, "weights": weighted,
                "blocks": n_blocks, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
        forms.append(form)
        say("kernel_at_main_shape", **form)
        del v, d, w, kp, rp, cand, seg, lib_out, block

    # ---- 4. main path at full size ----
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, totals = E.run_to_convergence(cfg_large, graph=graph, device=dev)
    torch.cuda.synchronize()
    prop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bsp_labels, bsp = ops.bsp_connected_components(graph, device=dev)
    torch.cuda.synchronize()
    bsp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = ops.pagerank(graph, iters=PAGERANK_ITERS, device=dev)
    torch.cuda.synchronize()
    pagerank_s = time.perf_counter() - t0
    launches = dict(K.spmv_partials.launches_by_form)
    peak = torch.cuda.max_memory_allocated()
    labels = state.values.reshape(-1)[: graph.num_real_vertices]
    say("main_path", config=cfg_large.name, ticks=totals["ticks"],
        messages=totals["sent"], fetched=totals["fetched"],
        converged=totals["converged"], bsp_rounds=bsp["rounds"],
        bsp_messages=bsp["messages"], propagation_s=prop_s, bsp_s=bsp_s,
        pagerank_iters=PAGERANK_ITERS, pagerank_s=pagerank_s,
        kernel_launches=launches, max_memory_allocated=peak,
        components=int(torch.unique(labels).numel()))
    check(totals["converged"], "the engine did not converge")
    check(torch.equal(labels, bsp_labels), "engine labels != BSP labels")
    check(launches.get("min/int32", 0) == bsp["rounds"],
          f"kernel launches {launches} != BSP rounds {bsp['rounds']}")
    check(launches.get("plus_times/float32", 0) == PAGERANK_ITERS,
          f"plus_times launches {launches} != {PAGERANK_ITERS}")
    check(bool(torch.isfinite(ranks).all())
          and abs(float(ranks.sum()) - 1.0) < 1e-3,
          f"pagerank mass {float(ranks.sum())} is not 1")
    del state, bsp_labels, ranks, labels

    # ---- 4b. where an engine tick's time goes (a short profiled window) ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sess = E.EngineSession(cfg_large, graph=graph, device=dev)
    for _ in range(PROFILE_WARM_TICKS):
        sess.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            sess.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0

    def device_us(row):
        return getattr(row, "self_device_time_total",
                       getattr(row, "self_cuda_time_total", 0.0))

    # kernel rows sum to the device's busy time; op rows (aten::*) carry
    # the same time again, attributed to the op that launched it
    rows = prof.key_averages()
    on_card = [r for r in rows if r.device_type == DeviceType.CUDA]
    by_op = sorted((r for r in rows if r.device_type != DeviceType.CUDA),
                   key=device_us, reverse=True)
    busy_us = sum(device_us(r) for r in on_card)
    say("engine_tick_profile", ticks=f"{PROFILE_WARM_TICKS}.."
        f"{PROFILE_WARM_TICKS + PROFILE_TICKS}",
        window_s=window_s, device_busy_s=busy_us / 1e6,
        device_busy_share=(busy_us / 1e6 / window_s if busy_us
                           else "not measured"),
        top_ops_device_ms=[(r.key, device_us(r) / 1e3, r.count)
                           for r in by_op[:10]])
    del sess, prof

    # ---- 5. bench_speed smoke configs against the oracles ----
    cfg = GraphConfig(name="smoke", algorithm="cc", num_vertices=1 << 12,
                      avg_degree=16, generator="rmat", num_shards=8,
                      priority="log", enforce_fraction=0.1)
    g = G.build_sharded_graph(cfg)
    comp = G.cc_oracle(g.num_real_vertices, G.edge_list(g))
    bsp_out, _ = ops.bsp_connected_components(g, device=dev)
    check(np.array_equal(bsp_out.cpu().numpy(), comp),
          "smoke: BSP labels != union-find oracle")
    expect = {"cc": comp,
              "labelprop": G.labelprop_oracle(g.num_real_vertices, comp=comp)}
    for alg, (ticks0, msgs0) in SMOKE_BASELINE.items():
        c = dataclasses.replace(cfg, algorithm=alg, name=f"smoke-{alg}")
        st, tot = E.run_to_convergence(c, graph=g, device=dev)
        lab = st.values.reshape(-1)[: g.num_real_vertices].cpu().numpy()
        check(tot["converged"] and np.array_equal(lab, expect[alg]),
              f"smoke: {alg} fixpoint wrong")
        say("bench_speed_smoke", program=alg, ticks=tot["ticks"],
            messages=tot["sent"], baseline_ticks=ticks0,
            baseline_messages=msgs0,
            counts_match=(tot["ticks"], tot["sent"]) == (ticks0, msgs0))

    # ---- 6. kernels line, card, last line ----
    src = "src/repro_torch/csrc/semiring_spmv.cu"
    replaces = "src/repro/kernels/semiring_spmv.py:71"

    def entry(name, form, n_launch, err):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": form["ms"],
                "plain_ms": form["plain_ms"], "bound_ms": form["bound_ms"],
                "bound_by": form["bound_by"],
                "library_ms": form["library_ms"]}

    idem = entry("spmv_partials[min,max,min_plus,max_min,or] "
                 "(BSP path: min/int32)", forms[0],
                 sum(n for k, n in launches.items()
                     if not k.startswith("plus_times")),
                 worst["idempotent"])
    idem["forms"] = forms[1:-1]
    pt_form = next(f for f in forms if f["semiring"] == "plus_times")
    pt = entry("spmv_partials[plus_times] (pagerank oracle)", pt_form,
               launches.get("plus_times/float32", 0), worst["plus_times"])
    print(json.dumps({"kernels": [idem, pt]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", flush=True)
        sys.exit(1)
