"""ASYMP graph-mining job launcher on PyTorch (the paper's production job runner).

Counterpart of ``repro.launch.graph_mine`` with the same options, plus
``--device`` (default ``cuda``).  Runs the propagation phase to
convergence, with optional rolling shard failures, crowded-cluster
emulation (§5.4) and the barrier-free async schedule, and the merger
phase; writes the output table and the metrics.

  python -m repro_torch.launch.graph_mine --config asymp_cc
  python -m repro_torch.launch.graph_mine --config asymp_sssp --out /tmp/sssp.tsv
  python -m repro_torch.launch.graph_mine --config asymp_cc --reduced --device cpu
  python -m repro_torch.launch.graph_mine --config asymp_pagerank \
      --failures 0.5 --device cpu   # checkpoint-restore recovery (SUM)
  python -m repro_torch.launch.graph_mine --config asymp_cc_large \
      --slowdown 0.5 --link-delay 2 --intensity 4   # crowded (stragglers)
  python -m repro_torch.launch.graph_mine --config asymp_cc_crowded \
      --reduced --schedule async --device cpu       # barrier-free
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_graph_config
from repro_torch.core import engine as E
from repro_torch.core import graph as G
from repro_torch.core import merger
from repro_torch.core import programs as PR
from repro_torch.core.faults import FaultPlan
from repro_torch.dist import latency as lat_mod


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="asymp_cc")
    ap.add_argument("--algorithm", default=None, choices=sorted(PR.PROGRAMS),
                    help="run any registered program on the config's graph "
                         "(no dedicated config needed)")
    ap.add_argument("--source", type=int, default=None,
                    help="source vertex for single-source programs")
    ap.add_argument("--failures", type=float, default=0.0,
                    help="fraction of shards to fail (0.5/1.0/2.0)")
    ap.add_argument("--priority", default=None)
    ap.add_argument("--enforce", type=float, default=None)
    ap.add_argument("--latency-profile", default=None,
                    choices=sorted(lat_mod.PROFILES),
                    help="crowded-cluster emulation profile (§5.4; "
                         "dist/latency.py)")
    ap.add_argument("--slowdown", type=float, default=None,
                    help="fraction of shards crowded (implies "
                         "--latency-profile stragglers unless given)")
    ap.add_argument("--link-delay", type=int, default=None,
                    help="extra wire ticks on a crowded shard's links")
    ap.add_argument("--intensity", type=int, default=None,
                    help="work-budget divisor for crowded shards")
    ap.add_argument("--schedule", default=None, choices=("sync", "async"),
                    help="sync = BSP tick barrier; async = barrier-free "
                         "per-shard progress (seeded interleaving)")
    ap.add_argument("--async-seed", type=int, default=None,
                    help="seed for the async interleaving (determinism)")
    ap.add_argument("--reduced", action="store_true",
                    help="run the config's tiny .reduced() variant "
                         "(CI smoke)")
    ap.add_argument("--out", default="")
    ap.add_argument("--metrics", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the CUDA card)")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card: say so instead of a traceback
        sys.exit(f"[graph_mine] {e}")

    cfg = get_graph_config(args.config)
    kw = {}
    if args.priority:
        kw["priority"] = args.priority
    if args.enforce is not None:
        kw["enforce_fraction"] = args.enforce
    if args.algorithm:
        kw["algorithm"] = args.algorithm
    if args.source is not None:
        kw["source"] = args.source
    if args.slowdown is not None:
        kw["slow_fraction"] = args.slowdown
        if args.latency_profile is None and cfg.latency_profile == "none":
            kw["latency_profile"] = "stragglers"
    if args.latency_profile is not None:
        kw["latency_profile"] = args.latency_profile
    if args.link_delay is not None:
        kw["link_delay"] = args.link_delay
    if args.intensity is not None:
        kw["slow_intensity"] = args.intensity
    if args.schedule is not None:
        kw["schedule"] = args.schedule
    if args.async_seed is not None:
        kw["async_seed"] = args.async_seed
    if kw:
        cfg = dataclasses.replace(cfg, **kw)
    if args.reduced:
        cfg = cfg.reduced()
    prog = PR.get_program(cfg)
    if prog.weighted and not cfg.weighted:
        # weighted programs need edge weights on the graph
        cfg = dataclasses.replace(cfg, weighted=True)

    print(f"[graph_mine] {cfg.name}: program={prog.name} "
          f"({prog.aggregator.name}-aggregation"
          f"{', weighted' if prog.weighted else ''}) "
          f"V={cfg.num_vertices} E~{cfg.num_edges} shards={cfg.num_shards} "
          f"priority={cfg.priority}@{cfg.enforce_fraction} "
          f"schedule={cfg.schedule} device={device}")
    t0 = time.time()
    graph = G.build_sharded_graph(cfg)
    print(f"[graph_mine] built CSR in {time.time() - t0:.1f}s "
          f"({graph.num_edges} directed edges after symmetrize)")

    plan = (FaultPlan(fail_fraction=args.failures, start_tick=4, every=6)
            if args.failures > 0 else None)
    if cfg.latency_profile != "none":
        print(f"[graph_mine] crowded-cluster emulation: "
              f"{lat_mod.from_config(cfg).describe()} "
              f"(straggler_demote={cfg.straggler_demote})")
    t0 = time.time()
    state, totals = E.run_to_convergence(cfg, graph=graph, prog=prog,
                                         fault_plan=plan, collect_log=True,
                                         device=device)
    wall = time.time() - t0
    print(f"[graph_mine] propagation: {totals['ticks']} ticks, "
          f"{totals['sent']} messages, {totals['failures']} failures, "
          f"converged={totals['converged']} in {wall:.1f}s")

    out = merger.extract(state, graph, prog)
    if args.out:
        with open(args.out, "w") as f:
            for i, v in enumerate(out):
                f.write(f"{i}\t{v}\n")
        print(f"[graph_mine] wrote {len(out)} rows to {args.out}")
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(dict(totals), f, indent=1)
    if cfg.algorithm in ("cc", "labelprop"):
        summary = f"components={len(np.unique(out))}"
    elif cfg.algorithm == "reachability":
        summary = f"reached={int(np.sum(out))}"
    elif cfg.algorithm == "pagerank":
        # unnormalized ranks: mass/n == 1 iff no probability leaked at
        # degree-0 vertices (the push program's absorb convention)
        out_f = out.astype(np.float64)
        summary = (f"mass={out_f.sum() / len(out):.4f};"
                   f"top={int(out_f.argmax())}")
    else:  # distance/width-valued programs: unreached = the identity
        out_f = out.astype(np.float64)
        reached = np.asarray(prog.aggregator.improves(out_f,
                                                      float(prog.identity)))
        finite = reached & np.isfinite(out_f)
        summary = (f"reached={int(reached.sum())};"
                   f"mean={out_f[finite].mean():.3f}" if finite.any()
                   else f"reached={int(reached.sum())}")
    print(f"[graph_mine] merger ({prog.name}): {len(out)} vertices, "
          f"{summary}")


if __name__ == "__main__":
    main()
