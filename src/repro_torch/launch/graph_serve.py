"""Online graph-mining service launcher on PyTorch (the serving-plane driver).

Counterpart of ``repro.launch.graph_serve`` with the same options, plus
``--device`` (default ``cuda``).  Builds a
:class:`~repro_torch.serve.graph.GraphServer` over a config's graph,
converges every requested program, publishes the fixpoints to a sharded
:class:`~repro_torch.serve.store.FixpointStore` epoch, answers a batch of
seeded point queries through the slot-batching
:class:`~repro_torch.serve.graph.QueryServer`, then streams seeded edge
deltas through the incremental path and reports the freshness stats
(frontier re-activated, ticks back to quiescence) per delta.  The printed
counts and the ``--metrics`` JSON equal the JAX launcher's for the same
options on the CPU.

  python -m repro_torch.launch.graph_serve --config asymp_cc_large \
      --programs cc,sssp --store /tmp/fp --queries 256 --deltas 4
  python -m repro_torch.launch.graph_serve --config asymp_cc --reduced \
      --device cpu --store /tmp/fp
  python -m repro_torch.launch.graph_serve --config asymp_cc --reduced \
      --device cpu --schedule async
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
from repro_torch.serve.engine import QueueFullError
from repro_torch.serve.graph import (KIND_PROGRAM, GraphQuery, GraphServer,
                                     QueryServer)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="asymp_cc")
    ap.add_argument("--programs", default="cc,sssp,pagerank",
                    help="comma-separated program names to serve")
    ap.add_argument("--store", default="",
                    help="fixpoint store directory (omit: serve live state)")
    ap.add_argument("--schedule", default=None, choices=("sync", "async"))
    ap.add_argument("--queries", type=int, default=32,
                    help="seeded point queries to batch through the slots")
    ap.add_argument("--topk", type=int, default=2,
                    help="top_k_near queries riding the batch (PPR path)")
    ap.add_argument("--deltas", type=int, default=2,
                    help="seeded 1-edge streaming deltas to apply")
    ap.add_argument("--delta-size", type=int, default=1,
                    help="edges inserted per delta")
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue (submits past it are "
                         "rejected with typed backpressure)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-query deadline budget in milliseconds "
                         "(overdue queries retire with a typed answer)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="run the config's tiny .reduced() variant")
    ap.add_argument("--enforce-fraction", type=float, default=None,
                    help="override enforce_fraction (pagerank in a "
                         "tick-budgeted config wants 1.0)")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="override max_ticks (push-mode convergence "
                         "budget)")
    ap.add_argument("--metrics", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' = the card, 'cpu' = host)")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card: say so instead of a traceback
        sys.exit(f"[graph_serve] {e}")

    cfg = get_graph_config(args.config)
    if args.reduced:
        cfg = cfg.reduced()
    if args.schedule is not None:
        cfg = dataclasses.replace(cfg, schedule=args.schedule)
    if args.enforce_fraction is not None:
        cfg = dataclasses.replace(cfg, enforce_fraction=args.enforce_fraction)
    if args.max_ticks is not None:
        cfg = dataclasses.replace(cfg, max_ticks=args.max_ticks)
    programs = tuple(p for p in args.programs.split(",") if p)
    if "sssp" in programs and not cfg.weighted:
        cfg = dataclasses.replace(cfg, weighted=True)

    print(f"[graph_serve] {cfg.name}: programs={','.join(programs)} "
          f"V={cfg.num_vertices} E~{cfg.num_edges} shards={cfg.num_shards} "
          f"schedule={cfg.schedule} store={args.store or '<live>'} "
          f"device={device}")
    srv = GraphServer(cfg, programs=programs, store_dir=args.store or None,
                      schedule=args.schedule, device=device)
    t0 = time.time()
    totals = srv.converge()
    for name, tot in totals.items():
        print(f"[graph_serve] {name}: {tot['ticks']} ticks, "
              f"converged={tot['converged']}")
    print(f"[graph_serve] converged {len(programs)} programs in "
          f"{time.time() - t0:.1f}s; epoch={srv.epoch}")
    stuck = [n for n, tot in totals.items() if not tot["converged"]]
    if stuck:
        raise SystemExit(
            f"[graph_serve] not converged within max_ticks={cfg.max_ticks}: "
            f"{','.join(stuck)} (pagerank at enforce_fraction<1 wants a "
            f"bigger budget; try --enforce-fraction 1.0 or --max-ticks)")

    rng = np.random.default_rng(args.seed)
    n = srv.graph.num_real_vertices
    kinds = sorted(k for k in KIND_PROGRAM if KIND_PROGRAM[k] in programs)
    qs = QueryServer(
        srv, num_slots=args.slots, max_queue=args.max_queue,
        deadline_s=(args.deadline_ms / 1e3
                    if args.deadline_ms is not None else None))
    rid = 0
    for _ in range(args.queries):
        try:
            qs.submit(GraphQuery(rid, kinds[rid % len(kinds)],
                                 int(rng.integers(n))))
        except QueueFullError:
            pass  # counted by the admission queue
        rid += 1
    for _ in range(args.topk):
        try:
            qs.submit(GraphQuery(rid, "top_k_near", int(rng.integers(n)),
                                 k=5))
        except QueueFullError:
            pass
        rid += 1
    t0 = time.time()
    qs.run()
    qstats = qs.stats()
    print(f"[graph_serve] answered {qs.served} queries in {qs.batches} "
          f"batches ({time.time() - t0:.3f}s); rejected={qstats['rejected']} "
          f"deadline_exceeded={qstats['deadline_exceeded']} "
          f"freshness_lag_max={qstats['freshness_lag_max']}")

    delta_rows = []
    for i in range(args.deltas):
        ins = [(int(rng.integers(n)), int(rng.integers(n)))
               for _ in range(args.delta_size)]
        t0 = time.time()
        stats = srv.apply_delta(insertions=ins)
        wall = time.time() - t0
        row = {name: {"reactivated": s.reactivated, "ticks": s.ticks,
                      "full_reseed": s.full_reseed}
               for name, s in stats.items()}
        delta_rows.append(row)
        worst = max((s.ticks for s in stats.values()), default=0)
        react = max((s.reactivated for s in stats.values()), default=0)
        print(f"[graph_serve] delta {i}: +{args.delta_size} edge(s) -> "
              f"reactivated<={react} ({100.0 * react / n:.2f}% of V), "
              f"freshness lag {worst} ticks, epoch={srv.epoch} "
              f"({wall:.2f}s)")

    cstats = srv.ppr_cache.stats()
    print(f"[graph_serve] ppr cache: size={cstats['size']}/"
          f"{cstats['capacity']} hits={cstats['hits']} "
          f"misses={cstats['misses']} hit_rate={cstats['hit_rate']:.2f} "
          f"invalidations={cstats['invalidations']}")

    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump({"queries": qs.served, "batches": qs.batches,
                       "epoch": srv.epoch, "deltas": delta_rows,
                       "admission": qs.stats()}, f, indent=1)
        print(f"[graph_serve] wrote metrics to {args.metrics}")


if __name__ == "__main__":
    main()
