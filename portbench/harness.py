"""One run of one cell: set-up, the window of whole jobs, then the check.

Set-up makes the edges on the device from the seed with the generator the
configuration names (``generators/``), builds the program's sharded graph
(``core/graph.py::build_sharded_graph``) and runs one warm-up job cut to
the traffic's ``warmup_ticks``.  The window then
runs jobs back to back (``window.py``); a job is one
``core/engine.py::run_to_convergence`` on the built graph, which makes the
session and uploads the graph as every user's job does, plus
``core/merger.py::extract`` of its answer to the host.  After the window:
the device peak is read, the program's state is gone, and the plain
reference the configuration names (``references/``) checks every job's
answer.  With ``control`` the window's jobs are that reference's control
instead of the program, judged by the same check.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from portbench import loader, reference, trace, window

# top-level module names that no run may load (the JAX package, its
# harness and bring-up script, and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke")


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: loader.Cell
    setup_s: float
    build_s: float
    window: window.Window  # outputs: one dict a job (see ``_job``)
    peak_bytes: int
    trace: Optional[trace.Summary]

    @property
    def totals(self) -> list:
        return [job["totals"] for job in self.window.outputs]

    def total(self, key: str) -> int:
        return sum(t[key] for t in self.totals)


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def graph_config(config: dict, seed: int):
    from repro_torch.configs.base import GraphConfig
    scale = int(config["scale"])
    return GraphConfig(name=config["name"], num_vertices=1 << scale,
                       avg_degree=int(config["edgefactor"]),
                       rmat_abcd=tuple(config["initiator"]), seed=seed,
                       **config["engine"])


def fault_plan(traffic: dict, seed: int):
    spec = traffic.get("fault_plan")
    if spec is None:
        return None
    from repro_torch.core.faults import FaultPlan
    return FaultPlan(seed=seed, **spec)


def planned_failures(plan, num_shards: int, ticks: int) -> int:
    """Kills the plan schedules at the host steps a job of ``ticks`` ran."""
    if plan is None:
        return 0
    return sum(len(s) for t, s in plan.schedule(num_shards).items()
               if t < ticks)


def _job(gcfg, graph, plan, device, root, max_ticks=None) -> dict:
    from repro_torch.core import engine, merger, programs
    cfg = (dataclasses.replace(gcfg, source=int(root)) if root is not None
           else gcfg)
    state, totals = engine.run_to_convergence(
        cfg, graph=graph, fault_plan=plan, max_ticks=max_ticks,
        device=device)
    answer = merger.extract(state, graph, programs.get_program(cfg))
    totals.pop("log", None)
    return {"answer": answer, "totals": totals, "root": root}


def _control_job(ref, config, undirected, seed, root, device) -> dict:
    """The reference's control in the program's place: a job that ran no
    tick, took no kill and converged, whose answer the check judges."""
    n = 1 << int(config["scale"])
    edges = torch.from_numpy(undirected).to(device)
    answer = ref.control(edges, n, config, seed, root).cpu().numpy()
    return {"answer": answer, "root": root,
            "totals": {"ticks": 0, "failures": 0, "converged": True}}


def check(cell: loader.Cell, run: Run, undirected: np.ndarray, seed: int,
          plan, num_shards: int, device) -> tuple[dict, list]:
    """Every job's answer against the reference.  Returns ``({name:
    (value, limit)}, [job failed?])``: the numbers compared, each the worst
    job's, and a run is correct when none passes its limit."""
    n = 1 << int(cell.config["scale"])
    ref = loader.module("references", cell.config["reference"])
    root = run.window.outputs[0]["root"]  # every job's, set-up's choice
    expected = ref.expected(torch.from_numpy(undirected).to(device), n,
                            cell.config, seed, root)
    wrong, unconverged, missed = [], [], []
    for job in run.window.outputs:
        totals = job["totals"]
        wrong.append(reference.mismatches(job["answer"], expected))
        unconverged.append(int(not totals["converged"]))
        missed.append(abs(planned_failures(plan, num_shards, totals["ticks"])
                          - totals["failures"]))
    checks = {"wrong_vertices": (max(wrong), 0),
              "unconverged_jobs": (sum(unconverged), 0)}
    if plan is not None:
        checks["missed_failures"] = (sum(missed), 0)
    return checks, [any(x) for x in zip(wrong, unconverged, missed)]


def execute(cell: loader.Cell, seed: int, seconds: float, traced: bool,
            device, t_start: float, clock=time.perf_counter,
            control: bool = False) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    from repro_torch.core.graph import build_sharded_graph
    config, traffic = cell.config, cell.traffic
    seed = int(seed) % (1 << 62)
    n = 1 << int(config["scale"])
    ref = loader.module("references", config["reference"])
    undirected_dev = loader.module("generators", config["generator"]
                                   ).generate(config, seed, device)
    undirected = undirected_dev.cpu().numpy()
    gcfg = graph_config(config, seed)
    root = (ref.source(undirected_dev, n, seed)
            if hasattr(ref, "source") else None)
    del undirected_dev
    if torch.device(device).type == "cuda":
        # the peak is the program's: the generator's buffers are gone
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = clock()
    graph = build_sharded_graph(gcfg, edges=undirected)
    build_s = clock() - t0
    plan = fault_plan(traffic, seed)
    # a job ends in extract's copy to the host, which waits for the card
    _job(gcfg, graph, plan, device, root,
         max_ticks=int(traffic["warmup_ticks"]))
    gc.collect()
    setup_s = clock() - t_start

    def job(i):
        if control:
            return _control_job(ref, config, undirected, seed, root, device)
        return _job(gcfg, graph, plan, device, root)

    def measured():
        return window.run_window(job, seconds, clock)

    if traced:
        win, summary = trace.record(measured)
    else:
        win, summary = measured(), None
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    run = Run(cell, setup_s, build_s, win, peak, summary)
    checks, bad = check(cell, run, undirected, seed, plan, gcfg.num_shards,
                        device)
    return result(cell, run, checks, bad, traced, device)


def result(cell: loader.Cell, run: Run, checks: dict, bad: list,
           traced: bool, device) -> dict:
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = loader.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= limit for v, limit in checks.values())
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": correct, "attempted": run.window.jobs,
           "failed": sum(bad),
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["job_seconds"] = run.window.durations
    out["job_totals"] = [dict(t, root=job["root"])
                         for t, job in zip(run.totals, run.window.outputs)]
    out["checks"] = {k: {"value": v, "limit": limit}
                     for k, (v, limit) in checks.items()}
    return out
