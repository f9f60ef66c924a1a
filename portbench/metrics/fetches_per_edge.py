"""Edges fetched a job over the graph's directed edges (the job's totals
from ``run_to_convergence``, ``fetched / edges``): relaxations over
Dijkstra's ideal of one an edge, the work the priority scheduler's order
makes the engine do again.  Nothing to read where the totals have no
``edges``."""


def read(run):
    if not run.totals or not all("edges" in t for t in run.totals):
        return None
    return run.total("fetched") / run.total("edges")
