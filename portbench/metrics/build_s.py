"""Host seconds of ``core/graph.py::build_sharded_graph`` on the generated
edge list, in set-up (host clock)."""


def read(run):
    return run.build_s
