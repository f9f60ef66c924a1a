from repro_torch.core import engine, graph, merger, programs, semiring  # noqa: F401
