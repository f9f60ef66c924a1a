"""One fixed Graph500 graph: the Kronecker graph of ``graph500.py``, with
its cleaning, drawn from the configuration's ``dataset_seed`` whatever the
run's seed.  Graphalytics ships each dataset as one file, so every run of
its job meets the same graph; a configuration that pins its weights too
(``engine.weight_seed``) runs one job, the same work in every run."""
from portbench import loader


def generate(cfg: dict, seed: int, device):
    """The configuration's dataset; ``seed`` is not read."""
    return loader.module("generators", "graph500").generate(
        cfg, int(cfg["dataset_seed"]), device)
