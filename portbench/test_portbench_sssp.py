"""CPU tests of the benchmark's Graph500 kernel 3 SSSP configuration: its
file and manifest entries, the fixed dataset and source, the reference's
weights against the program's build, a job of the program against the
reference bit for bit, the reference against Graph500's own validation,
the control, and the ``fetches_per_edge`` reader.  Every run here is at Graph500 scale
8-9 on the CPU; ``test_portbench_harness.py`` runs the cell whole through
the harness, as it runs every cell of the manifest."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import harness, loader, reference, window

CELL = "g500-sssp-healthy"
SEED = 2 ** 31 + 977  # a run's seed may pass 32 signed bits
MANIFEST = loader.manifest()
graph500 = loader.module("generators", "graph500")
dataset = loader.module("generators", "graph500_dataset")
g500_sssp = loader.module("references", "graph500_sssp")
fetches_per_edge = loader.reader("fetches_per_edge")


def small(scale: int = 9) -> loader.Cell:
    c = loader.cell(CELL)
    config = dict(c.config, scale=scale)
    config["engine"] = dict(config["engine"], num_shards=4)
    return dataclasses.replace(c, config=config)


def _built(scale=9, seed=SEED):
    """The cell's edge list and the program's build of it."""
    from repro_torch.core.graph import build_sharded_graph
    c = small(scale)
    n = 1 << scale
    und = dataset.generate(c.config, seed, "cpu")
    gcfg = harness.graph_config(c.config, seed)
    return c, n, und, gcfg, build_sharded_graph(gcfg, edges=und.numpy())


# ---------------------------------------------------------- the manifest
def test_the_configuration_and_its_cell():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    entry, cell = configs["graph500-sssp"], cells[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "graph500-sssp", "healthy", 1)
    config = json.loads((loader.ROOT / entry["file"]).read_text())
    assert config["source"] == entry["source"]
    assert sorted(config["reduced"]) == entry["reduced"] == ["scale"]
    assert config["source_scale"] == 26 and config["scale"] == 20
    assert config["reference"] == "graph500_sssp"
    assert config["generator"] == "graph500_dataset"
    engine = config["engine"]
    assert (engine["algorithm"], engine["weighted"], engine["weight_rule"]
            ) == ("sssp", True, "undirected")
    # one dataset: the graph's seed is the weights'
    assert engine["weight_seed"] == config["dataset_seed"]
    gcfg = harness.graph_config(config, SEED)  # every key is GraphConfig's
    assert gcfg.num_vertices == 1 << config["scale"]
    assert {"dataset", "dataset_seed", "source_vertex", "vertex_order",
            "isolated_vertices", "weight_rng", "generator_seed"
            } <= set(config["assumed"])


def test_fetches_per_edge_is_every_fixpoint_cells():
    for w in MANIFEST["workloads"]:
        names = [m["name"] for m in loader.cell(w["name"]).per_layer]
        assert "fetches_per_edge" in names, w["name"]


# ----------------------------------------------------------- the dataset
def test_the_dataset_is_one_graph_whatever_the_seed():
    c = small()
    graphs = [dataset.generate(c.config, SEED + i, "cpu") for i in range(3)]
    assert all(torch.equal(g, graphs[0]) for g in graphs)
    assert torch.equal(graphs[0], graph500.generate(
        c.config, c.config["dataset_seed"], "cpu"))


def test_every_run_is_the_same_job():
    """Two seeds, one job: the same work and the same correct answer, so
    a run's time moves only with the machine."""
    outs = [harness.execute(small(), SEED + i, 0.2, False, "cpu", 0.0)
            for i in range(2)]
    assert all(out["correct"] for out in outs)
    first = [out["job_totals"][0] for out in outs]
    assert first[0] == first[1] and first[0]["ticks"] > 0
    # the weights are the dataset's too: another weight seed, another job
    c = small()
    config = dict(c.config, engine=dict(c.config["engine"],
                                        weight_seed=SEED))
    other = harness.execute(dataclasses.replace(c, config=config), SEED,
                            0.2, False, "cpu", 0.0)
    assert other["correct"]
    assert other["job_totals"][0] != first[0]


# ----------------------------------------------------------- the source
def test_the_source_is_the_highest_degree_vertex_not_a_draw():
    _, n, und, _, g = _built()
    deg = g.degrees().reshape(-1)[:n]
    root = g500_sssp.source(und, n, SEED)
    assert deg[root] == deg.max()
    assert root == int(np.flatnonzero(deg == deg.max())[0])
    assert {g500_sssp.source(und, n, SEED + i) for i in range(8)} == {root}


def test_the_source_takes_the_least_id_on_a_tie():
    edges = torch.tensor([[0, 1], [2, 3], [2, 4], [3, 4], [4, 5]])
    # degrees 1, 1, 2, 2, 3, 1: vertex 4 alone has the most
    assert g500_sssp.source(edges, 6, 0) == 4
    tie = torch.tensor([[2, 5], [3, 5], [1, 6], [1, 7]])
    assert g500_sssp.source(tie, 8, 0) == 1  # 1 and 5 both have 2


# --------------------------------------------------------- the weights
def test_the_reference_weights_are_the_programs_build():
    from repro_torch.core.graph import edge_list
    _, n, und, gcfg, g = _built()
    edges, w = edge_list(g, with_weights=True)
    draws = g500_sssp.weights(len(und), gcfg.weight_seed)
    key = und[:, 0].numpy() * n + und[:, 1].numpy()
    lo, hi = edges.min(axis=1), edges.max(axis=1)
    i = np.searchsorted(key, lo * n + hi)
    assert np.array_equal(key[i], lo * n + hi)
    assert np.array_equal(w, draws[i])  # both directions, the i-th draw
    assert w.dtype == np.float32 and 0.0 <= w.min() and w.max() < 1.0


# ----------------------------------------------------------- a job
@pytest.mark.parametrize("scale", [8, 9])
def test_a_job_equals_the_reference_bit_for_bit(scale):
    from repro_torch.core import engine, merger, programs
    c, n, und, gcfg, g = _built(scale)
    root = g500_sssp.source(und, n, SEED)
    cfg = dataclasses.replace(gcfg, source=root)
    state, totals = engine.run_to_convergence(cfg, graph=g, device="cpu")
    got = merger.extract(state, g, programs.get_program(cfg))
    want = g500_sssp.expected(und, n, c.config, gcfg.seed, root)
    assert totals["converged"] and totals["edges"] == 2 * len(und)
    assert got.dtype == np.float32
    assert reference.mismatches(got, want) == 0
    assert np.array_equal(got, want.numpy())
    assert 1 < np.isfinite(got).sum() < n  # reached most, not the isolated


def test_the_reference_passes_graph500s_validation():
    """Kernel 3's check, in float32: no edge relaxes a distance further,
    and every reached vertex but the source has an edge that is tight."""
    c, n, und, gcfg, _ = _built()
    root = g500_sssp.source(und, n, SEED)
    d = g500_sssp.expected(und, n, c.config, gcfg.seed, root)
    w = torch.from_numpy(g500_sssp.weights(len(und), gcfg.weight_seed))
    src = torch.cat([und[:, 0], und[:, 1]])
    dst = torch.cat([und[:, 1], und[:, 0]])
    via = d[src] + torch.cat([w, w])
    assert bool((d[dst] <= via).all()) and float(d[root]) == 0.0
    tight = torch.zeros(n, dtype=torch.bool)
    tight[dst[(via == d[dst]) & torch.isfinite(via)]] = True
    reached = torch.isfinite(d)
    reached[root] = False
    assert bool(tight[reached].all())


def test_the_control_differs_from_the_reference():
    c, n, und, gcfg, _ = _built()
    root = g500_sssp.source(und, n, SEED)
    args = (und, n, c.config, gcfg.seed, root)
    wrong = reference.mismatches(g500_sssp.control(*args).numpy(),
                                 g500_sssp.expected(*args))
    assert wrong > n // 4


# ---------------------------------------------------------- the reader
def _run(totals_list):
    win = window.Window(1.0, [0.5] * len(totals_list),
                        [{"totals": t, "root": 0, "answer": None}
                         for t in totals_list])
    return harness.Run(small(), 1.0, 1.0, win, 0, None)


def test_fetches_per_edge_reads_the_totals():
    totals = [{"fetched": 3000, "edges": 1000},
              {"fetched": 2000, "edges": 1000}]
    assert fetches_per_edge(_run(totals)) == pytest.approx(2.5)
    assert fetches_per_edge(_run([{"fetched": 3000}])) is None
