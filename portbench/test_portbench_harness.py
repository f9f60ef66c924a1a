"""CPU tests of the benchmark: the manifest's files, the window, the
generator, the references against the port and the union-find oracle, the
check against planted faults and the controls, the trace reduction, and
the import rule.  Every run here is at Graph500 scale 8-9 on the CPU.

SSSP has no cell yet; ``references/sssp.py`` is tested on a configuration
made here from the WCC one, so that its cell is only files to add."""
import ast
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from portbench import harness, loader, reference, trace, window

HERE = pathlib.Path(__file__).resolve().parent
MANIFEST = loader.manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2 ** 31 + 977  # a run's seed may pass 32 signed bits
SSSP = "sssp"  # the SSSP configuration made by ``small``
graph500 = loader.module("generators", "graph500")


def small(name: str, scale: int = 9) -> loader.Cell:
    """A cell of the manifest cut to ``scale`` and 4 shards; ``SSSP`` is
    the healthy WCC cell's graph under the SSSP reference and program."""
    c = loader.cell("g500-wcc-healthy" if name == SSSP else name)
    config = dict(c.config, scale=scale)
    config["engine"] = dict(config["engine"], num_shards=4)
    if name == SSSP:
        config.update(name="graph500-sssp", reference="sssp")
        config["engine"].update(algorithm="sssp", weighted=True)
    return dataclasses.replace(c, config=config)


def run_small(name: str, seed: int = SEED, **kw) -> dict:
    return harness.execute(small(name), seed, 0.5, False, "cpu", 0.0, **kw)


# ---------------------------------------------------------------- loader
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    c = loader.cell(name)
    assert c.config["name"] == c.entry["config"]
    assert "warmup_ticks" in c.traffic
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "fixpoint_s"}
    assert c.per_layer, "a cell reports at least one per-layer metric"


@pytest.mark.parametrize(
    "metric", [m["name"] for m in MANIFEST["end_to_end"]
               + MANIFEST["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(loader.reader(metric))


def test_every_config_file_lies_under_paths_and_is_its_own():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.split("/")[0] in MANIFEST["paths"]
        assert json.loads((loader.ROOT / f).read_text())["name"] in {
            c["name"] for c in MANIFEST["configs"]}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        loader.cell("no-such-cell")


@pytest.mark.parametrize("kind,key", [("generators", "generator"),
                                      ("references", "reference")])
def test_every_config_names_its_generator_and_reference(kind, key):
    for c in MANIFEST["configs"]:
        config = json.loads((loader.ROOT / c["file"]).read_text())
        assert loader.module(kind, config[key]) is not None
    with pytest.raises(KeyError):
        loader.module(kind, "no-such-file")


# ---------------------------------------------------------------- window
class FakeClock:
    def __init__(self, job_seconds):
        self.t, self.job_seconds = 100.0, list(job_seconds)

    def __call__(self):
        return self.t

    def job(self, i):
        self.t += self.job_seconds[i]
        return i


@pytest.mark.parametrize("jobs,seconds,expect", [
    ([10, 10, 10, 10, 10], 31, 3),   # a 4th would end at 40 > 31
    ([10, 10, 10, 10, 10], 30, 3),   # ends exactly at the limit: it runs
    ([40, 40], 10, 1),               # always one whole job
    ([5, 20, 5, 5], 26, 2),          # the last job's time sets the guess
])
def test_window_holds_whole_jobs(jobs, seconds, expect):
    clock = FakeClock(jobs)
    win = window.run_window(clock.job, seconds, clock)
    assert win.jobs == expect
    assert win.outputs == list(range(expect))
    assert win.span_s == pytest.approx(sum(jobs[:expect]))
    assert win.seconds_per_job == pytest.approx(sum(jobs[:expect]) / expect)


# ------------------------------------------------------------- generator
def test_generator_is_seeded_and_clean():
    cfg = {"scale": 9, "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05]}
    a = graph500.generate(cfg, SEED, "cpu")
    assert torch.equal(a, graph500.generate(cfg, SEED, "cpu"))
    assert not torch.equal(a, graph500.generate(cfg, SEED + 1, "cpu"))
    lo, hi = a[:, 0], a[:, 1]
    assert bool((lo < hi).all()) and int(hi.max()) < 512
    key = lo * 512 + hi
    assert bool((key[1:] > key[:-1]).all())  # sorted, no duplicate
    assert 0.5 * 16 * 512 < len(a) <= 16 * 512


def test_generator_skews_to_low_ids_as_the_initiator_says():
    src, dst = graph500.kronecker_edges(12, 16, [0.57, 0.19, 0.19, 0.05],
                                        SEED, "cpu")
    # the top bit of a source is 1 with probability C + D = 0.24
    top = (src >> 11).double().mean().item()
    assert abs(top - 0.24) < 0.01
    assert abs((dst >> 11).double().mean().item() - 0.24) < 0.01


# ------------------------------------------------------------- reference
def _program_graph(name, seed=SEED):
    from repro_torch.core.graph import build_sharded_graph
    c = small(name)
    n = 1 << c.config["scale"]
    und = graph500.generate(c.config, seed, "cpu")
    gcfg = harness.graph_config(c.config, seed)
    return c, n, und, gcfg, build_sharded_graph(gcfg, edges=und.numpy())


def test_wcc_reference_matches_union_find():
    from repro_torch.core.graph import cc_oracle
    _, n, und, _, _ = _program_graph("g500-wcc-healthy")
    src, dst = reference.directed(und, n)
    ref = reference.wcc(src, dst, n)
    assert np.array_equal(ref.numpy(), cc_oracle(n, und.numpy()))


def test_weights_rule_is_the_programs_build():
    _, n, und, gcfg, g = _program_graph(SSSP)
    src, _ = reference.directed(und, n)
    w = reference.weights(src.numel(), gcfg.seed)
    real = np.arange(g.es)[None, :] < g.edge_counts[:, None]
    assert np.array_equal(g.weights[real], w)


def test_sssp_reference_matches_the_port_exactly():
    from repro_torch.core import engine
    c, n, und, gcfg, g = _program_graph(SSSP)
    src, dst = reference.directed(und, n)
    w = torch.from_numpy(reference.weights(src.numel(), gcfg.seed))
    ref_file = loader.module("references", "sssp")
    hub = int(torch.argmax(torch.bincount(und.reshape(-1), minlength=n)))
    for root in (ref_file.source(und, n, SEED), hub, int(dst[0])):
        cfg = dataclasses.replace(gcfg, source=int(root))
        state, totals = engine.run_to_convergence(cfg, graph=g, device="cpu")
        got = state.values.reshape(-1)[:n].numpy()
        assert totals["converged"]
        ref = reference.sssp(src, dst, w, n, root)
        assert reference.mismatches(got, ref) == 0
        assert np.isfinite(got).sum() > 1


def test_the_source_is_a_vertex_with_an_edge_drawn_from_the_seed():
    _, n, und, _, g = _program_graph(SSSP)
    deg = g.degrees().reshape(-1)[:n]
    source = loader.module("references", "sssp").source
    roots = {source(und, n, SEED + i) for i in range(16)}
    assert all(deg[r] > 0 for r in roots)
    assert len(roots) > 8  # the seed draws the root
    assert source(und, n, SEED) == source(und, n, SEED)


# ------------------------------------------------------- run and check
@pytest.mark.parametrize("name", CELLS + [SSSP])
def test_a_sound_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {"setup_s", "fixpoint_s"} <= set(out["metrics"])


def test_the_seed_makes_the_run():
    a, b, c = (run_small(n, s) for n, s in (
        ("g500-wcc-healthy", SEED), ("g500-wcc-healthy", SEED),
        ("g500-wcc-healthy", SEED + 1)))
    first = [out["job_totals"][0] for out in (a, b, c)]
    assert first[0] == first[1] != first[2]


def test_fail50_runs_the_plans_kills():
    out = run_small("g500-wcc-fail50")
    assert out["checks"]["missed_failures"]["value"] == 0
    assert all(t["failures"] >= 1 for t in out["job_totals"])


def _plant_answer(monkeypatch, alter):
    from repro_torch.core import merger
    real = merger.extract

    def extract(state, graph, prog):
        out = real(state, graph, prog).copy()
        alter(out)
        return out
    monkeypatch.setattr(merger, "extract", extract)


@pytest.mark.parametrize("name", CELLS + [SSSP])
def test_a_planted_wrong_answer_fails(monkeypatch, name):
    def alter(a):  # one label or one distance, where it is produced
        i = int(np.argmax(np.isfinite(a) & (a > 0)))
        a[i] = a[i] + 1 if a.dtype.kind == "i" else np.nextafter(
            a[i], np.float32(np.inf))
    _plant_answer(monkeypatch, alter)
    out = run_small(name)
    assert not out["correct"]
    assert out["checks"]["wrong_vertices"]["value"] == 1
    assert out["failed"] == out["attempted"]


def _patch_exchange(monkeypatch, keep_rows):
    from repro_torch.dist import exchange
    real = exchange.exchange_local

    def exchange_local(codec, sv, si):
        rv, ri = real(codec, sv, si)
        ri = ri.clone()
        ri[keep_rows(ri.shape[0]):] = -1
        return rv, ri
    monkeypatch.setattr(exchange, "exchange_local", exchange_local)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "no_exchange"])
@pytest.mark.parametrize("name", ["g500-wcc-healthy", SSSP])
def test_a_broken_tick_fails(monkeypatch, fault, name):
    from repro_torch.core import engine
    if fault == "state_unchanged":
        def make_local_tick(prog, ep, weighted):
            def tick(state, g):
                zero = torch.zeros((), dtype=torch.int64)
                return state, engine.TickStats(zero, zero, zero, zero), None
            return tick
        monkeypatch.setattr(engine, "make_local_tick", make_local_tick)
    elif fault == "half_the_batch":
        _patch_exchange(monkeypatch, lambda p: p // 2)
    else:
        _patch_exchange(monkeypatch, lambda p: 0)
    out = run_small(name)
    assert not out["correct"]
    assert out["checks"]["wrong_vertices"]["value"] > 0


def test_an_unconverged_job_fails():
    c = small("g500-wcc-healthy")
    config = dict(c.config, engine=dict(c.config["engine"], max_ticks=2))
    out = harness.execute(dataclasses.replace(c, config=config), SEED, 0.1,
                          False, "cpu", 0.0)
    assert not out["correct"]
    assert out["checks"]["unconverged_jobs"]["value"] == out["attempted"]


def test_a_plan_that_does_not_run_fails(monkeypatch):
    from repro_torch.core import faults
    monkeypatch.setattr(faults.FaultManager, "maybe_fail",
                        lambda self, t, state, plan, clock=None:
                        (state, {"failures": 0, "replayed": 0}))
    out = run_small("g500-wcc-fail50")
    assert not out["correct"]
    assert out["checks"]["missed_failures"]["value"] > 0


@pytest.mark.parametrize("name", CELLS + [SSSP])
def test_the_control_fails_the_check(name):
    out = run_small(name, control=True)
    assert not out["correct"]
    assert out["checks"]["wrong_vertices"]["value"] > 0
    assert out["failed"] == out["attempted"] >= 1
    assert all(t["ticks"] == 0 for t in out["job_totals"])  # no program


def test_metrics_of_a_traced_run_read_the_summary():
    c = small("g500-wcc-fail50")
    totals = {"ticks": 100, "sent": 1000, "accepted": 50, "fetched": 1000,
              "replayed": 30, "failures": 2, "converged": True}
    win = window.Window(2.0, [1.0, 1.0], [{"totals": totals, "root": None,
                                            "answer": None}] * 2)
    summ = trace.Summary(window_s=2.0, busy_s=1.5, device_ops=[],
                         idle_gaps=[])
    run = harness.Run(c, 10.0, 5.0, win, 2 ** 30, summ)
    out = harness.result(c, run, {"wrong_vertices": (0, 0)}, [False, False],
                         True, "cpu")
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["ticks_per_job"] == 100
    assert m["accept_share"] == pytest.approx(5.0)
    assert m["device_ms_per_tick"] == pytest.approx(7.5)
    assert m["host_ms_per_tick"] == pytest.approx(2.5)
    assert m["device_idle"] == pytest.approx(25.0)
    assert m["replayed_per_job"] == 30
    assert m["build_s"] == 5.0
    needed = 2000 * 8 + 2000 * 16 + 100 * 4
    assert m["tick_bw_share"] == pytest.approx(100 * needed / (1.5 * 3.35e12))
    assert out["device"]["busy_s"] == 1.5 and "breakdown" in out


# ----------------------------------------------------------------- trace
def test_trace_summary_splits_busy_and_idle():
    E = trace.Event
    events = [
        E("aten::add", "op", 0, 100, 1),
        E("cudaLaunchKernel", "runtime", 10, 20, 1, corr=7),
        E("aten::scatter_", "op", 30, 60, 1),
        E("cudaLaunchKernel", "runtime", 40, 50, 1, corr=8),
        E("void k1<int>(int)", "device", 25, 45, 0, corr=7),
        E("void k2<float>(x)", "device", 55, 70, 0, corr=8),
        E("cudaStreamSynchronize", "runtime", 100, 130, 1, corr=9),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(130e-9)
    assert s.busy_s == pytest.approx(35e-9)
    ops = dict(s.device_ops)
    assert ops["aten::add | k1"] == pytest.approx(20e-9)
    assert ops["aten::scatter_ | k2"] == pytest.approx(15e-9)
    gaps = dict(s.idle_gaps)
    # idle [0, 25): add 10, launch 10, add 5; [45, 55): launch 5,
    # scatter_ 5; [70, 130): add 30, sync 30
    assert gaps["aten::add"] == pytest.approx(45e-9)
    assert gaps["cudaLaunchKernel"] == pytest.approx(15e-9)
    assert gaps["aten::scatter_"] == pytest.approx(5e-9)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-9)
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)


def test_trace_without_device_work_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([trace.Event("aten::add", "op", 0, 10)])


# ---------------------------------------------------------- import rule
def _top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["repro"]
