"""Port parity at the entry points: the ``graph_mine`` launcher, the device
rule, the launch counter and the port's import boundary."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once, and
# each worker's own thread pool over all cores oversubscribes them
torch.set_num_threads(1)

from repro_torch.configs import get_graph_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import semiring_spmv as TK  # noqa: E402
from repro_torch.launch import graph_mine  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    src = str(REPO / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above
    return env


def _run(module, *args, cwd):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=_env(), capture_output=True, text=True,
                          timeout=300, check=False)


@pytest.mark.parametrize("config", ["asymp_cc", "asymp_sssp",
                                    "asymp_reach"])
def test_graph_mine_tsv_identical_to_jax(tmp_path, config):
    outs = {}
    for pkg, extra in (("repro", ()), ("repro_torch", ("--device", "cpu"))):
        tsv, met = tmp_path / f"{pkg}.tsv", tmp_path / f"{pkg}.json"
        proc = _run(f"{pkg}.launch.graph_mine", "--config", config,
                    "--reduced", "--out", str(tsv), "--metrics", str(met),
                    *extra, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[pkg] = (tsv.read_bytes(), json.loads(met.read_text()))
    assert outs["repro"][0] == outs["repro_torch"][0]
    jm, tm = outs["repro"][1], outs["repro_torch"][1]
    for k in ("ticks", "sent", "accepted", "fetched", "converged", "log"):
        assert jm[k] == tm[k], k


@pytest.mark.parametrize("config", ["asymp_cc", "asymp_pagerank"])
def test_graph_mine_failures_tsv_identical_to_jax(tmp_path, config):
    """``--failures 0.5``: replay recovery for CC, checkpoint restore for
    pagerank; the port's CPU run is bitwise the JAX package's, so the
    tables are byte-identical and the totals equal."""
    outs = {}
    for pkg, extra in (("repro", ()), ("repro_torch", ("--device", "cpu"))):
        tsv, met = tmp_path / f"{pkg}.tsv", tmp_path / f"{pkg}.json"
        proc = _run(f"{pkg}.launch.graph_mine", "--config", config,
                    "--reduced", "--failures", "0.5", "--out", str(tsv),
                    "--metrics", str(met), *extra, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-2000:]
        merger_line = [ln for ln in proc.stdout.splitlines()
                       if "merger" in ln]
        outs[pkg] = (tsv.read_bytes(), json.loads(met.read_text()),
                     merger_line)
    assert outs["repro"][0] == outs["repro_torch"][0]
    assert outs["repro"][2] == outs["repro_torch"][2]  # mass=...;top=...
    jm, tm = outs["repro"][1], outs["repro_torch"][1]
    for k in ("ticks", "sent", "accepted", "fetched", "failures", "replayed",
              "converged", "log"):
        assert jm[k] == tm[k], k
    assert tm["failures"] == 2
    assert (tm["replayed"] == 0) == (config == "asymp_pagerank")


@pytest.mark.parametrize("argv,missing", [
    (["--failures", "0.5", "--schedule", "async"], "async"),
    (["--latency-profile", "stragglers"], "crowded"),
    (["--slowdown", "0.5"], "crowded"),
    (["--link-delay", "2"], "crowded"),
    (["--intensity", "4"], "crowded"),
    (["--schedule", "async"], "async"),
    (["--async-seed", "3"], "async"),
    (["--config", "asymp_cc_crowded"], "crowded"),
    (["--config", "asymp_pagerank", "--slowdown", "0.5"], "crowded"),
])
def test_graph_mine_refuses_unported(argv, missing, capsys, tmp_path):
    """None of these options is refused any more (the test keeps the name
    it had while each was).  ``missing`` names the path the option once
    waited for: the crowded ring or the async schedule.  A run takes that
    path when its options select it (a latency profile, a slowdown or a
    crowded config; ``--schedule async``) and converges with its ring
    drained.  ``--link-delay``/``--intensity``/``--async-seed`` alone only
    set knobs of a path they do not select, as in the JAX launcher, so
    such a run's metrics equal the plain run's."""
    selects = {"crowded": ("--latency-profile", "--slowdown",
                           "asymp_cc_crowded"),
               "async": ("--schedule",)}[missing]
    takes = any(a in argv for a in selects)
    met = tmp_path / "m.json"
    graph_mine.main(["--reduced", "--device", "cpu", *argv,
                     "--metrics", str(met)])
    out = capsys.readouterr().out
    m = json.loads(met.read_text())
    assert "converged=True" in out and m["converged"] and m["pending"] == 0
    assert ("crowded-cluster emulation" in out) == \
        (takes and missing == "crowded")
    assert m["schedule"] == ("async" if takes and missing == "async"
                             else "sync")
    if not takes:
        plain = tmp_path / "plain.json"
        graph_mine.main(["--reduced", "--device", "cpu",
                         "--metrics", str(plain)])
        assert json.loads(plain.read_text()) == m


@pytest.mark.parametrize("extra", [[], ["--schedule", "async"],
                                   ["--failures", "0.5"]])
def test_graph_mine_crowded_tsv_identical_to_jax(tmp_path, extra):
    """``asymp_cc_crowded --reduced``, sync, async and under failures: the
    port's ``--out`` table is byte-identical to the JAX launcher's and the
    metrics (pending, the async clock, the per-tick log) are equal."""
    outs = {}
    for pkg, dev in (("repro", ()), ("repro_torch", ("--device", "cpu"))):
        tsv, met = tmp_path / f"{pkg}.tsv", tmp_path / f"{pkg}.json"
        proc = _run(f"{pkg}.launch.graph_mine", "--config",
                    "asymp_cc_crowded", "--reduced", *extra, "--out",
                    str(tsv), "--metrics", str(met), *dev, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[pkg] = (tsv.read_bytes(), json.loads(met.read_text()))
    assert outs["repro"][0] == outs["repro_torch"][0]
    tm = outs["repro_torch"][1]
    assert tm.pop("edges") > 0  # the port's own key: the graph's edges
    assert outs["repro"][1] == tm
    assert outs["repro_torch"][1]["pending"] == 0


def test_no_card_no_silent_fallback(monkeypatch):
    """``device=None`` means the card: without one every entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_graph_config("asymp_cc").reduced()
    g = TG.build_sharded_graph(cfg)
    for call in (lambda: TE.run_to_convergence(cfg, graph=g),
                 lambda: TE.EngineSession(cfg, graph=g),
                 lambda: TO.bsp_connected_components(g),
                 lambda: TO.pagerank(g, iters=1),
                 lambda: TE.init_state(TE.prog_mod.get_program(cfg), g)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(SystemExit):
        graph_mine.main(["--reduced"])


def test_lm_serve_without_a_card_raises(monkeypatch):
    """``repro_torch.launch.serve`` without ``--device cpu`` means the
    card, and exits without one; so do the LM entry points."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        lm_serve.main([])
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("qwen3-4b").reduced()
    for call in (lambda: T.init_lm(cfg), lambda: T.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_lm_train_without_a_card_raises(monkeypatch):
    """``repro_torch.launch.train`` without ``--device cpu`` means the
    card, and exits without one; so does the trainer's ``init_state``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        lm_train.main(["--arch", "qwen3-4b", "--reduced"])
    from repro_torch.configs import get_config
    from repro_torch.train import trainer as TR
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.init_state(get_config("qwen3-4b").reduced())


def test_lm_train_launcher_resumes_at_the_pipeline_offset(tmp_path, capsys):
    """``--arch qwen3-4b --reduced --steps 4 --device cpu`` with a
    checkpoint every 2 steps; with the last checkpoint gone, ``--resume``
    continues from step 2 at the saved pipeline offset and gives the
    uninterrupted run's last two losses bitwise."""
    argv = ["--arch", "qwen3-4b", "--reduced", "--steps", "4", "--device",
            "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    full = lm_train.main(argv)
    assert full["start"] == 0 and full["step"] == 4 and full["offset"] == 32
    assert len(full["losses"]) == 4
    assert all(np.isfinite(v) for v in full["losses"].values())
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002",
                                            "step_0000000004"]
    shutil.rmtree(tmp_path / "step_0000000004")
    capsys.readouterr()
    resumed = lm_train.main(argv + ["--resume"])
    assert "resumed from step 2 (pipeline offset 16)" in capsys.readouterr().out
    assert resumed["start"] == 2 and resumed["offset"] == 32
    assert resumed["losses"] == {i: full["losses"][i] for i in (2, 3)}


def test_cpu_calls_never_count_launches():
    before = dict(TK.spmv_partials.launches_by_form)
    g = TG.build_sharded_graph(get_graph_config("asymp_cc").reduced())
    labels, stats = TO.bsp_connected_components(g, device="cpu")
    TO.pagerank(g, iters=2, device="cpu")
    TK.spmv_partials(torch.zeros(512), torch.zeros(512, dtype=torch.int32),
                     None, semiring="min")
    assert stats["rounds"] > 0 and labels.device.type == "cpu"
    assert TK.spmv_partials.launches_by_form == before


def test_port_runs_without_jax_or_repro(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.launch import graph_mine\n"
        "graph_mine.main(['--config', 'asymp_cc', '--reduced', "
        "'--device', 'cpu'])\n"
        "graph_mine.main(['--config', 'asymp_pagerank', '--reduced', "
        "'--failures', '0.5', '--device', 'cpu'])\n"
        "graph_mine.main(['--config', 'asymp_cc_crowded', '--reduced', "
        "'--schedule', 'async', '--device', 'cpu'])\n"
        "graph_mine.main(['--config', 'asymp_cc_wire', '--reduced', "
        "'--slowdown', '0.5', '--device', 'cpu'])\n"
        "from repro_torch.launch import graph_serve\n"
        "graph_serve.main(['--config', 'asymp_cc', '--reduced', "
        "'--programs', 'cc,sssp', '--device', 'cpu'])\n"
        "import repro_torch.core.faults\n"
        "import repro_torch.dist.compression, repro_torch.dist.latency\n"
        "import repro_torch.serve.graph, repro_torch.ft.elastic\n"
        "import repro_torch.models.transformer, repro_torch.launch.serve\n"
        "repro_torch.launch.serve.main(['--device', 'cpu', '--requests', "
        "'3'])\n"
        "import repro_torch.launch.train, repro_torch.data.pipeline\n"
        "import repro_torch.train.trainer, repro_torch.train.optimizer\n"
        "repro_torch.launch.train.main(['--arch', 'qwen3-4b', '--reduced', "
        "'--steps', '2', '--device', 'cpu'])\n"
        "import repro_torch.models.moe, repro_torch.models.moe_a2a\n"
        "repro_torch.launch.train.main(['--arch', 'phi3.5-moe-42b-a6.6b', "
        "'--reduced', '--steps', '2', '--device', 'cpu'])\n"
        "repro_torch.launch.serve.main(['--arch', 'phi3.5-moe-42b-a6.6b', "
        "'--device', 'cpu', '--requests', '3'])\n"
        "import repro_torch.models.ssm\n"
        "for arch in ('mamba2-780m', 'hymba-1.5b'):\n"
        "    repro_torch.launch.train.main(['--arch', arch, '--reduced', "
        "'--steps', '2', '--device', 'cpu'])\n"
        "    repro_torch.launch.serve.main(['--arch', arch, '--device', "
        "'cpu', '--requests', '3'])\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.roofline import report\n"
        "dryrun.main(['--arch', 'whisper-medium', '--shape', 'decode_32k', "
        "'--out', 'dr'])\n"
        "dryrun.main(['--graph', 'asymp_cc_prod', '--out', 'dr'])\n"
        "report.main(['--dir', 'dr'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("CLEAN")


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and PORT / "core" / "faults.py" in files
    assert PORT / "dist" / "latency.py" in files
    assert PORT / "dist" / "compression.py" in files
    assert PORT / "serve" / "graph.py" in files
    assert PORT / "ft" / "elastic.py" in files
    assert PORT / "models" / "transformer.py" in files
    assert PORT / "launch" / "serve.py" in files
    for new in ("launch/train.py", "train/trainer.py", "train/optimizer.py",
                "data/pipeline.py", "models/moe.py", "models/moe_a2a.py",
                "dist/sharding.py", "models/ssm.py", "models/encdec.py",
                "launch/dryrun.py", "roofline/analysis.py",
                "roofline/probes.py", "roofline/report.py"):
        assert PORT / new in files
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, f


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: non-zero and no result line; alone in a directory too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    for script in (REPO / "chip_smoke.py", alone / "chip_smoke.py"):
        proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                              env=dict(os.environ), capture_output=True,
                              text=True, timeout=120, check=False)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_merger_output_table():
    from repro_torch.core import merger, programs
    cfg = get_graph_config("asymp_cc").reduced()
    g = TG.build_sharded_graph(cfg)
    state, totals = TE.run_to_convergence(cfg, graph=g, device="cpu")
    prog = programs.get_program(cfg)
    table = merger.output_table(state, g, prog)
    assert len(table) == g.num_real_vertices and totals["converged"]
    labels = merger.extract(state, g, prog)
    assert np.array_equal(labels, TG.cc_oracle(g.num_real_vertices,
                                               TG.edge_list(g)))
    assert table[5] == (5, str(labels[5]))
