"""Port parity: multi-rank execution (one shard per rank).

The JAX package's dist ticks and transports run under ``shard_map`` on a
mesh of 4 CPU devices in a subprocess (``_dist_jax_ref.py``), while the
port's run on 4 gloo ranks on the CPU (``_dist_ranks.py``, one
``RankPool`` of spawned processes), from the JAX package's start states
(``state_from_numpy``).  Every tick, the global counters are equal and
each rank's rows of every state field (values, active, cursor, tick, aux,
the ring, demotion and clock planes) are bitwise equal, to quiescence:
CC raw and int16, SSSP int16 (float rows with their scales), pagerank
(push, aux planes), crowded CC and SSSP (a slow sender row, throttle,
demotion), async CC and pagerank (rates [2, 1, 1, 1], cycle-scaled
params); the transports alone against the JAX package's and against the
port's local transports (row order).  Also: ``init_delay_ring``'s dist
layout, ``lower_tick_for_mesh`` against the JAX package's at one worker
and on fake tensors at 256 and 512 ranks, and a failing rank ending the
pool.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dist.py
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

import _dist_cases as C  # noqa: E402
import _dist_ranks as ranks  # noqa: E402
from repro.configs import get_graph_config as j_config  # noqa: E402
from repro.configs.base import GraphConfig as JCfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import programs as JP  # noqa: E402
from repro.dist import exchange as JX  # noqa: E402
from repro_torch.configs import get_graph_config as t_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.dist import exchange as TX  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT_S = 150


def _jax_start(spec) -> dict:
    """The JAX package's start state of a case, as numpy arrays."""
    cfg = JCfg(**spec["cfg"])
    s = JE.init_state(C.program(JP, cfg), JG.build_sharded_graph(cfg))
    return {k: None if v is None else np.asarray(v)
            for k, v in s._asdict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides at once: the JAX subprocess and the rank pool."""
    d = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "_dist_jax_ref.py"), str(d / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        starts = {name: _jax_start(spec) for name, spec in C.CASES.items()}
        # a FileStore rendezvous: no port, so concurrent runs never collide
        with TM.RankPool(C.WORKERS, backend="gloo", device="cpu",
                         init_method=f"file://{d / 'store'}",
                         timeout_s=TIMEOUT_S) as pool:
            cases = {name: pool.run(ranks.run_case, name, starts[name])
                     for name in C.CASES}
            transports = pool.run(ranks.run_transports)
        _, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    with np.load(d / "jax.npz") as f:
        jax_out = dict(f)
    return jax_out, cases, transports


@pytest.mark.parametrize("name", list(C.CASES))
def test_dist_tick_matches_jax_every_tick(runs, name):
    jax_out, cases, _ = runs
    want_stats = jax_out[f"{name}/stats"]
    want = jax_out[f"{name}/digests"]  # [ticks, rank, field]
    assert len(want_stats) < C.MAX_TICKS  # the JAX run reached quiescence
    for rank, got in enumerate(cases[name]):
        assert len(got["stats"]) == len(want_stats), (name, rank)
        for t, (row, dig) in enumerate(zip(got["stats"], got["digests"])):
            assert row == want_stats[t].tolist(), (name, rank, t)
            assert dig == want[t, rank].tolist(), (name, rank, t)
        # gathered back, the global state equals the JAX package's
        assert got["final"] == jax_out[f"{name}/final"].tolist(), name


@pytest.mark.parametrize("codec", list(C.CODECS))
def test_transports_match_jax_and_local(runs, codec):
    """Each rank's receives equal its rows of the JAX package's dist
    transports (and, checked inside the ranks, the port's local ones)."""
    jax_out, _, transports = runs
    for rank, got in enumerate(transports):
        assert not [m for m in got["mismatches"]
                    if m.startswith(codec + ":")], got["mismatches"]
        for key, val in got.items():
            if not key.startswith(codec + "/"):
                continue
            want = jax_out[f"transport/{key}"]
            want = want[rank] if "/once" in key else want[:, rank]
            if key.endswith("_pending"):  # a count: int64 in the port
                assert val.tolist() == want.tolist(), (key, rank)
                continue
            assert val.dtype == want.dtype and val.shape == want.shape, key
            assert val.tobytes() == want.tobytes(), (key, rank)


@pytest.mark.parametrize("num_senders", [0, 4])
def test_init_delay_ring_matches_jax(num_senders):
    """The dist layout drops the sender axis (``[L1, Pn, cap]``)."""
    for ident, jdt, tdt in ((2 ** 31 - 1, np.int32, torch.int32),
                            (float("inf"), np.float32, torch.float32)):
        j = JX.init_delay_ring(2, num_senders, 4, 8, ident, jdt)
        t = TX.init_delay_ring(2, num_senders, 4, 8, ident, tdt, "cpu")
        for a, b in zip(j, t):
            a = np.asarray(a)
            assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
            assert a.tobytes() == b.numpy().tobytes()


def test_rank_rows_cut_as_the_workers_spec():
    """``rank_rows`` cuts a global async state as ``P("workers")`` does:
    per-shard fields to ``[1, ...]``, the ring to ``[ring_len, Pn, cap]``,
    the tick kept; the rows join back into the global state."""
    from repro_torch.core import graph as TG
    cfg = t_config("asymp_cc").reduced()
    g = TG.build_sharded_graph(cfg)
    prog = TE.prog_mod.get_program(cfg)
    ep = TE.default_params(cfg, g, prog)
    a = TE.init_async_dist_state(prog, ep, g, 2, "cpu")
    a = a._replace(clock=torch.arange(cfg.num_shards, dtype=torch.int32))
    parts = [TM.rank_rows(a, r) for r in range(cfg.num_shards)]
    assert parts[1].ring.vals.shape == (3, cfg.num_shards, ep.route_capacity)
    assert parts[1].ring.due.shape == (3, cfg.num_shards)
    assert parts[1].core.values.shape == (1, g.vs)
    assert parts[1].clock.tolist() == [1]
    assert parts[1].core.tick is a.core.tick
    for field in ("values", "active", "cursor"):
        assert torch.equal(torch.cat([getattr(p.core, field) for p in parts]),
                           getattr(a.core, field))
    for k in range(3):
        assert torch.equal(torch.stack([p.ring[k] for p in parts]),
                           a.ring[k])


def _mesh2d():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("a", "b"))


@pytest.mark.parametrize("name,extra", [
    ("asymp_cc_wire", {}),
    ("asymp_cc_crowded", {}),
    ("asymp_cc_crowded", {"schedule": "async"}),
])
def test_lower_tick_for_mesh_matches_jax(name, extra):
    """At one worker, the port's dry run reports the JAX package's info
    (the same derivation, the async cycle scaling) plus the rank's
    argument bytes, and its fake-tensor tick keeps every shape."""
    jcfg = dataclasses.replace(j_config(name), **extra)
    tcfg = dataclasses.replace(t_config(name), **extra)
    _, want = JE.lower_tick_for_mesh(jcfg, _mesh2d(), 1)
    got = TE.lower_tick_for_mesh(tcfg, 1)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"argument_bytes"}
    assert got["argument_bytes"] > 0


@pytest.mark.parametrize("workers", [256, 512])
@pytest.mark.parametrize("name", ["asymp_cc_prod", "asymp_sssp_wire_prod",
                                  "asymp_cc_crowded_prod"])
def test_lower_tick_for_mesh_at_scale(workers, name):
    """The production configs at 256 and 512 ranks: traced on fake
    tensors (nothing allocated), shapes unchanged, and the per-rank bytes
    of the state, graph and ring as the shapes say."""
    cfg = t_config(name)
    info = TE.lower_tick_for_mesh(cfg, workers)
    assert info["workers"] == workers and info["vs"] * workers >= \
        cfg.num_vertices
    assert info["argument_bytes"] >= 4 * info["es"] + 4 * (info["vs"] + 1)
    # the tick left the bucket tables usable by real tensors
    ep = TE.EngineParams(num_shards=1, vs=8, max_vertices_per_tick=4,
                         degree_window=4, route_capacity=8,
                         enforce_fraction=1.0, priority="log",
                         priority_scale=8.0)
    assert TE.priority_buckets(torch.ones(8), ep.priority,
                               ep.priority_scale).shape == (8,)


def test_make_worker_group_has_no_fallback():
    with pytest.raises(ValueError, match="backend"):
        TM.make_worker_group(0, 1, backend="mpi", init_method="file:///x")
    with pytest.raises(ValueError, match="nccl"):
        TM.make_worker_group(0, 1, backend="nccl", init_method="file:///x",
                             device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.make_worker_group(0, 1, backend="gloo",
                                 init_method="file:///x")


def test_failing_rank_ends_the_pool(tmp_path):
    with TM.RankPool(2, backend="gloo", device="cpu",
                     init_method=f"file://{tmp_path / 'store'}",
                     timeout_s=60) as pool:
        assert pool.run(ranks.raise_on, 5) == [0, 1]
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            pool.run(ranks.raise_on, 1)
        assert all(not p.is_alive() for p in pool._procs)


def test_dist_tick_needs_one_rank_per_shard():
    cfg = t_config("asymp_cc").reduced()
    from repro_torch.core import graph as TG
    g = TG.build_sharded_graph(cfg)
    prog = TE.prog_mod.get_program(cfg)
    ep = TE.default_params(cfg, g, prog)
    for make in (TE.make_dist_tick, TE.make_crowded_dist_tick,
                 TE.make_async_dist_tick):
        with pytest.raises(ValueError, match="one rank per shard"):
            make(prog, ep, TX.ShapeOnlyGroup(0, cfg.num_shards + 1), False)
