"""The port's tracer (``repro_torch/_trace.py``) and the spans and counts a
graph job opens with it, on the CPU: WCC at 2^9 vertices on 8 shards, on
the plain, crowded and async paths, healthy and under a fault plan.

With tracing off a span is the shared no-op context and nothing is
counted; with it on, a job's states and totals are bitwise those of a job
with it off; under a CPU ``torch.profiler`` every span opens where and as
often as the engine's docstrings say; and ``host_reads`` equals a spy's
count of the tensor-to-host calls the job makes.
"""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import _trace  # noqa: E402
from repro_torch.configs.base import GraphConfig  # noqa: E402
from repro_torch.core import engine, faults, merger, programs  # noqa: E402
from repro_torch.core.graph import build_sharded_graph  # noqa: E402

CFG = GraphConfig(name="t", algorithm="cc", num_vertices=512, avg_degree=6,
                  generator="rmat", num_shards=8, enforce_fraction=0.5)
# 4 of the 8 shards killed, at host steps 2, 5, 8 and 11
KILLS = dict(fail_fraction=0.5, start_tick=2, every=3, seed=3)
# the crowded path: half the shards' links 2 ticks slow, budgets halved
CROWD = dict(slow_fraction=0.5, slow_delay=2, slow_intensity=2, seed=5)
PATHS = ("plain", "crowded", "async")
TICK_SPANS = ("asymp.tick.create", "asymp.tick.exchange",
              "asymp.tick.receive")


@pytest.fixture(scope="module")
def graph():
    return build_sharded_graph(CFG)


def _plan(path: str, kills: bool):
    if path == "crowded":
        return faults.FaultPlan(**dict(CROWD, **(KILLS if kills else
                                                 {"fail_fraction": 0.0})))
    return faults.FaultPlan(**KILLS) if kills else None


def _job(graph, path: str, kills: bool):
    """One job as a user runs it: the session to quiescence, then the
    answer to the host."""
    state, totals = engine.run_to_convergence(
        CFG, graph=graph, fault_plan=_plan(path, kills),
        schedule="async" if path == "async" else None, device="cpu")
    answer = merger.extract(state, graph, programs.get_program(CFG))
    totals.pop("log")
    return state, totals, answer


def _profiled_spans(fn):
    """``fn()`` under a CPU profiler; returns its result and the
    ``asymp.*`` spans it opened as ``(name, start_ns, end_ns)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("asymp.")]
    return out, spans


# ------------------------------------------------------------ the tracer
def test_off_a_span_is_the_shared_noop_and_nothing_counts():
    assert not _trace._on
    assert _trace.span("asymp.a") is _trace.span("asymp.b") is _trace._OFF
    with _trace.span("asymp.a") as entered:
        assert entered is None
    _trace.count("host_reads", 3)
    assert _trace._counts == {}
    with _trace.tracing() as counts:
        assert counts == {}  # counts made while off are not carried in
        assert _trace.span("asymp.a") is not _trace._OFF


def test_tracing_starts_from_zero_and_restores_what_it_found():
    with _trace.tracing() as outer:
        _trace.count("host_reads")
        with _trace.tracing() as inner:
            _trace.count("host_reads", 2)
            assert inner == {"host_reads": 2}
        _trace.count("host_reads")
        assert outer == {"host_reads": 2}
        assert _trace._on
    assert not _trace._on and _trace._counts == {}


def test_tracing_is_off_again_after_an_exception():
    with pytest.raises(RuntimeError):
        with _trace.tracing():
            raise RuntimeError("job failed")
    assert not _trace._on and _trace._counts == {}


def test_a_span_lands_in_the_profiler_nested_where_it_opened():
    def work():
        with _trace.tracing():
            with _trace.span("asymp.outer"):
                torch.ones(8).sum()
                with _trace.span("asymp.inner"):
                    torch.ones(8).mul(2)
    _, spans = _profiled_spans(work)
    (outer,), (inner,) = ([s for s in spans if s[0] == n]
                          for n in ("asymp.outer", "asymp.inner"))
    assert outer[1] <= inner[1] < inner[2] <= outer[2]


# ------------------------------------------------------ the job's spans
@pytest.mark.parametrize("kills", [False, True], ids=["healthy", "kills"])
@pytest.mark.parametrize("path", PATHS)
def test_tracing_changes_no_state_and_no_total(graph, path, kills):
    off = _job(graph, path, kills)
    with _trace.tracing() as counts:
        on = _job(graph, path, kills)
    assert counts["host_reads"] > 0
    for a, b in zip(off[0], on[0]):
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert off[1] == on[1]
    assert off[2].tobytes() == on[2].tobytes()
    if kills:
        assert on[1]["failures"] == 4


@pytest.mark.parametrize("kills", [False, True], ids=["healthy", "kills"])
@pytest.mark.parametrize("path", PATHS)
def test_every_span_opens_where_and_as_often_as_it_should(graph, path,
                                                          kills):
    def work():
        with _trace.tracing():
            return _job(graph, path, kills)
    (_, totals, _), spans = _profiled_spans(work)
    n = collections.Counter(name for name, _, _ in spans)
    ticks = totals["ticks"]
    assert n["asymp.session.init"] == 1
    assert n["asymp.session.step"] == ticks
    for name in TICK_SPANS:
        assert n[name] == ticks
    # the crowded path's slowdown rides a plan, so its manager records
    planned = _plan(path, kills) is not None
    assert n["asymp.faults.record"] == (ticks if planned else 0)
    assert n["asymp.faults.recover"] == totals["failures"]
    assert totals["failures"] == (4 if kills else 0)
    steps = sorted((s, e) for name, s, e in spans
                   if name == "asymp.session.step")
    for name, s, e in spans:
        if name in TICK_SPANS or name.startswith("asymp.faults."):
            assert any(a <= s and e <= b for a, b in steps), name
    reads = [(s, e) for name, s, e in spans if name == "asymp.session.read"]
    per_tick = 4 if path == "plain" else 1
    assert len(reads) >= per_tick * ticks


# ------------------------------------------------------ the host reads
def _spy(monkeypatch) -> list:
    """Count every tensor-to-host call: ``int(t)``, ``item``, ``tolist``,
    ``cpu``."""
    calls = [0]
    for name in ("__int__", "item", "tolist", "cpu"):
        real = getattr(torch.Tensor, name)

        def wrapped(self, *a, _real=real, **kw):
            calls[0] += 1
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return calls


@pytest.mark.parametrize("kills", [False, True], ids=["healthy", "kills"])
@pytest.mark.parametrize("path", PATHS)
def test_host_reads_equals_the_spys_count(graph, monkeypatch, path, kills):
    calls = _spy(monkeypatch)
    with _trace.tracing() as counts:
        _, totals, _ = _job(graph, path, kills)
    assert counts["host_reads"] == calls[0]
    if path == "plain" and not kills:
        # four a tick, one at init, one in extract
        assert counts["host_reads"] == 4 * totals["ticks"] + 2


def test_the_plain_path_reads_four_scalars_a_tick(graph, monkeypatch):
    session = engine.EngineSession(CFG, graph=graph, device="cpu")
    calls = _spy(monkeypatch)
    with _trace.tracing() as counts:
        for _ in range(5):
            session.step()
    assert counts == {"host_reads": 20} and calls[0] == 20


def test_a_kill_adds_at_most_two_reads(graph):
    with _trace.tracing() as healthy:
        _, th, _ = _job(graph, "plain", False)
    with _trace.tracing() as killed:
        _, tk, _ = _job(graph, "plain", True)
    extra = killed["host_reads"] - 4 * tk["ticks"] - 2
    assert 0 < extra <= 2 * tk["failures"]
    assert healthy["host_reads"] == 4 * th["ticks"] + 2


def test_a_collected_log_reads_its_counters_again(graph):
    cfg = dataclasses.replace(CFG, max_ticks=6)
    with _trace.tracing() as counts:
        _, totals = engine.run_to_convergence(cfg, graph=graph,
                                              collect_log=True, device="cpu")
    assert counts["host_reads"] == 7 * totals["ticks"] + 1
