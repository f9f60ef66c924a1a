"""CPU tests of ``spans.reduce`` on hand-made kineto events: device time
goes to the innermost ``asymp.*`` span open at the launch, idle counts
children in, ``n`` and ``wall_s`` count every opening, and spans in the
events move none of ``trace.summarize``'s figures but the names of the
idle gaps that ``python`` held."""
import pytest

from portbench import spans, trace

E = trace.Event
NS = 1e-9
# one step of the main thread (1), in ns:
#   step [0, 200] > create [10, 80] > add [20, 60] > launch (corr 7)
#                 > receive [90, 150] > scatter_reduce_ > launch (corr 8)
#                 > read [160, 195] > item > copy (corr 9), sync (corr 10)
#   then mul [205, 220] > launch (corr 11), outside every span
# device busy [45, 85] k1, [125, 165] k2, [178, 180] copy, [225, 240] k3;
# idle [0, 45), [85, 125), [165, 178), [180, 225)
OPS = [
    E("aten::empty", "op", 0, 5, 1),
    E("aten::add", "op", 20, 60, 1),
    E("cudaLaunchKernel", "runtime", 30, 40, 1, corr=7),
    E("aten::scatter_reduce_", "op", 100, 140, 1),
    E("cudaLaunchKernel", "runtime", 110, 120, 1, corr=8),
    E("aten::item", "op", 165, 190, 1),
    E("cudaMemcpyAsync", "runtime", 170, 175, 1, corr=9),
    E("cudaStreamSynchronize", "runtime", 176, 189, 1, corr=10),
    E("aten::mul", "op", 205, 220, 1),
    E("cudaLaunchKernel", "runtime", 210, 215, 1, corr=11),
    E("void k1<int>(int)", "device", 45, 85, 0, corr=7),
    E("void k2<float>(x)", "device", 125, 165, 0, corr=8),
    E("Memcpy DtoH (Device -> Pinned)", "device", 178, 180, 0, corr=9),
    E("void k3<int>(int)", "device", 225, 240, 0, corr=11),
]
SPANS = [
    E("asymp.session.step", "op", 0, 200, 1),
    E("asymp.tick.create", "op", 10, 80, 1),
    E("asymp.tick.receive", "op", 90, 150, 1),
    E("asymp.session.read", "op", 160, 195, 1),
    # a span on a thread that launches nothing is not the main thread's
    E("asymp.session.step", "op", 0, 50, 2),
]


def test_a_kernel_goes_to_the_innermost_span_open_at_its_launch():
    r = spans.reduce(OPS + SPANS)
    assert r["asymp.tick.create"]["device_s"] == pytest.approx(40 * NS)
    assert r["asymp.tick.receive"]["device_s"] == pytest.approx(40 * NS)
    assert r["asymp.session.read"]["device_s"] == pytest.approx(2 * NS)
    # the step launched nothing itself, and k3 ran outside every span
    assert r["asymp.session.step"]["device_s"] == 0
    assert sum(v["device_s"] for v in r.values()) == pytest.approx(82 * NS)


def test_idle_counts_the_childrens_idle_in():
    r = spans.reduce(OPS + SPANS)
    assert r["asymp.tick.create"]["idle_s"] == pytest.approx(35 * NS)
    assert r["asymp.tick.receive"]["idle_s"] == pytest.approx(35 * NS)
    assert r["asymp.session.read"]["idle_s"] == pytest.approx(28 * NS)
    # [0, 45) 45 + [85, 125) 40 + [165, 178) 13 + [180, 200) 20
    assert r["asymp.session.step"]["idle_s"] == pytest.approx(118 * NS)


def test_n_and_wall_count_every_opening_on_the_main_thread():
    second = [E("asymp.tick.create", "op", 300, 330, 1),
              E("cudaLaunchKernel", "runtime", 310, 312, 1, corr=12),
              E("void k4<int>(int)", "device", 320, 350, 0, corr=12)]
    r = spans.reduce(OPS + SPANS + second)
    assert list(r) == sorted(r)
    assert r["asymp.tick.create"]["n"] == 2
    assert r["asymp.tick.create"]["wall_s"] == pytest.approx(100 * NS)
    assert r["asymp.tick.create"]["device_s"] == pytest.approx(70 * NS)
    # idle [10, 45) and [300, 320)
    assert r["asymp.tick.create"]["idle_s"] == pytest.approx(55 * NS)
    assert r["asymp.session.step"]["n"] == 1
    assert r["asymp.session.step"]["wall_s"] == pytest.approx(200 * NS)


def test_a_trace_without_spans_or_device_work_reduces_to_nothing():
    assert spans.reduce(OPS) == {}
    assert spans.reduce([e for e in OPS + SPANS if e.kind != "device"]) == {}


def test_spans_move_no_summary_figure_but_the_idle_gaps_names(monkeypatch):
    monkeypatch.setattr(trace, "TOP", 100)  # every gap's name, not ten
    bare, spanned = trace.summarize(OPS), trace.summarize(OPS + SPANS)
    assert spanned.window_s == bare.window_s
    assert spanned.busy_s == bare.busy_s
    assert spanned.device_ops == bare.device_ops
    assert (sum(s for _, s in spanned.idle_gaps)
            == pytest.approx(sum(s for _, s in bare.idle_gaps)))
    bare_gaps, gaps = dict(bare.idle_gaps), dict(spanned.idle_gaps)
    assert gaps[trace.PYTHON] < bare_gaps[trace.PYTHON]
    assert {"asymp.session.step", "asymp.tick.create",
            "asymp.tick.receive"} <= set(gaps)
    # python keeps only the idle outside the step and every op:
    # [200, 205) and [220, 225)
    assert gaps[trace.PYTHON] == pytest.approx(10 * NS)
