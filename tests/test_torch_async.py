"""Port parity: the barrier-free async schedule.

The same seeded graphs, latency models and fault plans go through the JAX
package (on the CPU) and the port (``device="cpu"``): the seeded firing
pattern (with and without jitter) and its stall bound, the ring sizing,
and whole async sessions stepped in lockstep — core state, delay ring,
demotion plane and clock vector bitwise equal after every step, for the
six idempotent programs and pagerank under the uniform, stragglers and
heavy_tail profiles, and composed with kills recovered by replay or by
checkpoint restore.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

from repro.configs import get_graph_config as j_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import programs as JP  # noqa: E402
from repro.dist import latency as JL  # noqa: E402
from repro_torch.configs import get_graph_config as t_config  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import merger as TM  # noqa: E402
from repro_torch.core import programs as TP  # noqa: E402
from repro_torch.dist import latency as TL  # noqa: E402
# the lockstep harness of the crowded tests (tests/ is on the path)
from test_torch_crowded import (IDEMPOTENT, PROFILES, _bitwise,  # noqa: E402
                                _graphs, _lockstep, _sessions)
import test_torch_crowded as crowded  # noqa: E402

BASE = dict(crowded.BASE, schedule="async")
PAGERANK = dict(crowded.PAGERANK, schedule="async")


# ======================================================================
# the firing pattern
# ======================================================================
@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("rates", [None, [1, 2, 3, 4] * 2, [4] * 8,
                                   [1, 1, 7, 1, 2, 1, 1, 5]])
def test_fire_mask_matches_jax(rates, jitter):
    """``fire_mask`` over 200 steps (negative steps too, for the jitter's
    previous coin), with the base rates and with overriding rates, for
    several seeds; the phases and the stall bound alike."""
    for seed in (0, 3, 11, 2 ** 40 + 7):
        j = JL.make_interleaving(8, rates=rates, seed=seed, jitter=jitter)
        t = TL.make_interleaving(8, rates=rates, seed=seed, jitter=jitter)
        _bitwise(j.rates, t.rates, "rates")
        _bitwise(j.phases, t.phases, "phases")
        for extra in (1, 2, 5):
            assert j.stall_bound(extra) == t.stall_bound(extra)
        override = np.array([1, 3, 1, 1, 2, 1, 4, 1], np.int32)
        for step in range(-2, 200):
            _bitwise(j.fire_mask(step), t.fire_mask(step), f"step {step}")
            _bitwise(j.fire_mask(step, rates=override),
                     t.fire_mask(step, rates=override), f"override {step}")
        assert j.describe() == t.describe()


def test_jitter_never_skips_twice():
    inter = TL.make_interleaving(16, seed=5, jitter=True)
    fires = np.stack([inter.fire_mask(t) for t in range(200)])
    assert (fires[:-1] | fires[1:]).all() and fires.sum() < fires.size
    assert inter.stall_bound() >= 2


@pytest.mark.parametrize("max_delay,max_stall", [(3, 1), (3, 4), (0, 2),
                                                 (5, 0), (0, 1)])
def test_async_ring_delay_matches_jax(max_delay, max_stall):
    assert TE.async_ring_delay(max_delay, max_stall) == \
        JE.async_ring_delay(max_delay, max_stall)


# ======================================================================
# whole async sessions, per step
# ======================================================================
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("algorithm", IDEMPOTENT)
def test_async_state_bitwise_every_step(algorithm, profile):
    kw = dict(BASE, algorithm=algorithm,
              weighted=algorithm in ("sssp", "widest_path"))
    _lockstep(*_sessions(kw, profile=profile))


@pytest.mark.parametrize("profile", PROFILES)
def test_async_pagerank_bitwise_every_step(profile):
    tt = _lockstep(*_sessions(PAGERANK, profile=profile))
    assert tt["pending"] == 0


def test_async_config_with_jitter_matches_jax():
    """``asymp_cc_crowded`` reduced, async with jitter and a seed: the
    cycle-scaled window and capacity and the clock vector."""
    kw = dict(async_seed=3, async_jitter=True, schedule="async")
    jc = dataclasses.replace(j_config("asymp_cc_crowded").reduced(), **kw)
    tc = dataclasses.replace(t_config("asymp_cc_crowded").reduced(), **kw)
    jg = JG.build_sharded_graph(jc)
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    js = JE.EngineSession(jc, graph=jg, collect_log=True)
    ts = TE.EngineSession(tc, graph=tg, collect_log=True, device="cpu")
    # widened by the largest rate (4)
    assert dataclasses.asdict(ts.ep_run) == dataclasses.asdict(js.ep_run)
    assert ts.ep_run.degree_window == 4 * ts.ep.degree_window
    tt = _lockstep(js, ts)
    assert sorted(set(tt["clock"])) != [tt["ticks"]]  # crowded shards lag


def test_healthy_async_is_bitwise_sync():
    """Every rate 1 and no jitter: the async run is the barrier run."""
    kw = dict(BASE, algorithm="cc")
    _, tc, _, tg = _graphs(kw)
    a_state, a_tot = TE.run_to_convergence(tc, graph=tg, device="cpu")
    s_state, s_tot = TE.run_to_convergence(
        dataclasses.replace(tc, schedule="sync"), graph=tg, device="cpu")
    assert a_tot["ticks"] == s_tot["ticks"] and a_tot["sent"] == s_tot["sent"]
    assert a_tot["clock"] == [a_tot["ticks"]] * tc.num_shards
    for f in ("values", "active", "cursor", "tick"):
        _bitwise(getattr(a_state, f), getattr(s_state, f), f)


# ======================================================================
# fault compositions
# ======================================================================
def test_kill_replay_composition():
    """Async + kills recovered by replay: the replay slack is the largest
    link delay plus the stall bound, and each replayed shard rolls its
    clock entry back to its snapshot's."""
    kw = dict(BASE, algorithm="cc", num_vertices=512, avg_degree=6,
              checkpoint_every=3, replay_log_ticks=16)
    js, ts = _sessions(kw, profile="stragglers",
                       plan=dict(fail_fraction=1.0, start_tick=4, every=6))
    assert ts.fault_mgr.replay_slack == js.fault_mgr.replay_slack
    tt = _lockstep(js, ts)
    assert tt["failures"] == 4 and tt["replayed"] > 0


@pytest.mark.parametrize("slow", [False, True])
def test_checkpoint_restore_composition(slow):
    """Async + checkpoint restore on pagerank: the cut is (state, ring,
    device tick, clock vector), the firing pattern after a restore is
    keyed on the rewound device tick, and the mass is conserved; with a
    plan that also crowds shards (``slow``), the ring and the window are
    sized for the plan's rate."""
    plan = dict(fail_fraction=0.5, start_tick=4, every=6)
    if slow:
        plan.update(slow_fraction=0.5, slow_delay=3, slow_intensity=3)
    kw = dict(PAGERANK, checkpoint_every=4)
    js, ts = _sessions(kw, profile="stragglers", plan=plan, intensity=2)
    restored = []

    def watch(s):
        restored.append((s.totals["failures"], s._dev_tick))

    tt = _lockstep(js, ts, watch=watch)
    assert tt["failures"] == 2 and tt["replayed"] == 0
    # the host mirror of the device tick rewound with each restore
    ticks = [d for _, d in restored]
    assert any(b < a for a, b in zip(ticks, ticks[1:]))
    assert ts._dev_tick == int(ts.state.tick)
    assert abs(TM.mass_balance(ts.state, ts.graph) - 1.0) < 1e-4


def test_clock_argument_of_the_fault_manager():
    """``record``/``maybe_fail`` with a clock: the snapshot's clock, the
    rolled-back vector for replay (one entry) and for a global restore
    (all entries), as in the JAX package."""
    for name in ("cc", "pagerank"):
        kw = dict(BASE, algorithm=name, num_vertices=256, avg_degree=4)
        jc, tc, jg, tg = _graphs(kw)
        jp, tp = JP.get_program(jc), TP.get_program(tc)
        jep, tep = JE.default_params(jc, jg, jp), TE.default_params(tc, tg,
                                                                    tp)
        jm = JF.FaultManager(jc, jg, jp, jep)
        tm = TF.FaultManager(tc, tg, tp, tep, device="cpu")
        js, ts = JE.init_state(jp, jg), TE.init_state(tp, tg, device="cpu")
        bufs = (np.zeros((4, 4, 2), np.int32), np.full((4, 4, 2), -1,
                                                      np.int32))
        tbufs = tuple(torch.from_numpy(b) for b in bufs)
        plan = dict(fail_fraction=1.0, start_tick=9, every=1, batch=2)
        jplan, tplan = JF.FaultPlan(**plan), TF.FaultPlan(**plan)
        for t in range(11):
            clock = np.arange(4) * 10 + t
            jm.record(t, js, bufs, clock=clock)
            tm.record(t, ts, tbufs, clock=clock.tolist())
            assert tm.ckpt_clock == jm.ckpt_clock, t
            js2, jx = jm.maybe_fail(t, js, jplan, clock=clock)
            ts2, tx = tm.maybe_fail(t, ts, tplan, clock=clock.tolist())
            assert (jx["failures"], jx["replayed"]) == \
                (tx["failures"], tx["replayed"])
            assert ("clock" in jx) == ("clock" in tx)
            if "clock" in jx:
                _bitwise(jx["clock"], tx["clock"], f"clock {t}")
        assert tx["failures"] == 2
