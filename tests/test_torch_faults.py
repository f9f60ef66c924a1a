"""Port parity: fault injection and recovery (``core/faults.py``).

The same seeded graphs and fault plans go through the JAX package (on the
CPU) and the port (``device="cpu"``): the kill schedules, CC under rolling
kills (replay recovery), the log-horizon fallback, the vectorized replay
against the JAX package's message-by-message loop, and pagerank's global
checkpoint restore.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers at once
torch.set_num_threads(1)

from repro.configs.base import GraphConfig as JCfg  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import programs as JP  # noqa: E402
from repro_torch.configs.base import GraphConfig as TCfg  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import merger as TM  # noqa: E402
from repro_torch.core import programs as TP  # noqa: E402

CC = dict(name="t", algorithm="cc", num_vertices=1024, avg_degree=8,
          generator="rmat", num_shards=4, priority="log",
          enforce_fraction=0.5)
# tests/test_faults.py's graph
CC_SMALL = dict(name="t", algorithm="cc", num_vertices=512, avg_degree=6,
                generator="rmat", num_shards=4, enforce_fraction=0.5)
PR = dict(name="t-pr", algorithm="pagerank", num_vertices=512, avg_degree=5,
          generator="rmat", num_shards=8, enforce_fraction=0.5,
          checkpoint_every=4)
TOTALS = ("ticks", "sent", "accepted", "fetched", "failures", "replayed",
          "pending", "converged", "log")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _bitwise(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _pair(kw):
    jc, tc = JCfg(**kw), TCfg(**kw)
    jg = JG.build_sharded_graph(jc)
    tg = TG.ShardedGraph.from_arrays(
        jg.row_ptr, jg.col_idx, jg.weights, jg.edge_counts, jg.boundary,
        num_real_vertices=jg.num_real_vertices)
    return jc, tc, jg, tg


def _run_both(kw, plan_kw):
    jc, tc, jg, tg = _pair(kw)
    jstate, jtot = JE.run_to_convergence(jc, graph=jg, collect_log=True,
                                         fault_plan=JF.FaultPlan(**plan_kw))
    tstate, ttot = TE.run_to_convergence(tc, graph=tg, collect_log=True,
                                         fault_plan=TF.FaultPlan(**plan_kw),
                                         device="cpu")
    for k in TOTALS:
        assert jtot[k] == ttot[k], k
    for f in ("values", "active", "cursor", "tick"):
        _bitwise(getattr(jstate, f), getattr(tstate, f), f)
    return tstate, ttot, tg


# ======================================================================
# the plan
# ======================================================================
@pytest.mark.parametrize("fraction", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("num_shards", [4, 8])
def test_schedule_matches_jax(fraction, num_shards):
    for kw in (dict(), dict(batch=2, seed=3, start_tick=1, every=2)):
        jp = JF.FaultPlan(fraction, slow_fraction=0.5, **kw)
        tp = TF.FaultPlan(fraction, slow_fraction=0.5, **kw)
        assert jp.schedule(num_shards) == tp.schedule(num_shards)
        assert jp.slow_shards(num_shards) == tp.slow_shards(num_shards)
    assert dataclasses.asdict(JF.FaultPlan(fraction)) == \
        dataclasses.asdict(TF.FaultPlan(fraction))


def test_slowdown_helpers_match_jax():
    plans = [None, dict(fail_fraction=0.5),
             dict(fail_fraction=0.5, slow_fraction=0.5, slow_delay=2),
             dict(fail_fraction=0.0, slow_fraction=0.25, slow_intensity=4),
             dict(fail_fraction=0.0, slow_fraction=0.5, slow_delay=-1)]
    for kw in plans:
        jp = JF.FaultPlan(**kw) if kw else None
        tp = TF.FaultPlan(**kw) if kw else None
        assert JF.max_injected_delay(jp) == TF.max_injected_delay(tp)
        assert JF.injects_slowdown(jp) == TF.injects_slowdown(tp)


def test_slowdown_plan_refused():
    """Slowdowns are no longer refused: a plan with ``slow_fraction > 0``
    runs on the crowded tick, kills and slowdowns composed, and ends with
    the JAX package's state and totals (a throttle-only plan too)."""
    for plan in (dict(fail_fraction=0.5, slow_fraction=0.5, slow_delay=2),
                 dict(fail_fraction=0.0, slow_fraction=0.1,
                      slow_intensity=3)):
        state, totals, g = _run_both(CC_SMALL, plan)
        assert totals["converged"] and totals["pending"] == 0
        assert totals["failures"] == round(plan["fail_fraction"] * 4)
        labels = TM.extract(state, g, TP.get_program("cc"))
        assert np.array_equal(labels, TG.cc_oracle(g.num_real_vertices,
                                                   TG.edge_list(g)))


def test_recovery_routed_by_program():
    _, tc, _, tg = _pair(CC_SMALL)
    for name, recovery in (("cc", "replay"), ("labelprop", "replay"),
                           ("pagerank", "checkpoint")):
        prog = TP.get_program(name)
        ep = TE.default_params(tc, tg, prog)
        assert TF.FaultManager(tc, tg, prog, ep,
                               device="cpu").recovery == recovery


# ======================================================================
# replay recovery (CC, self-stabilizing)
# ======================================================================
@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_cc_rolling_kills_match_jax(fraction):
    """50% and 100% rolling kills: the port's final state and its totals
    (ticks, messages, failures, replayed messages, the per-tick log) are
    the JAX package's."""
    state, totals, g = _run_both(CC, dict(fail_fraction=fraction))
    assert totals["failures"] == round(fraction * 4)
    assert totals["replayed"] > 0 and totals["converged"]
    labels = TM.extract(state, g, TP.get_program("cc"))
    assert np.array_equal(labels, TG.cc_oracle(g.num_real_vertices,
                                               TG.edge_list(g)))


def test_log_horizon_fallback_matches_jax():
    """``tests/test_faults.py``'s horizon case: a snapshot only at t=0 and
    a 2-tick log, so the kill at t=6 takes the boundary re-activation
    (0 replays), in both packages alike."""
    _, totals, _ = _run_both(dict(CC_SMALL, checkpoint_every=50,
                                  replay_log_ticks=2),
                             dict(fail_fraction=0.25, start_tick=6, seed=3))
    assert totals["failures"] >= 1 and totals["replayed"] == 0


def test_replay_inside_horizon_matches_jax():
    _, totals, _ = _run_both(dict(CC_SMALL, checkpoint_every=3,
                                  replay_log_ticks=16),
                             dict(fail_fraction=0.5, start_tick=5, seed=1))
    assert totals["replayed"] > 0


def _managers(kw, *, ticks):
    """Both managers after ``ticks`` recorded ticks of the JAX engine; the
    port's adopts the JAX manager's snapshots and log."""
    jc, tc, jg, tg = _pair(kw)
    jp, tp = JP.get_program(jc), TP.get_program(tc)
    jep, tep = JE.default_params(jc, jg, jp), TE.default_params(tc, tg, tp)
    jtick = JE.make_local_tick(jp, jep, jp.weighted)
    js = JE.init_state(jp, jg)
    jgd = JE.to_device_graph(jg)
    jm = JF.FaultManager(jc, jg, jp, jep)
    for t in range(ticks):
        js, _, bufs = jtick(js, jgd)
        jm.record(t, js, bufs)
    tm = TF.FaultManager(tc, tg, tp, tep, device="cpu")
    tm.load_numpy(jm.ckpt, jm.ckpt_tick, jm.msg_log)
    ts = TE.state_from_numpy(
        *(np.asarray(x) for x in js[:4]),
        aux=None if js.aux is None else np.asarray(js.aux), device="cpu")
    return jm, tm, js, ts


def test_record_keeps_the_jax_horizon():
    """The port records the same snapshot ticks and log window."""
    jc, tc, jg, tg = _pair(dict(CC_SMALL, checkpoint_every=3,
                                replay_log_ticks=4))
    jp, tp = JP.get_program(jc), TP.get_program(tc)
    jep, tep = JE.default_params(jc, jg, jp), TE.default_params(tc, tg, tp)
    jtick = JE.make_local_tick(jp, jep, False)
    ttick = TE.make_local_tick(tp, tep, False)
    js, ts = JE.init_state(jp, jg), TE.init_state(tp, tg, device="cpu")
    jgd, tgd = JE.to_device_graph(jg), TE.to_device_graph(tg, device="cpu")
    jm = JF.FaultManager(jc, jg, jp, jep, replay_slack=1)
    tm = TF.FaultManager(tc, tg, tp, tep, replay_slack=1, device="cpu")
    for t in range(11):
        js, _, jb = jtick(js, jgd)
        ts, _, tb = ttick(ts, tgd)
        jm.record(t, js, jb)
        tm.record(t, ts, tb)
        assert sorted(jm.msg_log) == sorted(tm.msg_log)
        assert np.array_equal(jm.ckpt_tick, tm.ckpt_tick)
    for t in jm.msg_log:
        for a, b in zip(jm.msg_log[t], tm.msg_log[t]):
            _bitwise(a, b, f"log {t}")
    for p in jm.ckpt:
        for a, b in zip(jm.ckpt[p][:3], tm.ckpt[p][:3]):
            _bitwise(a, b, f"snapshot {p}")


@pytest.mark.parametrize("program", ["cc", "labelprop", "reachability"])
def test_vectorized_replay_equals_jax_loop(program):
    """One hand-built log, for min (cc), max (labelprop) and or
    (reachability): duplicated messages, messages that improve, tie or
    worsen, and empty slots.  The port's single aggregator scatter gives
    the JAX loop's values, frontier, cursors and replay count."""
    # snapshots at steps 0 and 4: a kill at 6 replays steps 5 and 6
    kw = dict(CC_SMALL, algorithm=program, checkpoint_every=4,
              replay_log_ticks=8)
    jm, tm, js, ts = _managers(kw, ticks=7)
    P, vs, cap = 4, jm.graph.vs, jm.ep.route_capacity
    rng = np.random.default_rng(5)
    dtype = np.asarray(js.values).dtype
    for t in range(5, 7):  # overwrite the logged buffers of the lost ticks
        ids = rng.integers(-1, vs, (P, P, cap)).astype(np.int32)
        ids[:, :, 1::2] = ids[:, :, ::2][:, :, : ids[:, :, 1::2].shape[2]]
        hi = 2 if program == "reachability" else 600
        vals = rng.integers(0, hi, (P, P, cap)).astype(dtype)
        jm.msg_log[t] = (vals, ids)
    tm.load_numpy(jm.ckpt, jm.ckpt_tick, jm.msg_log)
    for p in range(P):
        jr, jn = jm.fail_shard(6, js, p)
        tr, tn = tm.fail_shard(6, ts, p)
        assert jn == tn > 0, p
        for f in ("values", "active", "cursor"):
            _bitwise(getattr(jr, f), getattr(tr, f), f"shard {p}: {f}")


def test_boundary_fallback_equals_jax():
    """Beyond the log horizon both packages re-activate the same boundary
    (``tests/test_faults.py::test_fallback_reactivates_boundary``)."""
    jm, tm, js, ts = _managers(dict(CC_SMALL, checkpoint_every=50,
                                    replay_log_ticks=1), ticks=8)
    for p in range(4):
        jr, jn = jm.fail_shard(7, js, p)
        tr, tn = tm.fail_shard(7, ts, p)
        assert jn == tn == 0
        for f in ("values", "active", "cursor"):
            _bitwise(getattr(jr, f), getattr(tr, f), f"shard {p}: {f}")
        active = _np(tr.active)
        for q in range(4):
            if q != p:
                assert (active[q] | ~jm.graph.boundary[q, p]).all()


def test_fail_before_any_checkpoint_reinitializes_shard():
    jm, tm, js, ts = _managers(dict(CC_SMALL, checkpoint_every=1000,
                                    replay_log_ticks=8), ticks=3)
    jm.ckpt.clear()
    jm.ckpt_tick[:] = -1
    tm.load_numpy(jm.ckpt, jm.ckpt_tick, jm.msg_log)
    jr, jn = jm.fail_shard(2, js, 1)
    tr, tn = tm.fail_shard(2, ts, 1)
    assert jn == tn > 0
    for f in ("values", "active", "cursor"):
        _bitwise(getattr(jr, f), getattr(tr, f), f)


# ======================================================================
# global checkpoint restore (pagerank, not self-stabilizing)
# ======================================================================
def test_pagerank_kill50_checkpoint_restore_bitwise():
    """50% rolling kills: recovery is the deterministic global rollback and
    re-execution, with no replay; the fixpoint is bitwise the port's own
    fault-free one, and the run is the JAX package's."""
    state, totals, g = _run_both(PR, dict(fail_fraction=0.5, start_tick=4,
                                          every=6))
    assert totals["failures"] == 4 and totals["replayed"] == 0
    _, tc, _, tg = _pair(PR)
    base, base_totals = TE.run_to_convergence(tc, graph=tg, device="cpu")
    assert totals["ticks"] > base_totals["ticks"]
    for f in ("values", "aux"):
        _bitwise(getattr(base, f), getattr(state, f), f)
    assert abs(TM.mass_balance(state, g) - 1.0) < 1e-5


def test_restore_before_any_checkpoint_reinitializes_aux():
    """``tests/test_pagerank.py:192-209``: a restore with no snapshot yet
    re-initializes the run, the push planes included."""
    _, tc, _, tg = _pair(dict(PR, checkpoint_every=1000, num_shards=4))
    prog = TP.get_program(tc)
    ep = TE.default_params(tc, tg, prog)
    mgr = TF.FaultManager(tc, tg, prog, ep, device="cpu")
    tick = TE.make_local_tick(prog, ep, prog.weighted)
    state0 = TE.init_state(prog, tg, device="cpu")
    state = state0
    dg = TE.to_device_graph(tg, device="cpu")
    for _ in range(3):
        state, _, _ = tick(state, dg)
    assert not torch.equal(state.aux, state0.aux)
    restored, replayed = mgr.fail_shard(2, state, 1)
    assert replayed == 0 and int(restored.tick) == 3
    for f in ("values", "active", "cursor", "aux"):
        assert torch.equal(getattr(restored, f), getattr(state0, f)), f


def test_global_restore_rolls_back_aux_to_snapshot():
    """With a snapshot, every shard — aux planes included — rolls back to
    it, equal to the JAX package's restore from the same snapshot."""
    jm, tm, js, ts = _managers(dict(PR, num_shards=4), ticks=6)
    assert jm.recovery == tm.recovery == "checkpoint"
    jm_aux = {p: jm.ckpt[p] for p in jm.ckpt}
    tm.load_numpy(jm_aux, jm.ckpt_tick, {})
    jr, _ = jm.fail_shard(5, js, 2)
    tr, _ = tm.fail_shard(5, ts, 2)
    for f in ("values", "active", "cursor", "aux"):
        _bitwise(getattr(jr, f), getattr(tr, f), f)
