"""Fault injection and recovery for the ASYMP engine (paper §3.4, §5.5).

Counterpart of ``repro.core.faults``.  The paper's mechanism, in three
steps:

  1. writing checkpoints — every ``checkpoint_every`` ticks, a snapshot of
     each shard's vertex state (values, frontier, cursors, push planes);
  2. recovering itself — a failed shard rolls back to its own latest
     snapshot; the other shards keep their newer state;
  3. requesting lost messages — peers replay their logged outgoing
     buffers for the ticks since that snapshot; beyond the log horizon
     they instead re-activate every boundary vertex with an edge into the
     failed shard (correct by self-stabilization, at the cost of extra
     messages).

Replay and the boundary fallback deliver duplicated messages, which only
an idempotent reduce absorbs.  Programs that set
``self_stabilizing=False`` (pagerank, over SUM) take a globally
consistent checkpoint restore instead: every shard rolls back to the same
snapshot, aux planes included.

Snapshots and the message log stay on the device as tensors: at RMAT
2^18 one tick's send buffers are ~121 MB, and copying them to the host
every tick would cost about as much as the tick.  What is kept, and when,
is the JAX package's: a snapshot at ``t % checkpoint_every == 0``, the
log of the last ``replay_log_ticks + replay_slack + 1`` ticks (replay
recovery only).

A plan may also crowd shards (``slow_fraction > 0``): ``apply_slowdown``
overlays its window onto the latency model's delays and throttles, which
the session feeds to the crowded or async tick.  Under deferred delivery
the replay window reaches back past the snapshot by ``replay_slack``
(the largest link delay, plus the stall bound for the async schedule),
and an async run's snapshots carry each shard's logical ``clock``.

A streaming edge delta (``serve/graph.py``) re-anchors recovery at the
seeded state (``FaultManager.rebase``): what was logged or snapshotted
before it describes the old graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import _trace
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import GraphConfig
from repro_torch.core.engine import EngineParams, EngineState, init_state


@dataclasses.dataclass
class FaultPlan:
    """fail_fraction: 0.5 / 1.0 / 2.0 = the paper's 50% / 100% / 200%
    scenarios ("rolling failures": ``batch`` shards every ``every`` ticks
    from ``start_tick``)."""
    fail_fraction: float
    start_tick: int = 4
    every: int = 6  # ticks between rolling failure batches
    batch: int = 1  # shards failed per batch
    seed: int = 0
    # slowdown injection (§5.4): crowd slow_fraction of the shards from
    # slow_start until slow_stop (0 = to the end of the run)
    slow_fraction: float = 0.0
    slow_delay: int = 0  # extra ticks on the crowded shards' outgoing links
    slow_intensity: int = 1  # work-budget divisor while crowded
    slow_start: int = 0
    slow_stop: int = 0

    def slow_shards(self, num_shards: int) -> list[int]:
        """The seeded crowded-shard choice (decorrelated from the kill
        schedule's permutation)."""
        k = int(round(self.slow_fraction * num_shards))
        rng = np.random.default_rng(self.seed + 1)
        return [int(s) for s in rng.permutation(num_shards)[:k]]

    def schedule(self, num_shards: int) -> dict[int, list[int]]:
        """host step -> the shards that fail after that step's tick."""
        total = int(round(self.fail_fraction * num_shards))
        rng = np.random.default_rng(self.seed)
        shards = [int(s) for s in rng.permutation(num_shards)]
        while len(shards) < total:  # >100%: shards fail multiple times
            shards += [int(s) for s in rng.permutation(num_shards)]
        shards = shards[:total]
        out: dict[int, list[int]] = {}
        t = self.start_tick
        for i in range(0, total, self.batch):
            out[t] = shards[i: i + self.batch]
            t += self.every
        return out


def max_injected_delay(plan: Optional[FaultPlan]) -> int:
    """The largest wire delay a plan's slowdown can inject."""
    if plan is None or plan.slow_fraction <= 0:
        return 0
    return max(int(plan.slow_delay), 0)


def injects_slowdown(plan: Optional[FaultPlan]) -> bool:
    """Does the plan crowd any shard, by wire delay or by throttle?"""
    if plan is None or plan.slow_fraction <= 0:
        return False
    return plan.slow_delay > 0 or plan.slow_intensity > 1


def apply_slowdown(plan: Optional[FaultPlan], t: int, delays: np.ndarray,
                   throttle: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Overlay a plan's slowdown window onto the base cluster condition.

    Inside [slow_start, slow_stop) the crowded shards' outgoing link delays
    and throttles are raised to the plan's values (``max`` against the
    base, never lowered); outside it the base arrays pass through.  The
    overlay is made once and cached on the plan, keyed on every field it
    reads (a plan mutated between runs gets a fresh overlay) and on the
    base arrays' identity, so every tick of a window gets the same arrays
    (the session keys its device copies on that identity)."""
    if (plan is None or plan.slow_fraction <= 0
            or t < plan.slow_start
            or (plan.slow_stop and t >= plan.slow_stop)):
        return delays, throttle
    key = (plan.slow_fraction, plan.slow_delay, plan.slow_intensity,
           plan.seed)
    cache = getattr(plan, "_overlay_cache", None)
    if (cache is None or cache[0] != key or cache[1] is not delays
            or cache[2] is not throttle):
        d = delays.copy()
        th = throttle.copy()
        for p in plan.slow_shards(delays.shape[0]):
            d[p, :] = np.maximum(d[p, :], plan.slow_delay)
            th[p] = max(int(th[p]), int(plan.slow_intensity))
        cache = (key, delays, throttle, d, th)
        plan._overlay_cache = cache
    return cache[3], cache[4]


class FaultManager:
    """Snapshots, the message log and recovery for one run.

    ``ckpt`` maps a shard to its snapshot rows ``(values, active, cursor,
    aux | None)``, ``ckpt_tick`` holds each shard's snapshot step (-1 =
    none) and ``msg_log`` maps a step to its ``(send_vals, send_ids)``
    ``[P, Pn, cap]`` buffers, all as tensors on ``device``.  An async
    run's snapshots also record each shard's logical clock (``ckpt_clock``,
    host ints): the consistent cut under per-shard progress is a vector."""

    def __init__(self, cfg: GraphConfig, graph, prog, ep: EngineParams,
                 replay_slack: int = 0, device: DeviceLike = None):
        self.cfg, self.graph, self.prog, self.ep = cfg, graph, prog, ep
        self.device = resolve_device(device)
        # replay re-delivers (duplicates) messages: legal only under the
        # §3.3 idempotence precondition
        self.recovery = ("replay" if getattr(prog, "self_stabilizing", True)
                         else "checkpoint")
        self.ckpt_every = cfg.checkpoint_every
        self.log_ticks = cfg.replay_log_ticks
        # widens the replayed window past the snapshot (deferred delivery)
        self.replay_slack = replay_slack
        self.ckpt_tick = np.full(graph.num_shards, -1, np.int64)
        self.ckpt: dict[int, tuple] = {}
        self.ckpt_clock: dict[int, int] = {}
        self.msg_log: dict[int, tuple] = {}
        self._schedule: Optional[dict[int, list[int]]] = None
        self._boundary: Optional[torch.Tensor] = None

    def load_numpy(self, ckpt: dict, ckpt_tick, msg_log: dict) -> None:
        """Adopt snapshots and a message log held as host arrays — e.g. a
        JAX ``FaultManager``'s, so that both managers recover from one
        state."""
        def put(a, dtype):
            return torch.from_numpy(np.array(a, dtype)).to(self.device)

        self.ckpt = {
            int(p): (put(v, np.asarray(v).dtype), put(a, np.bool_),
                     put(c, np.int32),
                     put(x, np.float32) if x is not None else None)
            for p, (v, a, c, x) in ckpt.items()}
        self.ckpt_tick = np.array(ckpt_tick, np.int64)
        self.msg_log = {int(t): (put(sv, np.asarray(sv).dtype),
                                 put(si, np.int32))
                        for t, (sv, si) in msg_log.items()}

    # ------------------------------------------------------------------
    def record(self, t: int, state: EngineState, send_bufs,
               clock=None) -> None:
        """After host step ``t``'s tick: snapshot on checkpoint steps, and
        log the tick's send buffers (replay recovery only).  ``clock``
        (async runs): the host's ``[P]`` clock vector after the tick."""
        with _trace.span("asymp.faults.record"):
            if t % self.ckpt_every == 0:
                if clock is not None:
                    self.ckpt_clock = {p: int(c)
                                       for p, c in enumerate(clock)}
                vals, act, cur = (x.clone() for x in (state.values,
                                                       state.active,
                                                       state.cursor))
                aux = state.aux.clone() if state.aux is not None else None
                for p in range(self.graph.num_shards):
                    self.ckpt[p] = (vals[p], act[p], cur[p],
                                    aux[p] if aux is not None else None)
                self.ckpt_tick[:] = t
            if self.recovery == "replay":  # checkpoint mode never reads it
                sv, si = send_bufs
                self.msg_log[t] = (sv.clone(), si.clone())
                for old in list(self.msg_log):
                    if old < t - (self.log_ticks + self.replay_slack):
                        del self.msg_log[old]

    def rebase(self, t: int, state: EngineState, clock=None,
               graph=None) -> None:
        """Re-anchor recovery at the CURRENT state (streaming deltas).

        A graph delta invalidates everything recorded before it: a logged
        buffer carries values derived over edges that may be gone
        (replaying it would re-poison a targeted reset) and an older
        snapshot predates the patched CSR.  So the log is cleared, the
        state becomes every shard's snapshot at host step ``t`` (with
        ``clock``, a ``[P]`` clock vector, on the async path), and the
        boundary maps follow ``graph``: a kill inside the slack window then
        takes the boundary fallback, correct by self-stabilization on the
        new graph."""
        if graph is not None:
            self.graph = graph
        self._boundary = None  # cached from the graph it was built on
        self.msg_log.clear()
        vals, act, cur = (x.clone() for x in (state.values, state.active,
                                               state.cursor))
        aux = state.aux.clone() if state.aux is not None else None
        for p in range(self.graph.num_shards):
            self.ckpt[p] = (vals[p], act[p], cur[p],
                            aux[p] if aux is not None else None)
            self.ckpt_tick[p] = t
            if clock is not None:
                self.ckpt_clock[p] = int(clock[p])

    def maybe_fail(self, t: int, state: EngineState, plan: FaultPlan,
                   clock=None):
        """Fail and recover the shards the plan kills at host step ``t``.
        Returns ``(state, {"failures": n, "replayed": messages})``.

        ``clock`` (async runs): the current ``[P]`` clock vector.  After a
        failure ``extra["clock"]`` holds the recovered vector as an int32
        tensor: a replayed shard rolls back to its own snapshot entry (the
        others keep theirs), a global restore rolls the whole vector back."""
        if self._schedule is None:
            self._schedule = plan.schedule(self.graph.num_shards)
        extra = {"failures": 0, "replayed": 0}
        new_clock = None if clock is None else [int(c) for c in clock]
        for p in self._schedule.get(t, []):
            with _trace.span("asymp.faults.recover"):  # one span a kill
                state, replayed = self.fail_shard(t, state, p)
            extra["failures"] += 1
            extra["replayed"] += replayed
            if new_clock is not None:
                rolled = (range(self.graph.num_shards)
                          if self.recovery == "checkpoint" else (p,))
                for q in rolled:
                    new_clock[q] = self.ckpt_clock.get(q, 0)
        if new_clock is not None and extra["failures"]:
            extra["clock"] = torch.tensor(new_clock, dtype=torch.int32,
                                          device=self.device)
        return state, extra

    def fail_shard(self, t: int, state: EngineState, p: int
                   ) -> tuple[EngineState, int]:
        """Kill shard p: restore it from its snapshot (or re-init it), then
        replay the peers' logged messages to it, or re-activate the
        boundary beyond the log horizon.  Non-self-stabilizing programs
        take the global checkpoint restore instead."""
        if self.recovery == "checkpoint":
            return self._global_restore(state), 0
        values, active, cursor = (x.clone() for x in (state.values,
                                                       state.active,
                                                       state.cursor))
        if p in self.ckpt:
            v, a, c, _ = self.ckpt[p]
            values[p], active[p], cursor[p] = v, a, c
            since = int(self.ckpt_tick[p])
        else:  # no checkpoint yet -> re-init this shard
            vs = self.graph.vs
            gids = torch.arange(p * vs, (p + 1) * vs, dtype=torch.int32,
                                device=self.device)
            values[p], active[p] = self.prog.init(
                gids, gids < self.graph.num_real_vertices)
            cursor[p] = 0
            since = -1

        # every step whose delivery could postdate the snapshot
        lost = list(range(max(since + 1 - self.replay_slack, 0), t + 1))
        replayed = 0
        if lost and all(tt in self.msg_log for tt in lost):
            replayed = self._replay(p, lost, values, active, cursor)
        else:
            # log horizon exceeded: peers re-activate every vertex with an
            # edge into shard p
            b = self._boundary_into(p)
            active |= b
            cursor = torch.where(b, 0, cursor)
        # replay is refused for non-idempotent programs, so aux passes
        return EngineState(values, active, cursor, state.tick,
                           state.aux), replayed

    def _replay(self, p: int, lost: list, values, active, cursor) -> int:
        """Deliver every logged message for shard ``p`` of the ``lost``
        steps in one aggregator scatter; a vertex the result strictly
        improves activates and restarts its edge stream.  For min, max and
        or this equals delivering the messages one by one in log order (the
        JAX package's loop): the reduce is idempotent and ``improves`` is
        strict, so the final value and the set of improved vertices do not
        depend on the order.  Updates ``values``, ``active`` and ``cursor``
        in place and returns the number of valid messages."""
        agg = self.prog.aggregator
        vals_in = torch.cat([self.msg_log[tt][0][:, p].reshape(-1)
                             for tt in lost])
        ids_in = torch.cat([self.msg_log[tt][1][:, p].reshape(-1)
                            for tt in lost])
        old = values[p]
        # ids -1 (empty slots) fall into the scatter's drop slot
        new = agg.scatter(old[None], ids_in[None], vals_in[None])[0]
        improved = agg.improves(new, old)
        values[p] = new
        active[p] |= improved
        cursor[p] = torch.where(improved, 0, cursor[p])
        _trace.count("host_reads")
        return int(torch.sum(ids_in >= 0))

    def _boundary_into(self, p: int) -> torch.Tensor:
        """[P, vs] bool: vertices of the other shards with an edge into p."""
        if self._boundary is None:
            self._boundary = torch.from_numpy(
                np.ascontiguousarray(self.graph.boundary, bool)
            ).to(self.device)
        b = self._boundary[:, p].clone()
        b[p] = False
        return b

    # ------------------------------------------------------------------
    def _global_restore(self, state: EngineState) -> EngineState:
        """Every shard rolls back to the last snapshot, aux planes
        included; with no snapshot yet, the run re-initializes.  On the
        immediate transport no message is in flight between ticks; under
        deferred delivery the session restores the delay ring and the
        device tick from the same instant."""
        if not self.ckpt:
            return init_state(self.prog, self.graph,
                              self.device)._replace(tick=state.tick)
        rows = [self.ckpt[p] for p in range(self.graph.num_shards)]
        values, active, cursor = (torch.stack([r[i] for r in rows])
                                  for i in range(3))
        aux = (torch.stack([r[3] for r in rows])
               if rows[0][3] is not None else None)
        return EngineState(values, active, cursor, state.tick, aux)
