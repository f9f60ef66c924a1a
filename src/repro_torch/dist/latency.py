"""Per-link / per-shard latency models for crowded-cluster emulation.

The port's own copy of ``repro.dist.latency`` (numpy only; the port
imports nothing of the JAX package).  Its arrays and firing masks are
the JAX package's bit for bit (``tests/test_torch_crowded.py``,
``tests/test_torch_async.py``).

A :class:`LatencyModel` describes one emulated cluster condition (paper
§5.4: "What happens when 50% of the machines are crowded?") as two
deterministic, seeded arrays:

  * ``delays [P, P]`` — extra ticks a message from sender shard ``p`` to
    receiver shard ``q`` spends on the wire; the deferred-delivery ring
    (``exchange.exchange_local_delayed``) defers delivery by it.  A slow
    machine is modeled as delay on all of its outgoing links.
  * ``throttle [P]`` — per-shard work-budget divisor: a shard with
    throttle ``k`` selects ``1/k`` of the per-tick vertex budget (the
    sync schedule) or fires every ``k``-th step (the async schedule).

Profiles: ``none`` (healthy), ``uniform`` (every link ``link_delay``
ticks, no throttle), ``stragglers`` (a seeded ``slow_fraction`` of the
shards crowded: outgoing links ``link_delay`` ticks, budget divided by
``intensity``) and ``heavy_tail`` (seeded Zipf severities: most shards
healthy, a few badly crowded).

:class:`AsyncInterleaving` is the async schedule's seeded firing pattern:
a pure function of ``(seed, step, rates)``, keyed by the engine on the
device tick.

Layer contract: imports only numpy; nothing here imports from
``repro_torch.core`` or above.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PROFILES = ("none", "uniform", "stragglers", "heavy_tail")

# heavy_tail severities are capped so the deferred-delivery ring (sized
# max_delay + 1 slots) stays small
_HEAVY_TAIL_DELAY_CAP = 6


@dataclasses.dataclass(frozen=True, eq=False)
class LatencyModel:
    """One emulated cluster condition (deterministic in its inputs)."""

    profile: str
    num_shards: int
    delays: np.ndarray  # [P, P] int32 — sender -> receiver extra ticks
    throttle: np.ndarray  # [P] int32 — per-shard work-budget divisor (>= 1)
    slow_mask: np.ndarray  # [P] bool — which shards are crowded
    seed: int = 0

    @property
    def max_delay(self) -> int:
        """Ring size the deferred-delivery buffer needs (slots - 1)."""
        return int(self.delays.max(initial=0))

    def describe(self) -> str:
        return (f"{self.profile}(slow={int(self.slow_mask.sum())}/"
                f"{self.num_shards}, max_delay={self.max_delay}, "
                f"max_throttle={int(self.throttle.max(initial=1))})")


def make_latency_model(profile: str, num_shards: int, *,
                       slow_fraction: float = 0.5, link_delay: int = 2,
                       intensity: int = 4, seed: int = 0) -> LatencyModel:
    """Build a deterministic latency model for one emulated condition.

    ``slow_fraction`` — fraction of shards crowded (stragglers profile);
    ``link_delay``    — wire delay in ticks on affected links;
    ``intensity``     — work-budget divisor for crowded shards.
    """
    if profile not in PROFILES:
        raise ValueError(f"unknown latency profile {profile!r}; "
                         f"known: {PROFILES}")
    P = num_shards
    delays = np.zeros((P, P), np.int32)
    throttle = np.ones((P,), np.int32)
    slow = np.zeros((P,), bool)
    if profile == "uniform":
        delays[:, :] = max(int(link_delay), 0)
    elif profile == "stragglers":
        k = int(round(slow_fraction * P))
        rng = np.random.default_rng(seed)
        slow[rng.permutation(P)[:k]] = True
        delays[slow, :] = max(int(link_delay), 0)
        throttle[slow] = max(int(intensity), 1)
    elif profile == "heavy_tail":
        rng = np.random.default_rng(seed)
        # Zipf(2) - 1: mostly zeros, occasionally large — cap both tails
        sev = np.minimum(rng.zipf(2.0, size=P) - 1,
                         max(int(intensity), 1)).astype(np.int32)
        slow = sev > 0
        delays[slow, :] = np.minimum(sev[slow], _HEAVY_TAIL_DELAY_CAP
                                     )[:, None]
        throttle = np.maximum(1 + sev, 1).astype(np.int32)
    return LatencyModel(profile=profile, num_shards=P, delays=delays,
                        throttle=throttle, slow_mask=slow, seed=seed)


def from_config(cfg) -> LatencyModel:
    """Resolve a :class:`LatencyModel` from a ``GraphConfig``'s emulation
    knobs (``latency_profile`` / ``slow_fraction`` / ``link_delay`` /
    ``slow_intensity`` / ``latency_seed``)."""
    return make_latency_model(
        cfg.latency_profile, cfg.num_shards,
        slow_fraction=cfg.slow_fraction, link_delay=cfg.link_delay,
        intensity=cfg.slow_intensity, seed=cfg.latency_seed)


# ======================================================================
# Asynchronous scheduling: deterministic seeded interleaving
# ======================================================================
@dataclasses.dataclass(frozen=True, eq=False)
class AsyncInterleaving:
    """Deterministic seeded firing schedule for the barrier-free engine.

    Under ``schedule="async"`` the global tick barrier is gone: a step of
    the host loop is one unit of emulated wall-clock, and each shard
    *fires* (drains its delay-ring arrivals, selects frontier work with
    its FULL edge budget, pushes new messages) only on its own steps.  A
    crowded shard's throttle ``k`` is consumed as a *progress rate* —
    the shard fires every ``k``-th step — instead of the synchronous
    mode's budget divisor (``1/k`` of the budget every step).  Average
    throughput is identical; the semantics are barrier-free: nobody
    waits for the slow shard, its inbound messages queue in the delay
    ring until it fires.

    The schedule is a pure function of ``(seed, step, rates)`` so two
    runs of the same config interleave identically — that is what lets
    CI assert bit-identical async-vs-BSP fixpoints for idempotent
    programs.  Seeded per-shard *phases* decorrelate the crowded shards'
    firing steps (they would otherwise all burst on step ``k·i`` and
    swamp healthy receivers).  Optional *jitter* perturbs rate-1 shards
    with a seeded stateless skip that never skips twice in a row, so
    even "healthy" shards interleave nondeterministically-looking (yet
    reproducible) — the stall bound stays 2.
    """

    num_shards: int
    rates: np.ndarray  # [P] int32 >= 1 — shard p fires every rates[p] steps
    phases: np.ndarray  # [P] int32 — seeded firing offsets (phase < rate)
    jitter: bool = False
    seed: int = 0

    def stall_bound(self, extra_rate: int = 1) -> int:
        """Longest run of steps any shard can go without firing, PLUS its
        firing step (i.e. the max gap between consecutive firings).

        This is the async staleness bound the ring must be sized for: a
        message due at step ``t`` may wait up to ``stall_bound() - 1``
        further steps for its receiver to fire, so the delay ring needs
        ``max_delay + stall_bound()`` slots — sizing it ``max_delay + 1``
        (the synchronous rule) would let a send overwrite a due-but-
        unconsumed message.  ``extra_rate`` accounts for a fault plan
        that raises throttles mid-run (slowdown injection)."""
        r = max(int(self.rates.max(initial=1)), int(extra_rate), 1)
        return max(r, 2) if self.jitter else r

    def fire_mask(self, step: int, rates=None) -> np.ndarray:
        """[P] bool — which shards fire at this step.  ``rates`` overrides
        the base rates for the step (fault-injected slowdowns raise a
        shard's rate mid-run without rebuilding the interleaving)."""
        r = np.maximum(np.asarray(self.rates if rates is None else rates,
                                  np.int64), 1)
        fire = ((step + self.phases) % r) == 0
        if self.jitter:
            # stateless seeded skip for rate-1 shards: skip(s) requires
            # coin(s) AND NOT coin(s-1), so two consecutive skips are
            # impossible — a jittered shard still fires >= once per 2
            # steps (stall_bound stays finite and small)
            skip = self._coin(step) & ~self._coin(step - 1) & (r == 1)
            fire = fire & ~skip
        return fire

    def _coin(self, step: int) -> np.ndarray:
        """[P] bool — splitmix64-style hash bit per (seed, shard, step)."""
        shards = np.arange(self.num_shards, dtype=np.uint64)
        # scalar mixing terms wrap mod 2**64 in Python-int space (numpy
        # warns on scalar uint64 overflow; array arithmetic wraps silently)
        mask = (1 << 64) - 1
        base = ((max(step + 1, 0) * 0x9E3779B97F4A7C15
                 + self.seed * 0x94D049BB133111EB) & mask)
        x = (np.uint64(base)
             + (shards + np.uint64(1)) * np.uint64(0xBF58476D1CE4E5B9))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        return ((x >> np.uint64(17)) & np.uint64(1)) == 1

    def describe(self) -> str:
        return (f"async(rates<= {int(self.rates.max(initial=1))}, "
                f"stall<= {self.stall_bound()}, jitter={self.jitter}, "
                f"seed={self.seed})")


def make_interleaving(num_shards: int, *, rates=None, seed: int = 0,
                      jitter: bool = False) -> AsyncInterleaving:
    """Build the deterministic interleaving for one async run.

    ``rates`` is usually a latency model's ``throttle`` vector (the §5.4
    crowding, consumed as progress rates); ``None`` means every shard is
    healthy (rate 1).  Phases are drawn per shard from ``[0, rate)`` with
    a seeded generator, so the same ``(rates, seed)`` always produces the
    same interleaving."""
    r = (np.ones((num_shards,), np.int32) if rates is None
         else np.maximum(np.asarray(rates, np.int32), 1))
    rng = np.random.default_rng(seed)
    phases = rng.integers(0, r).astype(np.int32)
    return AsyncInterleaving(num_shards=num_shards, rates=r, phases=phases,
                             jitter=jitter, seed=seed)
