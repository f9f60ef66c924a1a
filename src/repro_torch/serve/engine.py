"""Admission control for the slot-batching servers.

Counterpart of the admission half of ``repro.serve.engine``: a bounded
FIFO with per-item deadlines and an injectable clock
(:class:`AdmissionQueue`), the typed backpressure rejection
(:class:`QueueFullError`) and the typed deadline answer
(:class:`DeadlineExceeded`), which the graph ``QueryServer`` in
``serve/graph.py`` uses.  Under sustained load the contract is graceful
degradation: a full queue rejects at submit time (the caller sees
backpressure at once, nothing is silently dropped), and an admitted
request that outlives its deadline retires with a typed answer instead
of holding a slot.  The LM ``SlotServer`` and its prefill and decode
steps come with the LM scaffolding.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional


class QueueFullError(RuntimeError):
    """Typed submit-time rejection: the bounded admission queue is at
    capacity.  Carries the bound so callers can report backpressure."""

    def __init__(self, max_queue: int):
        super().__init__(f"admission queue full (max_queue={max_queue})")
        self.max_queue = max_queue


class DeadlineExceeded(NamedTuple):
    """Typed terminal answer for a request that outlived its deadline
    budget (queued too long, or admitted but not answered in time)."""
    rid: int
    kind: str
    waited_s: float


class AdmissionQueue:
    """Bounded FIFO with per-item absolute deadlines.

    ``max_queue=None`` keeps the unbounded legacy behavior.  ``clock``
    is injectable (tests drive deadlines with a fake clock; production
    uses ``time.monotonic``).  Counters: ``submitted`` (accepted
    pushes), ``rejected`` (queue-full pushes).  Expiry of queued items
    is the *caller's* retirement decision — :meth:`pop_ready` hands
    back ``(item, enqueued_at, deadline)`` and reports overdue items
    separately so the owner can answer them with a typed result."""

    def __init__(self, max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.clock = clock
        self._q: list[tuple[Any, float, Optional[float]]] = []
        self.submitted = 0
        self.rejected = 0

    def push(self, item, deadline_s: Optional[float] = None) -> None:
        """Enqueue ``item`` with a relative deadline budget (seconds;
        None = no deadline).  Raises :class:`QueueFullError` when the
        bound is hit — backpressure is surfaced at submit time."""
        if self.max_queue is not None and len(self._q) >= self.max_queue:
            self.rejected += 1
            raise QueueFullError(self.max_queue)
        now = self.clock()
        deadline = (now + deadline_s) if deadline_s is not None else None
        self._q.append((item, now, deadline))
        self.submitted += 1

    def pop_ready(self, limit: int
                  ) -> tuple[list[tuple[Any, float, Optional[float]]],
                             list[tuple[Any, float]]]:
        """Dequeue up to ``limit`` live items.  Returns ``(admitted,
        expired)``: admitted as ``(item, enqueued_at,
        absolute_deadline)``, expired as ``(item, waited_s)`` — every
        expired item found while scanning is drained regardless of
        ``limit`` (an overdue entry must never block a live one behind
        it)."""
        admitted: list[tuple[Any, float, Optional[float]]] = []
        expired: list[tuple[Any, float]] = []
        keep: list[tuple[Any, float, Optional[float]]] = []
        now = self.clock()
        for item, enq, deadline in self._q:
            if deadline is not None and now > deadline:
                expired.append((item, now - enq))
            elif len(admitted) < limit:
                admitted.append((item, enq, deadline))
            else:
                keep.append((item, enq, deadline))
        self._q = keep
        return admitted, expired

    def __len__(self) -> int:
        return len(self._q)
