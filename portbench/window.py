"""The measured window: whole jobs back to back, and nothing else.

A job starts only while the previous job's duration still fits before the
window's length, and a window always holds at least one whole job, so
``span / jobs`` is the time of one job over all the time of the window
(Graphalytics' processing time, T_proc).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable


@dataclasses.dataclass
class Window:
    span_s: float
    durations: list
    outputs: list

    @property
    def jobs(self) -> int:
        return len(self.durations)

    @property
    def seconds_per_job(self) -> float:
        return self.span_s / self.jobs


def run_window(job: Callable[[int], Any], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call ``job(i)`` for i = 0, 1, ... until the next job, if it took as
    long as the last, would end past ``seconds``."""
    start = clock()
    durations, outputs = [], []
    while True:
        t0 = clock()
        outputs.append(job(len(durations)))
        t1 = clock()
        durations.append(t1 - t0)
        if (t1 - start) + durations[-1] > seconds:
            return Window(t1 - start, durations, outputs)
