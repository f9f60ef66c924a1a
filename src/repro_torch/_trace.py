"""Spans and counts on the graph-job path, off unless a caller turns them on.

The engine opens a span around each layer's work (the session's init and
step, the tick's create, exchange and receive, the session's blocking
device-to-host reads, the fault manager's record and recovery) and counts
its host reads.  With tracing off, which is how every job runs unless it
is wrapped in :func:`tracing`, a span is one flag check and a shared no-op
context, and a count is one flag check.

With tracing on, a span is a profiler range: under a ``torch.profiler``
session it lands in the same kineto event list as the kernels it launches,
on the same clock and nested as the code nests, so a reader can put each
kernel's device time and each device idle gap down to the innermost span
open at the time.  The range is a plain function range
(``_RecordFunctionFast``), not ``record_function``'s user range: on a CUDA
card kineto mirrors every user range onto the device as an annotation
spanning the range's first to last kernel, which a reader of device
activity would take for device work, and a user range costs about 10 us a
call even with no profiler running (torch 2.13's CPU build; the function
range under 1 us).

Counts go to an in-memory dict that :func:`tracing` yields.  Nothing is
written anywhere: the caller reads the spans from its profiler and the
counts from the dict.  Span names start with ``asymp.``.
"""
from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()
_on = False
_counts: dict = {}


def span(name: str):
    """A context that opens the profiler range ``name`` while tracing is
    on, and the shared no-op context otherwise."""
    if not _on:
        return _OFF
    return _RecordFunctionFast(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` while tracing is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def tracing():
    """Turn spans and counts on; yields the counts, from zero.  The state
    before it (off, or an enclosing ``tracing``'s counts) comes back on
    exit."""
    global _on, _counts
    before = _on, _counts
    _on, _counts = True, {}
    try:
        yield _counts
    finally:
        _on, _counts = before
