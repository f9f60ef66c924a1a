"""Reduce the program's ``asymp.*`` spans in a traced window's kineto events
(``trace.Event``) to four numbers a span name:

* ``n``: the times the span opened;
* ``wall_s``: its total duration, children included;
* ``device_s``: the device time of the kernels, copies and sets whose
  launching runtime call (matched by correlation id) was issued while this
  span was the innermost ``asymp.*`` span open on the launching thread;
* ``idle_s``: the device idle time while the span was open, children
  included (idle as ``trace.summarize`` reckons it: the window is the span
  of all events, busy the union of device activity).

The program opens the spans (``repro_torch/_trace.py``) only while its
tracing is on; a trace without them reduces to ``{}``.  Device time
launched outside every span goes to no span.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.trace import _union

PREFIX = "asymp."


def _main_thread(events: list) -> int:
    """The thread that issued most runtime calls (``trace.summarize``'s)."""
    launches: dict = defaultdict(int)
    for e in events:
        if e.kind == "runtime":
            launches[e.thread] += 1
    if launches:
        return max(launches, key=launches.get)
    return next(e.thread for e in events if e.kind != "device")


def _innermost(spans: list, calls: list) -> dict:
    """Each runtime call's innermost open span name by correlation id;
    ``spans`` are properly nested, as one thread opens them."""
    spans = sorted(spans, key=lambda e: (e.start, -e.end))
    out, stack, i = {}, [], 0
    for call in sorted(calls, key=lambda e: e.start):
        while i < len(spans) and spans[i].start <= call.start:
            while stack and stack[-1].end <= spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end <= call.start:
            stack.pop()
        if stack:
            out[call.corr] = stack[-1].name
    return out


def _idle_before(events: list, device: list):
    """``f(t)``: the device idle time in the window before ``t``."""
    w0 = min(e.start for e in events)
    busy = _union([(e.start, e.end) for e in device])
    starts, ends, before = [], [], [0]
    t = w0
    for s, e in busy:
        if s > t:
            starts.append(t)
            ends.append(s)
            before.append(before[-1] + s - t)
        t = max(t, e)
    starts.append(t)  # the last gap runs to the window's end
    ends.append(max(e.end for e in events))
    before.append(before[-1] + ends[-1] - t)

    def idle_before(x: int) -> int:
        i = bisect.bisect_right(starts, x) - 1
        if i < 0:
            return 0
        return before[i] + min(x, ends[i]) - starts[i]
    return idle_before


def reduce(events: list) -> dict:
    """``{span name: {"n", "wall_s", "device_s", "idle_s"}}`` for every
    ``asymp.*`` span on the main thread, names in order."""
    device = [e for e in events if e.kind == "device"]
    if not device:
        return {}
    main = _main_thread(events)
    spans = [e for e in events if e.thread == main and e.kind == "op"
             and e.name.startswith(PREFIX)]
    calls = [e for e in events if e.thread == main and e.kind == "runtime"]
    owner = _innermost(spans, calls)
    idle_before = _idle_before(events, device)
    out: dict = {}
    for e in spans:
        row = out.setdefault(e.name, {"n": 0, "wall_s": 0, "device_s": 0,
                                      "idle_s": 0})
        row["n"] += 1
        row["wall_s"] += e.end - e.start
        row["idle_s"] += idle_before(e.end) - idle_before(e.start)
    for e in device:
        name = owner.get(e.corr)
        if name is not None:
            out[name]["device_s"] += e.end - e.start
    return {name: {"n": row["n"], "wall_s": row["wall_s"] / 1e9,
                   "device_s": row["device_s"] / 1e9,
                   "idle_s": row["idle_s"] / 1e9}
            for name, row in sorted(out.items())}
