"""Reduce a ``torch.profiler`` trace of the window to device busy time,
device time by op, and the device's idle gaps by what the host was doing.

The arithmetic is that of the repository's bring-up profiling (device busy
time over the window, the ops with most device time), done on the raw
kineto events so that a window of a million kernels reduces in seconds:

* busy: the union of every device activity (kernels, copies, sets);
* a kernel's op: the innermost host op open when its launch was issued
  (launch and kernel share a correlation id);
* an idle gap: a stretch of the window with nothing on the device, split
  over the innermost host event open on the launching thread at each
  instant (``python`` where none is: interpreter time between ops).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

PYTHON = "python"
TOP = 10


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str  # "device" | "runtime" | "op"
    start: int  # ns
    end: int  # ns
    thread: int = 0
    corr: int = 0


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds], ...] most device time first
    idle_gaps: list  # [[host activity, seconds], ...] longest first

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _short_kernel(name: str) -> str:
    name = name.removeprefix("void ")
    return name.split("<", 1)[0].split("(", 1)[0]


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _flatten(host: list) -> tuple[list, dict]:
    """Nested host events of one thread -> non-overlapping ``(start, end,
    name)`` segments of the innermost open event, and each runtime call's
    enclosing op name by correlation id."""
    host = sorted(host, key=lambda e: (e.start, -e.end))
    segs: list = []
    parent_of: dict = {}
    stack: list = []  # [end, name]
    t = None

    def emit(a, b, name):
        if b > a:
            segs.append((a, b, name))

    for ev in host:
        while stack and stack[-1][0] <= ev.start:
            end, name = stack.pop()
            emit(t, end, name)
            t = end
        if stack:
            emit(t, ev.start, stack[-1][1])
        if ev.kind == "runtime":
            parent_of[ev.corr] = stack[-1][1] if stack else PYTHON
        end = min(ev.end, stack[-1][0]) if stack else ev.end
        stack.append([end, ev.name])
        t = ev.start
    while stack:
        end, name = stack.pop()
        emit(t, end, name)
        t = end
    return segs, parent_of


def summarize(events: list) -> Summary:
    """The window is the span of all events, from the first to the last."""
    device = [e for e in events if e.kind == "device"]
    host = [e for e in events if e.kind != "device"]
    if not device or not host:
        raise ValueError("the trace holds no device activity or no host "
                         "activity")
    w0 = min(e.start for e in events)
    w1 = max(e.end for e in events)
    busy = _union([(e.start, e.end) for e in device])
    busy_ns = sum(e - s for s, e in busy)

    launches = defaultdict(int)
    for e in host:
        if e.kind == "runtime":
            launches[e.thread] += 1
    main = max(launches, key=launches.get) if launches else host[0].thread
    segs, parent_of = _flatten([e for e in host if e.thread == main])

    by_op: dict = defaultdict(int)
    for e in device:
        op = parent_of.get(e.corr, "?")
        by_op[f"{op} | {_short_kernel(e.name)}"] += e.end - e.start

    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    by_host: dict = defaultdict(int)
    i = 0
    for g0, g1 in gaps:
        covered = 0
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b = max(segs[j][0], g0), min(segs[j][1], g1)
            if b > a:
                by_host[segs[j][2]] += b - a
                covered += b - a
            j += 1
        by_host[PYTHON] += (g1 - g0) - covered

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP] if v > 0]

    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                   device_ops=top(by_op), idle_gaps=top(by_host))


def _kind(ev, cuda_type) -> str:
    if ev.device_type() == cuda_type:
        return "device"
    name = ev.name()
    return "runtime" if name.startswith(("cuda", "cu")) else "op"


def record(fn):
    """Run ``fn()`` under the profiler (CPU and CUDA activity) and return
    ``(fn's result, Summary)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [Event(ev.name(), _kind(ev, DeviceType.CUDA), ev.start_ns(),
                    ev.start_ns() + ev.duration_ns(), ev.start_thread_id(),
                    ev.correlation_id())
              for ev in prof.profiler.kineto_results.events()]
    del prof
    return out, summarize(events)
