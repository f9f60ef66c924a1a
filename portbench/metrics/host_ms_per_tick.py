"""Milliseconds a tick in which the device was not busy: the traced jobs'
wall time less the device busy time, over their ticks (the session's host
loop, dispatch and syncs)."""


def read(run):
    if run.trace is None:
        return None
    wall = sum(run.window.durations)
    return (wall - run.trace.busy_s) * 1e3 / run.total("ticks")
