"""Device busy milliseconds a tick: the union of the traced window's device
activity over the ticks of its jobs."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.busy_s * 1e3 / run.total("ticks")
