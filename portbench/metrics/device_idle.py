"""Share of the traced window with nothing running on the device, in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
