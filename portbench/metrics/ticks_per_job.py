"""Engine ticks to quiescence, a job's mean over the window (the session's
``totals["ticks"]``)."""


def read(run):
    return run.total("ticks") / run.window.jobs
