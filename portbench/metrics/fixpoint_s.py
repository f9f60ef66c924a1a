"""The window's span over the whole jobs in it (host clock): Graphalytics'
processing time, T_proc, of one job."""


def read(run):
    return run.window.seconds_per_job
