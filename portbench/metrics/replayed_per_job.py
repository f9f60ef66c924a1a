"""Messages replayed to recovering shards, a job's mean (the session's
``totals["replayed"]``); nothing to read in a run without failures."""


def read(run):
    if not run.total("failures"):
        return None
    return run.total("replayed") / run.window.jobs
