"""Messages that improved a vertex over messages sent, in % (the session's
``totals["accepted"] / totals["sent"]``): the priority scheduler's useful
share of the work it sends."""


def read(run):
    sent = run.total("sent")
    return 100.0 * run.total("accepted") / sent if sent else None
