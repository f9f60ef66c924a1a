"""The engine tick's share of the card's memory bandwidth, in %: the bytes
the jobs' work needs, counted once from the program's own counters, over
the device busy time at the peak of ``peaks.py``.

Needed bytes: a fetched edge reads its 4 B destination id and its 4 B
source value (and its 4 B weight in a weighted program); a sent message is
8 B written and 8 B read; an accepted message writes 4 B.  The count does
not depend on the padded shapes the tick sweeps, so it reads the same work
whatever implements the tick."""
from portbench.peaks import H100_HBM_BYTES_PER_S


def read(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    weighted = run.cell.config["engine"].get("weighted", False)
    needed = (run.total("fetched") * (12 if weighted else 8)
              + run.total("sent") * 16 + run.total("accepted") * 4)
    return 100.0 * needed / (run.trace.busy_s * H100_HBM_BYTES_PER_S)
