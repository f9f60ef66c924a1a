"""WCC: every vertex carries the least vertex id of its component.  The
control stops one synchronous round before the fixpoint."""
from portbench import reference


def expected(edges, n, config, seed, root):
    src, dst = reference.directed(edges, n)
    return reference.wcc(src, dst, n)


def control(edges, n, config, seed, root):
    src, dst = reference.directed(edges, n)
    return reference.wcc(src, dst, n, stop_short=True)
