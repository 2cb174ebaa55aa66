"""idle_solve.cg: the share of the traced window, in %, in which no operation
ran on the device while the host was inside the program's span ``cg.solve``:
all of a solve (``solvers/cg.py`` ``cg_async``: prepare, capture, loop,
result and the graph's teardown).  ``device_idle.cg`` less this is the idle
between solves."""

from sfbench import spans


def read(ctx):
    return spans.idle_under(ctx, "cg.solve")
