"""idle_loop.cg: the share of the traced window, in %, in which no operation
ran on the device while the host was inside the program's span ``cg.loop``:
a solve's graph replays and the host's reads of the loop's flag
(``solvers/cg.py`` ``_replay``, each read a ``cg.flag`` inside it)."""

from sfbench import spans


def read(ctx):
    return spans.idle_under(ctx, "cg.loop")
