"""idle_capture.cg: the share of the traced window, in %, in which no
operation ran on the device while the host was inside the program's span
``cg.capture``: a solve's capture of its guarded chunk into a CUDA graph
(``solvers/cg.py`` ``_capture``: the side-stream warm-up chunk, the capture
and the instantiation)."""

from sfbench import spans


def read(ctx):
    return spans.idle_under(ctx, "cg.capture")
