"""idle_moe.train: the share of the traced window, in %, in which no
operation ran on the device while the host was inside one of the program's
MoE spans (``models/moe.py``: ``moe.route``, ``moe.dispatch``,
``moe.experts``, ``moe.combine``), in the forward and again in remat's
recompute inside the backward."""

from sfbench import spans


def read(ctx):
    return spans.idle_under(ctx, "moe.route", "moe.dispatch", "moe.experts",
                            "moe.combine")
