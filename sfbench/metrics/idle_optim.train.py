"""idle_optim.train: the share of the traced window, in %, in which no
operation ran on the device while the host was inside the program's span
``optim.update``: a step's AdamW update (``training/optimizer.py``
``adamw_update``: the global norm, the clip and the per-leaf passes)."""

from sfbench import spans


def read(ctx):
    return spans.idle_under(ctx, "optim.update")
