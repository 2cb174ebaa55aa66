"""idle_bwd.train: the share of the traced window, in %, in which no
operation ran on the device while the host was inside the program's span
``train.backward``: a step's ``torch.autograd.grad``
(``training/train_loop.py`` ``value_and_grad``), remat's recomputed forward
included."""

from sfbench import spans


def read(ctx):
    return spans.idle_under(ctx, "train.backward")
