"""device_idle.train: the share of the traced window in which no operation ran
on the device, in % (one minus the union of the kernel, copy and set
intervals over the window)."""


def read(ctx):
    if not ctx.get("window_s") or not ctx.get("ops"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
