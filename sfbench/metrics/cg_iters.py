"""cg_iters: the solver's iterations to the tolerance, the mean of the traced
window's solves, as ``cg_async`` counts them (a program counter)."""


def read(ctx):
    it = ctx.get("program", {}).get("iters")
    if not it:
        return None
    return sum(it) / len(it)
