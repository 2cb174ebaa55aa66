"""matvecs_per_iter.cg: the operator applications a CG iteration costs, over
the traced window's solves: the sum of their ``CGResult.matvecs`` (the
program's counter: the eager SpMVs, and a captured chunk's once per graph
replay) over the sum of their ``iters``.  The excess over 1 is the warm-up
and first residual, the warm-up chunk before each capture and the idle
guarded iterations after convergence.  None where the solver's results
carry no such counter."""


def read(ctx):
    res = ctx.get("result") or []
    mv = [getattr(r, "matvecs", None) for r in res]
    it = sum(getattr(r, "iters", 0) for r in res)
    if not res or None in mv or not it:
        return None
    return sum(mv) / it
