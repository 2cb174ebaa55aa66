"""spmv_copy_ms.cg: device ms an iteration in the concatenating copies
(``torch.cat``'s ``CatArrayBatchedCopy`` kernels) that ``ParCSR.spmv`` runs
around its ELL launches: each block's zero-padded x and the stacked y of
each half, from the device trace."""

from sfbench import trace


def read(ctx):
    it = sum(ctx.get("program", {}).get("iters", []))
    if not it:
        return None
    s, n = trace.kernel_seconds(ctx["ops"], [r"CatArrayBatchedCopy\w*"])
    return s * 1e3 / it if n else None
