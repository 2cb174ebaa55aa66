"""spmv_ell_roofline.cg: the ELL SpMV kernel's share of its byte bound, in %.
The bound is the benchmark's count (``counts.spmv_bytes``: 8 bytes a
nonzero of the configuration's operator, x read once and y written once)
over the card's HBM bandwidth, times the SpMVs of the traced window (the
program's ``spmv_ell`` launches over the ELL blocks an SpMV launches); the
time is every ``spmv_ell_kernel`` of the device trace."""

from sfbench import counts, trace


def read(ctx):
    prog, pk = ctx.get("program", {}), ctx.get("peaks")
    if not pk or not prog.get("spmv_ell_launches"):
        return None
    s, n = trace.kernel_seconds(ctx["ops"], [r"\bspmv_ell_kernel\b"])
    if not n:
        return None
    spmvs = prog["spmv_ell_launches"] / prog["ell_blocks_per_spmv"]
    bound = spmvs * counts.spmv_bytes(ctx["config"]["grid"]) \
        / pk["hbm_bytes_per_s"]
    return 100.0 * bound / s
