"""sf_kernel_ms.cg: device ms an iteration in the port's star-forest kernels
(every ``__global__`` of ``csrc/sf_pack.cu`` and ``csrc/sf_unpack.cu``: the
halo's packs, the fused local bcast, the segment reduces), from the device
trace."""

from sfbench import harness, trace


def read(ctx):
    it = sum(ctx.get("program", {}).get("iters", []))
    if not it:
        return None
    names = harness.kernel_names("sf_pack", "sf_unpack")
    s, n = trace.kernel_seconds(ctx["ops"], trace.whole_names(names))
    return s * 1e3 / it if n else None
