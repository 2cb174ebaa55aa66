"""moe_sf_ms.train: device ms a step in the port's star-forest kernels (every
``__global__`` of ``csrc/sf_pack.cu`` and ``csrc/sf_unpack.cu``): the MoE
dispatch and combine through ``DynPlan``, their transposes' segment
reduces in the backward, and the token lookup's gather and its
transpose, from the device trace."""

from sfbench import harness, trace


def read(ctx):
    steps = ctx.get("program", {}).get("steps")
    if not steps:
        return None
    names = harness.kernel_names("sf_pack", "sf_unpack")
    s, n = trace.kernel_seconds(ctx["ops"], trace.whole_names(names))
    return s * 1e3 / steps if n else None
