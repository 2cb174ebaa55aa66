"""flash_roofline.train: the flash attention kernels' share of their bound,
in %: the benchmark's count of the attention core's FLOPs
(``counts.flash_flops_per_step``: 4 pairs H hd forward and 10 backward over
the visible causal pairs) over the card's bf16 peak, against the device time
of every ``__global__`` of ``csrc/flash_attention*.cu`` in the trace (the
forward again under remat counts as time, not as work)."""

from sfbench import harness, trace


def read(ctx):
    prog, pk = ctx.get("program", {}), ctx.get("peaks")
    if not pk or not prog.get("steps"):
        return None
    names = harness.kernel_names("flash_attention", "flash_attention_sm90",
                                 "flash_attention_bwd")
    s, n = trace.kernel_seconds(ctx["ops"], trace.whole_names(names))
    if not n:
        return None
    bound = prog["flash_flops_per_step"] * prog["steps"] / pk["bf16_flops"]
    return 100.0 * bound / s
