"""train_mfu: the training step's share of the card's bf16 peak, in %: the
benchmark's model FLOPs of the steps (``counts.train_flops_per_token``: 6 x
the active non-embedding parameters and the LM head, and the causal
attention pairs; recomputation and capacity padding count as nothing) over
the host-clock seconds of ``mfu_steps`` untraced steps ended by a
synchronise."""


def read(ctx):
    prog, pk = ctx.get("program", {}), ctx.get("peaks")
    if not pk or not prog.get("mfu_seconds"):
        return None
    flops = prog["flops_per_step"] * prog["mfu_steps"]
    return 100.0 * flops / prog["mfu_seconds"] / pk["bf16_flops"]
