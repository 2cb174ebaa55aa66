"""repro_torch.solvers — CG on the SF SpMV (paper §6.2)."""

from .cg import CGResult, as_matvec, cg, cg_async

__all__ = ["CGResult", "as_matvec", "cg", "cg_async"]
