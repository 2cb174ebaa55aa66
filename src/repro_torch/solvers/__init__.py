"""repro_torch.solvers — Krylov solvers on SF-backed operators (paper
§6.2), plus the §2-composed geometric-multigrid hierarchy."""

from .cg import CGResult, as_matvec, cg, cg_async
from .multigrid import Multigrid, Transfer, build_hierarchy

__all__ = [
    "CGResult",
    "Multigrid",
    "Transfer",
    "as_matvec",
    "build_hierarchy",
    "cg",
    "cg_async",
]
