"""Conjugate gradient on SF-based SpMV: blocking CG vs. async CG (paper §6.2).

The paper contrasts two executions of the same Krylov iteration:

* **CG** — each iteration launches device kernels, then *synchronizes* for
  scalar reductions (the dot is copied to the host, convergence is checked
  on the host).  Every iteration blocks the kernel-launch pipeline.

* **CGAsync** — dots and scalar arithmetic stay on the device and the host
  does not check convergence every iteration, so it can run ahead and
  enqueue many iterations.

``cg`` below reads the residual norm back to the host every iteration —
the paper's blocking structure.  ``cg_async`` keeps every scalar on the
device and reads the device's convergence flag only at iterations where a
check falls (every ``check_every``; never with ``check_every=0``, the
paper's CGAsync, which runs to ``maxiter``).  Its loop condition is the
reference's exactly: ``it < maxiter and (rr > tol² · max(b², 1e-30) or
it % check_every != 0)``.  The reference fuses the loop into one
``lax.while_loop``; here the host issues the iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = ["CGResult", "cg", "cg_async", "as_matvec"]


def as_matvec(op) -> Callable:
    """Accept either a raw matvec callable or an SF-backed operator (e.g.
    :class:`repro_torch.sparse.parmat.ParCSR`) whose ``spmv`` routes its
    ghost exchange through the :class:`repro_torch.core.SFComm` backend."""
    if hasattr(op, "spmv"):
        return op.spmv
    if callable(op):
        return op
    raise TypeError(f"need a callable or an object with .spmv, got {op!r}")


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iters: int
    rnorm: float
    converged: bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def _step(matvec, x, r, p, rr):
    """One CG iteration of the paper's unpreconditioned loop.  Returns the
    new <r, r>, which serves both beta and the convergence check."""
    Ap = matvec(p)
    alpha = rr / _dot(p, Ap)
    x = x + alpha * p
    r = r - alpha * Ap
    rr_new = _dot(r, r)
    p = r + (rr_new / rr) * p
    return x, r, p, rr_new


def _init(matvec, b, x0):
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    return x, r, r, _dot(r, r)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, tol: float = 1e-8, maxiter: int = 500) -> CGResult:
    """Host-stepped CG with a host-side convergence check every iteration
    (the paper's blocking baseline).  ``matvec`` may be a callable or an
    SF-backed operator accepted by :func:`as_matvec`.  Convergence is
    judged on the recursive residual norm ||r||."""
    matvec = as_matvec(matvec)
    x, r, p, rr = _init(matvec, b, x0)
    bnorm = float(torch.sqrt(_dot(b, b)))
    it = 0
    rnorm = float(torch.sqrt(rr))
    while it < maxiter:
        # host reads the residual -> device/host sync every iteration
        if rnorm <= tol * max(bnorm, 1e-30):
            return CGResult(x, it, rnorm, True)
        x, r, p, rr = _step(matvec, x, r, p, rr)
        rnorm = float(torch.sqrt(rr))   # blocking host readback
        it += 1
    return CGResult(x, it, rnorm, rnorm <= tol * max(bnorm, 1e-30))


def cg_async(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *, tol: float = 1e-8,
             maxiter: int = 500, check_every: int = 1) -> CGResult:
    """CG whose scalars stay on the device: the host reads the convergence
    flag ``rr > tol² · max(b², 1e-30)`` only at iterations that are
    multiples of ``check_every``, and never when ``check_every == 0`` (the
    paper's CGAsync, which runs to ``maxiter``)."""
    matvec = as_matvec(matvec)
    x, r, p, rr = _init(matvec, b, x0)
    b2 = _dot(b, b)
    tol2 = torch.as_tensor(tol, dtype=rr.dtype, device=rr.device) ** 2 \
        * torch.clamp(b2, min=1e-30)
    it = 0
    while it < maxiter:
        if check_every and it % check_every == 0 and not bool(rr > tol2):
            break
        x, r, p, rr = _step(matvec, x, r, p, rr)
        it += 1
    rnorm = float(torch.sqrt(rr))
    bnorm = float(torch.sqrt(b2))
    return CGResult(x, it, rnorm, rnorm <= tol * max(bnorm, 1e-30))
