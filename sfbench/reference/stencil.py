"""Plain reference of the Poisson cells: PETSc ``ex45.c``'s operator, the
7-point Laplacian on a structured grid with homogeneous Dirichlet
boundaries (6 at the centre, -1 for each neighbour inside the grid), applied
from the grid alone with plain ``torch`` slicing, and a plain conjugate
gradient on it.

A distributed vector holds the grid in PETSc's DMDA *global* ordering: the
ranks' boxes one after another, rank r at coordinates ``unravel(r,
proc_grid)`` (the last axis fastest), each box row-major inside.
:func:`to_global` and :func:`to_natural` convert between that ordering and
the grid's own (natural) one, from the grid and the rank grid alone.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["apply", "rel_residual", "to_global", "to_natural", "cg"]


def apply(x: torch.Tensor) -> torch.Tensor:
    """The operator on a grid ``x`` (Z, Y, X), in ``x``'s dtype."""
    p = F.pad(x[None, None], (1, 1, 1, 1, 1, 1))[0, 0]
    return 6 * x - (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
                    + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
                    + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])


def rel_residual(b: torch.Tensor, x: torch.Tensor) -> float:
    """||b - A x|| / ||b||, every step in float64."""
    b64 = b.double()
    r = b64 - apply(x.double())
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def _blocks(grid: Sequence[int], proc_grid: Sequence[int]) -> tuple:
    for g, p in zip(grid, proc_grid):
        if g % p:
            raise ValueError(f"grid {tuple(grid)} does not split evenly over "
                             f"ranks {tuple(proc_grid)}")
    return tuple(g // p for g, p in zip(grid, proc_grid))


def to_global(x: torch.Tensor, proc_grid: Sequence[int]) -> torch.Tensor:
    """A natural-order grid (Z, Y, X) as a global-order vector."""
    (pz, py, px), (bz, by, bx) = proc_grid, _blocks(x.shape, proc_grid)
    return x.reshape(pz, bz, py, by, px, bx).permute(0, 2, 4, 1, 3, 5) \
        .reshape(-1)


def to_natural(v: torch.Tensor, grid: Sequence[int],
               proc_grid: Sequence[int]) -> torch.Tensor:
    """A global-order vector as the natural-order grid (Z, Y, X)."""
    (pz, py, px), (bz, by, bx) = proc_grid, _blocks(grid, proc_grid)
    return v.reshape(pz, py, px, bz, by, bx).permute(0, 3, 1, 4, 2, 5) \
        .reshape(tuple(grid))


def cg(b: torch.Tensor, rtol: float, maxiter: int,
       dtype: torch.dtype) -> tuple:
    """Plain unpreconditioned CG from x = 0 on the grid ``b``, every vector
    and scalar in ``dtype``, until ||r|| <= rtol ||b|| on the recursive
    residual or ``maxiter`` iterations: (x, iterations)."""
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.sum(r * r)
    stop = (rtol ** 2) * float(torch.sum(b.double() ** 2))
    it = 0
    while it < maxiter and float(rr) > stop:
        ap = apply(p)
        alpha = rr / torch.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = torch.sum(r * r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        it += 1
    return x, it
