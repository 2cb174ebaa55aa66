"""Composed-SF geometric multigrid on the port (paper §2 derived SFs): a 2D
Poisson problem, V-cycle-preconditioned CG against plain CG, plus
stash-based assembly of the same operator from element-style insertions
(the port of ``examples/multigrid_poisson.py``).

    PYTHONPATH=src python examples/torch_multigrid_poisson.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.meshdist.dmda import DMDA
from repro_torch.solvers import Multigrid, cg
from repro_torch.sparse import MatAssembler, Sparsity


def assemble_poisson_via_stash(da, device):
    """Build the 5-point Laplacian with MatAssembler: each rank inserts the
    full stencil rows of its owned points; cross-boundary couplings land in
    the stash and flush with ONE compose_inverse-built SF reduce."""
    n = da.nglobal
    sten_rows, sten_cols, sten_vals = [], [], []
    nat = DMDA.box_coords([(0, e) for e in da.shape])
    gid = da.natural_to_global(nat)
    idx = np.full(da.shape, -1, dtype=np.int64)
    idx[tuple(nat.T)] = gid
    for (i, j), g in zip(nat, gid):
        sten_rows.append(g)
        sten_cols.append(g)
        sten_vals.append(4.0)
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            ii, jj = i + di, j + dj
            if 0 <= ii < da.shape[0] and 0 <= jj < da.shape[1]:
                sten_rows.append(g)
                sten_cols.append(int(idx[ii, jj]))
                sten_vals.append(-1.0)
    rows, cols = np.asarray(sten_rows), np.asarray(sten_cols)
    vals = np.asarray(sten_vals, np.float32)
    sp = Sparsity(da.nranks, n, n, rows, cols,
                  row_offsets=da.owned_offsets, col_offsets=da.owned_offsets)
    asm = MatAssembler(sp, device=device)
    src = np.random.default_rng(0).integers(0, da.nranks, rows.size)
    for q in range(da.nranks):
        sel = src == q
        asm.add_values(q, rows[sel], cols[sel], vals[sel])
    A = asm.assemble()
    print(f"stash assembly: {asm.stats['stashed_inserts']} of {rows.size} "
          f"inserts off-process, {asm.stats['flushes']} flush "
          f"(= one SF reduce)")
    return A


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    da = DMDA((33, 33), 4, periodic=False)
    A = assemble_poisson_via_stash(da, dev)
    mg = Multigrid(da, A, nlevels=4, device=dev)
    print("hierarchy:", " -> ".join(str(d.shape) for d in mg.das))

    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(da.nglobal).astype(np.float32),
                        device=dev)
    plain = cg(A.spmv, b, tol=1e-6, maxiter=400)
    pre = cg(A.spmv, b, tol=1e-6, maxiter=400, M=mg.vcycle)
    print(f"plain CG : {plain.iters:3d} iterations  "
          f"(|r| = {plain.rnorm:.2e}, converged={plain.converged})")
    print(f"V(1,1)-PCG: {pre.iters:3d} iterations  "
          f"(|r| = {pre.rnorm:.2e}, converged={pre.converged})")
    speed = plain.iters / max(pre.iters, 1)
    print(f"-> {speed:.1f}x fewer iterations from the SF-composed V-cycle")


if __name__ == "__main__":
    main()
