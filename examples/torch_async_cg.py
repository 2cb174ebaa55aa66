"""Paper §6.2 demo on the port: blocking CG against the fused-loop CGAsync
on the star-forest SpMV (the port of ``examples/async_cg.py``).

On the card (the default) ``cg_async`` runs its loop as a replayed CUDA
graph; ``--device cpu`` runs both on the CPU.

    PYTHONPATH=src python examples/torch_async_cg.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.solvers.cg import cg, cg_async
from repro_torch.sparse.parmat import ParCSR


def laplacian(n: int, device, nranks: int = 4) -> ParCSR:
    rows, cols, vals = [], [], []
    for i in range(n):
        rows += [i]
        cols += [i]
        vals += [2.2]
        if i:
            rows += [i]
            cols += [i - 1]
            vals += [-1.0]
        if i < n - 1:
            rows += [i]
            cols += [i + 1]
            vals += [-1.0]
    return ParCSR.from_global_coo(nranks, n, n, np.array(rows),
                                  np.array(cols), np.array(vals),
                                  device=device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = 1024
    M = laplacian(n, dev)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(n)
                        .astype(np.float32), device=dev)
    r1 = cg(M, b, tol=1e-6, maxiter=500)     # ParCSR accepted directly
    print(f"CG       : iters={r1.iters} rnorm={r1.rnorm:.2e} "
          f"converged={r1.converged}")
    r2 = cg_async(M, b, tol=1e-6, maxiter=500, check_every=1)
    print(f"CGAsync  : iters={r2.iters} rnorm={r2.rnorm:.2e} "
          f"converged={r2.converged}")
    r3 = cg_async(M.spmv, b, tol=1e-6, maxiter=500, check_every=20)
    print(f"CGAsync20: iters={r3.iters} (checks every 20 — the paper's "
          f"suggested improvement)")
    err = float(torch.max(torch.abs(r1.x - r2.x)))
    print(f"max |x_cg - x_async| = {err:.2e}")
    for name, fn in [("CG", lambda: cg(M.spmv, b, tol=0.0, maxiter=40)),
                     ("CGAsync", lambda: cg_async(M.spmv, b, maxiter=40,
                                                  check_every=0))]:
        fn()
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        print(f"{name:8s}: {(time.perf_counter()-t0)/40*1e6:8.1f} us/iter "
              f"on {dev.type}")


if __name__ == "__main__":
    main()
