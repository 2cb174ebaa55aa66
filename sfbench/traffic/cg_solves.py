"""Closed-loop Poisson solves: the driver of the cells whose configuration is
a structured-grid Poisson problem (PETSc's ``ex45.c`` on a DMDA) and whose
traffic is a cycle of right-hand sides, each solved to a relative tolerance
from a zero first guess, the next solve sent when the last has returned.

Traffic parameters (the cell file's ``traffic``):
  ``rhs``            right-hand sides drawn at set-up, cycled through;
  ``maxiter``        the solver's iteration limit;
  ``warmup_solves``  solves of set-up (the tuner's sweeps, the first
                     captures);
  ``trace_solves``   solves in the traced window.

The program is entered as its users enter it: ``DMDA``, then
``ParCSR.from_dmda_stencil``, then ``solvers.cg_async`` on ``A.spmv`` with
the ELL kernels (each solve captures its chunks of guarded iterations into
a CUDA graph and replays them).  The check recomputes every kept solution's
residual ``||b - A x|| / ||b||`` in float64 with the reference's stencil,
from the grid alone.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from sfbench import harness, trace
from sfbench.reference import stencil

RETAKE_WAITS_S = (0.0, 1.0, 2.0)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Cell:
    def __init__(self, conf: dict, workload: dict, seed: int, device):
        self.conf, self.wl, self.seed, self.dev = conf, workload, seed, device
        self.traffic = workload["traffic"]
        self.grid = tuple(conf["grid"])
        self.proc_grid = tuple(conf["proc_grid"])
        self.rtol = float(conf["rtol"])
        self.x: Dict[int, torch.Tensor] = {}
        self.iters, self.converged = [], []

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from repro_torch.meshdist import DMDA
        from repro_torch.sparse import ParCSR
        c = self.conf
        self.da = DMDA(self.grid, c["nranks"], proc_grid=self.proc_grid,
                       stencil=c["stencil"], width=c["stencil_width"],
                       periodic=False)
        self.A = ParCSR.from_dmda_stencil(self.da, device=self.dev)
        self.draw(self.seed)
        for i in range(int(self.traffic["warmup_solves"])):
            self.solve(i)
        _sync(self.dev)
        self.x.clear()
        self.iters, self.converged = [], []

    def draw(self, seed: int) -> None:
        """The right-hand sides of ``seed``: independent standard normal
        entries on the grid (``b_nat``) and in the DMDA's global order
        (``b``)."""
        self.seed, self.b_nat, self.b = seed, [], []
        for i in range(int(self.traffic["rhs"])):
            g = torch.Generator(device=self.dev).manual_seed(
                harness.seed_of(seed, "rhs", i))
            bn = torch.randn(self.grid, generator=g, device=self.dev)
            self.b_nat.append(bn)
            self.b.append(stencil.to_global(bn, self.proc_grid).contiguous())

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self.A.spmv(v, use_kernel=True)

    def solve(self, n: int):
        from repro_torch import solvers
        i = n % len(self.b)
        res = solvers.cg_async(self.matvec, self.b[i], tol=self.rtol,
                               maxiter=int(self.traffic["maxiter"]))
        self.x[i] = res.x
        self.iters.append(int(res.iters))
        self.converged.append(bool(res.converged))
        return res

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        _sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.solve(n)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.dev)
        wall = time.perf_counter() - t0
        return {"attempted": n, "failed": self.converged.count(False),
                "metrics": {"solve_ms": wall * 1e3 / n}}

    def traced(self, path) -> dict:
        """``trace_solves`` solves in a profiler window, taken again while
        the trace holds fewer ``spmv_ell`` launches than the program's
        launch counter counted in it (a graph replay's kernels can be
        missed by the profiler); the run fails if every try falls short."""
        from repro_torch.kernels import ops as kops
        k = int(self.traffic["trace_solves"])
        for wait in RETAKE_WAITS_S:
            time.sleep(wait)
            start = len(self.iters)
            ell0 = kops.spmv_ell.launches
            out = trace.profiled(lambda: [self.solve(j) for j in range(k)],
                                 path, self.dev.type == "cuda")
            launches = kops.spmv_ell.launches - ell0
            _, seen = trace.kernel_seconds(out["ops"],
                                           [r"\bspmv_ell_kernel\b"])
            if seen == launches and (launches or self.dev.type != "cuda"):
                break
        else:
            raise RuntimeError(f"the profiler saw {seen} of {launches} "
                               f"spmv_ell launches in every try")
        iters = self.iters[start:]
        return {**out, "attempted": k,
                "failed": self.converged[start:].count(False),
                "program": {"solves": k, "iters": iters,
                            "spmv_ell_launches": launches,
                            "ell_blocks_per_spmv": 2 * self.conf["nranks"]},
                "config": self.conf, "traffic": self.traffic}

    # ----------------------------------------------------------------- check
    def info(self) -> dict:
        from repro_torch.kernels import tuning
        return {"sf_backends": {"ParCSR.comm": self.A.comm.backend_name},
                "tuner_winners": {repr(k): v for k, v in
                                  tuning.winners().items()},
                "iters_per_solve": sum(self.iters) / max(len(self.iters), 1)}

    def release(self) -> None:
        """Free the program's operator; the solutions stay."""
        del self.A, self.da
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        lim = self.wl["check"]
        worst = max(stencil.rel_residual(
            self.b_nat[i], stencil.to_natural(x, self.grid, self.proc_grid))
            for i, x in sorted(self.x.items()))
        conv = self.converged.count(True) / max(len(self.converged), 1)
        return {"residual": {"value": worst,
                             "limit": lim["true_rel_residual"],
                             "ok": worst <= lim["true_rel_residual"]},
                "converged": {"value": conv, "limit": 1.0,
                              "ok": conv >= 1.0}}


# a fault a later change could make: the solves stopped at a looser
# tolerance than the configuration states
LOOSE_RTOL = 1e-4


def controls(name: str, wl: dict, conf: dict, seeds, n_controls: int, dev,
             emit) -> None:
    """The readings a Poisson cell's limits are set from (``controls.py``),
    one operator for every seed: the program's solves of each seed's
    right-hand sides; on the first ``n_controls`` seeds the program
    stopped at ``LOOSE_RTOL`` and the control, the plain CG put in the
    program's place in bfloat16; on the first seed the plain CG in
    float32 (a witness)."""
    cell = Cell(conf, wl, seeds[0], dev)
    cell.setup()
    for label, rtol, which in (("program", cell.rtol, seeds),
                               ("fault_loose_rtol", LOOSE_RTOL,
                                seeds[:n_controls])):
        cell.rtol = rtol
        for s in which:
            cell.draw(s)
            cell.x.clear()
            cell.iters, cell.converged = [], []
            for n in range(len(cell.b)):
                cell.solve(n)
            chk = cell.check()
            emit(kind=label, workload=name, seed=s, rtol=rtol,
                 residual=chk["residual"]["value"], iters=cell.iters,
                 converged=chk["converged"]["value"])
    cell.release()
    maxiter = int(wl["traffic"]["maxiter"])
    for dtype, label, which in ((torch.bfloat16, "control",
                                 seeds[:n_controls]),
                                (torch.float32, "reference_f32", seeds[:1])):
        for s in which:
            cell.draw(s)
            worst, its = 0.0, []
            for bn in cell.b_nat:
                x, it = stencil.cg(bn, float(conf["rtol"]), maxiter, dtype)
                worst = max(worst, stencil.rel_residual(bn, x))
                its.append(it)
            emit(kind=label, workload=name, seed=s, residual=worst,
                 iters=its, dtype=str(dtype))
