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
device and runs the reference's ``lax.while_loop`` as a loop of guarded
iterations: each takes the reference's loop condition ``it < maxiter and
(rr > tol² · max(b², 1e-30) or it % check_every != 0)`` (``check_every=0``,
the paper's CGAsync, runs to ``maxiter``) on the device and keeps the old
state where it is false, so iterations past the end change nothing and the
count is the reference's.  On a CUDA device ``GRAPH_ITERS`` guarded
iterations are captured once into a CUDA graph over static state buffers
and the graph is replayed until the device flag says the loop is done: the
host reads one flag per replay and issues no kernel.  On the CPU the same
chunks run eagerly.  ``CGResult.matvecs`` counts the operator's
applications wherever they ran: the eager ones, and a captured chunk's
once per replay.

A solve marks its stages as ``core.sflog`` spans (ranges in a
``torch.profiler`` trace, nothing without one): ``cg.solve`` around all of
it, the graph's teardown included; ``cg.prepare``; ``cg.capture`` (the
side-stream warm-up chunk, the capture, the instantiation); ``cg.loop``
(the replays, or the eager chunks) with a ``cg.flag`` around each host
read of the loop's flag; ``cg.result``.  The registry's counters
``cg.captures``, ``cg.replays`` and ``cg.matvecs`` are always live.

Both take an optional preconditioner ``M`` (``z = M(r)``, e.g. the V-cycle
of :class:`repro_torch.solvers.multigrid.Multigrid`) with the reference's
numerics: ``<r, z>`` drives beta and ``<r, r>`` the convergence check; with
``M=None`` the step is the unpreconditioned loop, op for op.  In
``cg_async`` the preconditioner runs inside the captured graph, so it must
read nothing back to the host (its index caches are warmed by the eager
first application before the capture).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core import sflog
from ..kernels import ops as kops

__all__ = ["CGResult", "cg", "cg_async", "as_matvec", "GRAPH_ITERS"]

# guarded iterations per CUDA graph: the host reads the loop's flag once per
# replay, and a converged loop runs at most GRAPH_ITERS - 1 idle iterations
GRAPH_ITERS = 10

_C_CAPTURES = sflog.counter("cg.captures")
_C_REPLAYS = sflog.counter("cg.replays")
_C_MATVECS = sflog.counter("cg.matvecs")


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
    graph_replays: int = 0      # cg_async on a CUDA device
    matvecs: int = 0            # operator applications run on the device


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def _step(matvec, x, r, p, rz, M=None):
    """One (preconditioned) CG iteration.  With ``M=None`` this is the
    paper's unpreconditioned loop (z = r, and <r, r> serves both beta and
    the convergence check); with a preconditioner it returns both
    rz = <r, z> (for beta) and rr = <r, r> (for the check)."""
    Ap = matvec(p)
    alpha = rz / _dot(p, Ap)
    x = x + alpha * p
    r = r - alpha * Ap
    if M is None:
        rr = _dot(r, r)
        return x, r, r + (rr / rz) * p, rr, rr
    z = M(r)
    rz_new = _dot(r, z)
    return x, r, z + (rz_new / rz) * p, rz_new, _dot(r, r)


def _init(matvec, b, x0, M=None):
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    if M is None:
        rr = _dot(r, r)
        return x, r, r, rr, rr
    z = M(r)
    return x, r, z, _dot(r, z), _dot(r, r)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, tol: float = 1e-8, maxiter: int = 500,
       M: Optional[Callable] = None) -> CGResult:
    """Host-stepped CG with a host-side convergence check every iteration
    (the paper's blocking baseline).  ``matvec`` may be a callable or an
    SF-backed operator accepted by :func:`as_matvec`.  ``M`` is an optional
    (left, SPD) preconditioner applied as ``z = M(r)`` — e.g.
    ``cg(A, b, M=mg.vcycle)``.  Convergence is judged on the recursive
    residual norm ||r||."""
    matvec = as_matvec(matvec)
    x, r, p, rz, rr = _init(matvec, b, x0, M)
    bnorm = float(torch.sqrt(_dot(b, b)))
    it = 0
    rnorm = float(torch.sqrt(rr))
    while it < maxiter:
        # host reads the residual -> device/host sync every iteration
        if rnorm <= tol * max(bnorm, 1e-30):
            return CGResult(x, it, rnorm, True, matvecs=1 + it)
        x, r, p, rz, rr = _step(matvec, x, r, p, rz, M)
        rnorm = float(torch.sqrt(rr))   # blocking host readback
        it += 1
    return CGResult(x, it, rnorm, rnorm <= tol * max(bnorm, 1e-30),
                    matvecs=1 + it)


class _Counted:
    """A matvec that counts its applications in ``calls``."""

    __slots__ = ("fn", "calls")

    def __init__(self, fn: Callable):
        self.fn, self.calls = fn, 0

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        return self.fn(v)


class _GuardedLoop:
    """The state of ``cg_async``'s loop in fixed buffers, and a chunk of
    ``GRAPH_ITERS`` guarded iterations that updates them in place and sets
    ``go``, the loop condition after the chunk.  ``matvec`` is a
    :class:`_Counted`, shared with the loop's copies; ``per_replay`` is
    the applications one replay of the loop's captured chunk runs."""

    def __init__(self, matvec: _Counted, x, r, p, rz, rr, tol2,
                 maxiter: int, check_every: int, M=None):
        self.matvec, self.M, self.tol2 = matvec, M, tol2
        self.per_replay = 0
        self.maxiter, self.check_every = maxiter, check_every
        self.x, self.r, self.p = x.clone(), r.clone(), p.clone()
        self.rz, self.rr = rz.clone(), rr.clone()
        self.it = torch.zeros((), dtype=torch.int32, device=x.device)
        self.go = self.cond(self.rr, self.it)

    def copy(self) -> "_GuardedLoop":
        """A loop on copies of this one's state."""
        return _GuardedLoop(self.matvec, self.x, self.r, self.p, self.rz,
                            self.rr, self.tol2, self.maxiter,
                            self.check_every, self.M)

    def cond(self, rr, it):
        """The reference's while-loop condition, on the device."""
        go = it < self.maxiter
        if self.check_every:
            go = go & ((rr > self.tol2) | (it % self.check_every != 0))
        return go

    def chunk(self) -> None:
        x, r, p, rz, rr, it = (self.x, self.r, self.p, self.rz, self.rr,
                               self.it)
        for _ in range(GRAPH_ITERS):
            go = self.cond(rr, it)
            nx, nr, np_, nrz, nrr = _step(self.matvec, x, r, p, rz, self.M)
            # where, not a multiply by the flag: an idle step may hold NaN
            x, r = torch.where(go, nx, x), torch.where(go, nr, r)
            p, rz = torch.where(go, np_, p), torch.where(go, nrz, rz)
            rr = torch.where(go, nrr, rr)
            it = it + go.to(it.dtype)
        for buf, new in ((self.x, x), (self.r, r), (self.p, p),
                         (self.rz, rz), (self.rr, rr), (self.it, it),
                         (self.go, self.cond(rr, it))):
            buf.copy_(new)


def _capture(loop: _GuardedLoop):
    """One chunk of ``loop`` captured into a CUDA graph, and the kernel
    launches the capture recorded (by name, as ``kops.launch_counts``).  A
    capture launches nothing, so what the wrappers counted during it is
    taken back, and so are the matvecs (kept as ``loop.per_replay``);
    :func:`_replay` counts both for every replay."""
    with sflog.span("cg.capture"):
        dev = loop.x.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # warm-up on a side stream, as CUDA-graph capture asks, on
            # copies of the state: lazy library setup happens outside the
            # capture
            loop.copy().chunk()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = kops.launch_counts()
        calls = loop.matvec.calls
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loop.chunk()
        captured = {k: v - before[k] for k, v in kops.launch_counts().items()}
        kops.add_launches(captured, -1)
        loop.per_replay = loop.matvec.calls - calls
        loop.matvec.calls = calls
        _C_CAPTURES.add()
        return graph, captured


def _flag(loop: _GuardedLoop) -> bool:
    """The host's read of the loop's flag, which waits for the device."""
    with sflog.span("cg.flag"):
        return bool(loop.go)


def _replay(loop: _GuardedLoop, graph, captured: dict) -> int:
    """Replay ``graph`` until the loop's flag drops; returns the replays.
    A replay launches every kernel the capture recorded, so the launch
    counters gain the captured launches once per replay, and the loop's
    matvec count its ``per_replay``."""
    replays = 0
    with sflog.span("cg.loop"):
        while True:
            graph.replay()
            replays += 1
            if not _flag(loop):          # the one host read per replay
                break
    kops.add_launches(captured, replays)
    loop.matvec.calls += loop.per_replay * replays
    _C_REPLAYS.add(replays)
    return replays


def cg_async(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *, tol: float = 1e-8,
             maxiter: int = 500, check_every: int = 1,
             M: Optional[Callable] = None) -> CGResult:
    """CG whose scalars stay on the device, the reference's fused loop: the
    convergence flag ``rr > tol² · max(b², 1e-30)`` is observed only at
    iterations that are multiples of ``check_every``, and never when
    ``check_every == 0`` (the paper's CGAsync, which runs to ``maxiter``).
    ``M`` is the optional preconditioner of :func:`cg`, run inside the
    loop.  On a CUDA device the loop runs as a replayed CUDA graph; a
    capture that fails raises."""
    return _cg_async(matvec, b, x0, tol, maxiter, check_every,
                     graph=b.device.type == "cuda", M=M)


def _prepare(matvec, b, x0, tol, maxiter, check_every,
             M=None) -> _GuardedLoop:
    """The loop's start: the warm-up SpMV, the first residual (and its
    preconditioned twin) and the tolerance, all on the device."""
    matvec = _Counted(as_matvec(matvec))
    x = torch.zeros_like(b) if x0 is None else x0
    # one eager application before the loop, as the reference does before
    # tracing: the first SpMV (and the first M) prepares its index caches,
    # which reads the device on the host, and such a read would break a
    # capture
    matvec(x)
    x, r, p, rz, rr = _init(matvec, b, x, M)
    tol2 = torch.as_tensor(tol, dtype=rr.dtype, device=rr.device) ** 2 \
        * torch.clamp(_dot(b, b), min=1e-30)
    return _GuardedLoop(matvec, x, r, p, rz, rr, tol2, maxiter, check_every,
                        M)


def _result(loop: _GuardedLoop, b, tol, replays: int) -> CGResult:
    with sflog.span("cg.result"):
        rnorm = float(torch.sqrt(loop.rr))
        bnorm = float(torch.sqrt(_dot(b, b)))
        _C_MATVECS.add(loop.matvec.calls)
        return CGResult(loop.x.clone(), int(loop.it), rnorm,
                        rnorm <= tol * max(bnorm, 1e-30), replays,
                        loop.matvec.calls)


def _cg_async(matvec, b, x0, tol, maxiter, check_every, *,
              graph: bool, M=None) -> CGResult:
    """:func:`cg_async`, its guarded chunks replayed as a CUDA graph or run
    eagerly (the CPU's way, and the graph's check on the card)."""
    with sflog.span("cg.solve"):
        with sflog.span("cg.prepare"):
            loop = _prepare(matvec, b, x0, tol, maxiter, check_every, M)
        replays = 0
        if graph:
            with sflog.span("cg.loop"):
                go = _flag(loop)
            if go:
                cuda_graph, captured = _capture(loop)
                replays = _replay(loop, cuda_graph, captured)
                del cuda_graph           # its teardown, inside the solve
        else:
            with sflog.span("cg.loop"):
                while _flag(loop):
                    loop.chunk()
        return _result(loop, b, tol, replays)
