"""The port's spans (``core.sflog.span``) under ``torch.profiler`` on the CPU:
``cg_async`` on a small ``ParCSR`` and a phi3.5-moe-shaped MoE train step at
toy widths, each span present and nested as stated, the SF exchanges as
ranges with the registry off, nothing recorded and nothing read without a
profiler, and ``CGResult.matvecs`` on the eager path.  The graph path's
count is in ``tests/test_torch_on_card.py``."""

import importlib
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import sflog
from repro_torch.meshdist import DMDA
from repro_torch.solvers import cg, cg_async
from repro_torch.sparse import ParCSR
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, TrainState,
                                             make_train_step)

# the module (the package's ``cg`` is the function)
cg_mod = importlib.import_module("repro_torch.solvers.cg")
GRAPH_ITERS = cg_mod.GRAPH_ITERS


@pytest.fixture(scope="module")
def poisson():
    A = ParCSR.from_dmda_stencil(DMDA((8, 8, 8), 8, stencil="star",
                                      periodic=False), device="cpu")
    b = torch.randn(A.shape[0], generator=torch.Generator().manual_seed(0))
    return A, b


@pytest.fixture
def registry_off():
    old = sflog.set_mode("off")
    yield
    sflog.set_mode(old)


def ranges(prof, prefixes=("cg.", "SF", "train.", "optim.", "moe.")):
    """``(name, start_us, end_us)`` of the profile's ranges whose names
    start with one of ``prefixes``."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(prefixes)]


def inside(r, outer):
    """Is range ``r`` within some range of the list ``outer``?"""
    return any(o[1] <= r[1] and r[2] <= o[2] for o in outer)


def named(rs, name):
    return [r for r in rs if r[0] == name]


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, ranges(prof)


# ------------------------------------------------------------------ solver
def test_cg_async_spans_nest(poisson, registry_off):
    A, b = poisson
    res, rs = traced(lambda: cg_async(A, b, tol=1e-5, maxiter=500))
    assert res.converged and res.iters > GRAPH_ITERS
    solve = named(rs, "cg.solve")
    assert len(solve) == 1
    for name in ("cg.prepare", "cg.loop", "cg.result"):
        got = named(rs, name)
        assert len(got) == 1 and inside(got[0], solve), name
    flags = named(rs, "cg.flag")
    # one read before each chunk and one after the last
    assert len(flags) == math.ceil(res.iters / GRAPH_ITERS) + 1
    assert all(inside(f, named(rs, "cg.loop")) for f in flags)
    assert not named(rs, "cg.capture")               # no graph on the CPU


def test_spmv_halo_ranges_with_the_registry_off(poisson, registry_off):
    """Each SpMV is one ``SFBcastBegin`` and one ``SFBcastEnd`` range
    (the End opened by the token's own ``end``), while the registry
    records nothing."""
    A, b = poisson
    assert not sflog.enabled()
    before = sflog.events_snapshot()
    res, rs = traced(lambda: cg_async(A, b, tol=1e-5, maxiter=500))
    begins, ends = named(rs, "SFBcastBegin"), named(rs, "SFBcastEnd")
    assert len(begins) == len(ends) == res.matvecs
    for bg, en in zip(sorted(begins, key=lambda r: r[1]),
                      sorted(ends, key=lambda r: r[1])):
        assert bg[2] <= en[1]                        # begin, then end
    assert all(inside(r, named(rs, "cg.solve")) for r in begins + ends)
    assert sflog.events_snapshot() == before


@pytest.mark.parametrize("op", ["bcast", "reduce", "gather", "scatter",
                                "fetch_and_op", "bcast_split",
                                "reduce_split"])
def test_every_sfcomm_operation_is_a_range(poisson, registry_off, op):
    A, _ = poisson
    comm, sf = A.comm, A.comm.sf
    roots = torch.ones(sf.nroots_total)
    leaves = torch.ones(sf.nleafspace_total)
    run = {"bcast": lambda: comm.bcast(roots, leaves),
           "reduce": lambda: comm.reduce(leaves, roots),
           "gather": lambda: comm.gather(leaves),
           "scatter": lambda: comm.scatter(comm.gather(leaves)),
           "fetch_and_op": lambda: comm.fetch_and_op(roots, leaves),
           "bcast_split": lambda: comm.bcast_end(comm.bcast_begin(roots),
                                                 leaves),
           "reduce_split": lambda: comm.reduce_begin(leaves).end(roots)}[op]
    want = {"bcast": ["SFBcast"], "reduce": ["SFReduce"],
            "gather": ["SFGather"], "scatter": ["SFGather", "SFScatter"],
            "fetch_and_op": ["SFFetchAndOp"],
            "bcast_split": ["SFBcastBegin", "SFBcastEnd"],
            "reduce_split": ["SFReduceBegin", "SFReduceEnd"]}[op]
    _, rs = traced(run)
    assert sorted(r[0] for r in rs) == sorted(want)


def test_fused_and_runtime_routed_exchanges_are_ranges(poisson,
                                                       registry_off):
    from repro_torch.core import DynPlan
    A, _ = poisson
    comm, sf = A.comm, A.comm.sf
    two = [torch.ones(sf.nroots_total), torch.ones(sf.nroots_total, 2)]
    dst = [torch.zeros(sf.nleafspace_total),
           torch.zeros(sf.nleafspace_total, 2)]
    _, rs = traced(lambda: comm.bcast_multi(two, dst))
    assert {r[0] for r in rs} == {"SFBcastMulti"}
    _, rs = traced(lambda: comm.bcast_multi_begin(two).end(dst))
    assert named(rs, "SFBcastMultiBegin") and named(rs, "SFBcastMultiEnd")
    plan = DynPlan(6, 10)
    lr = torch.tensor([0, 1, 2, 3, 4, 5, 6, 0, 1, 2])
    _, rs = traced(lambda: plan.bcast(plan.reduce(torch.ones(10, 3), lr),
                                      lr))
    assert [r[0] for r in sorted(rs, key=lambda r: r[1])] == \
        ["SFDynReduce", "SFDynBcast"]


def test_no_profiler_no_range_no_registry_write(poisson, monkeypatch):
    """Without a profiler a span is the shared no-op: ``record_function``
    is never called, and the registry's events are what they were, with
    the registry off and with it on (where the exchanges' own events are
    the same as under a profiler)."""
    A, b = poisson
    assert sflog.span("cg.solve") is sflog.span("anything") \
        is sflog._NO_SPAN

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a "
                             f"profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    old = sflog.set_mode("off")
    try:
        before = sflog.events_snapshot()
        cg_async(A, b, tol=1e-5, maxiter=500)
        assert sflog.events_snapshot() == before
        sflog.set_mode("on")
        sflog.reset()
        A.spmv(b)
        plain = sflog.events_snapshot()
        monkeypatch.undo()
        sflog.reset()
        traced(lambda: A.spmv(b))
        assert sflog.events_snapshot() == plain
        assert plain["SFBcastBegin"]["count"] == 1
    finally:
        sflog.set_mode(old)
        sflog.reset()


@pytest.mark.parametrize("check_every,maxiter", [(1, 500), (3, 500),
                                                 (0, 25)])
def test_eager_matvecs_count_every_application(poisson, monkeypatch,
                                               check_every, maxiter):
    """On the eager path: the warm-up and first residual, then
    ``GRAPH_ITERS`` a chunk; the registry's ``cg.matvecs`` gains as
    much, ``cg.captures`` and ``cg.replays`` nothing."""
    A, b = poisson
    chunks = []
    real = cg_mod._GuardedLoop.chunk
    monkeypatch.setattr(cg_mod._GuardedLoop, "chunk",
                        lambda self: (chunks.append(1), real(self))[1])
    calls = []
    mv = lambda v: (calls.append(1), A.spmv(v))[1]   # noqa: E731
    c0 = sflog.counters()
    res = cg_async(mv, b, tol=1e-5, maxiter=maxiter, check_every=check_every)
    c1 = sflog.counters()
    assert res.matvecs == 2 + GRAPH_ITERS * len(chunks) == len(calls)
    assert len(chunks) == math.ceil(res.iters / GRAPH_ITERS)
    assert c1["cg.matvecs"] - c0["cg.matvecs"] == res.matvecs
    assert c1["cg.captures"] == c0["cg.captures"]
    assert c1["cg.replays"] == c0["cg.replays"]


def test_converged_start_runs_the_warm_up_and_residual_only(poisson):
    A, b = poisson
    res = cg_async(A, torch.zeros_like(b), tol=1e-6)
    assert res.iters == 0 and res.matvecs == 2


def test_host_cg_counts_its_matvecs(poisson):
    A, b = poisson
    res = cg(A, b, tol=1e-5, maxiter=500)
    assert res.converged and res.matvecs == 1 + res.iters


# ---------------------------------------------------------- training step
def _moe_step(dispatch):
    cfg = get_config("phi3.5-moe-42b-a6.6b").smoke_config().scaled(
        dtype="float32", remat="block", moe_dispatch=dispatch)
    ocfg = OptConfig()
    state = TrainState.create(cfg, ocfg,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    step = make_train_step(cfg, ocfg, TrainConfig())
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 16))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    return lambda: step(state.params, state.opt_state, batch)


@pytest.mark.parametrize("dispatch", ["sf", "dense"])
def test_train_step_spans_nest(registry_off, dispatch):
    (_, _, met), rs = traced(_moe_step(dispatch))
    assert torch.isfinite(met["loss"])
    step = named(rs, "train.step")
    assert len(step) == 1
    fwd, bwd = named(rs, "train.forward"), named(rs, "train.backward")
    opt = named(rs, "optim.update")
    assert len(fwd) == len(bwd) == len(opt) == 1
    assert all(inside(r, step) for r in fwd + bwd + opt)
    assert fwd[0][2] <= bwd[0][1] and bwd[0][2] <= opt[0][1]
    layers = 2                                        # the smoke config's
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        got = named(rs, name)
        in_fwd = [r for r in got if inside(r, fwd)]
        in_bwd = [r for r in got if inside(r, bwd)]
        # once a layer in the forward, again in remat's recompute
        assert len(in_fwd) == len(in_bwd) == layers, name
        assert len(got) == 2 * layers, name
    sf = {"SFDynReduce", "SFDynBcast"} & {r[0] for r in rs}
    assert sf == ({"SFDynReduce", "SFDynBcast"} if dispatch == "sf"
                  else set())
    for r in named(rs, "SFDynReduce"):
        assert inside(r, named(rs, "moe.dispatch"))
    for r in named(rs, "SFDynBcast"):
        assert inside(r, named(rs, "moe.combine"))
