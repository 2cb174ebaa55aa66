"""Card twins of the CPU parity tests: the new segment-reduce dtypes
against their plain version, both backends' reduce bit for bit (and from
run to run), the fused multi-field exchange, the DMDA halo against the CPU,
the CUDA-graph ``cg_async`` against the same guarded chunks run eagerly;
and for the composed-SF slice the V-cycle against the CPU, the graph PCG
against its eager chunks, the prolong slot sums repeatable bit for bit,
the edge-element stash assembly, and the ``sflog`` facade hooks during a
capture (``traced`` only, nothing per replay); for the MoE slice every
``DynPlan`` operation against the CPU, the runtime-index gathers on odd
wide rows, an out-of-range ``leaf_root`` failing in a child process, and
the MoE layer's SF dispatch against its plain gathers with no host sync;
for the wide gather (``pack``) the odd-width and misaligned rows of
``chip_smoke.py``'s sweep, ``pack(dynamic=True)`` trapping on an index out
of range, and a decode step's fused dispatch rows against dense; for the
long segment reduce (segments over ``LONG_SEG`` rows) every dtype and op
at the cut and the chunk edges (``chip_smoke.long_case``: short, empty,
overlapping and unsorted segments beside the long ones) and on wide rows,
bitwise with NaN payloads, a segment of 41 chunks, the plan on the card
against the CPU's, and a long-route reduce captured into a CUDA graph;
for the training slice the flash Function's gradients against the plain
version's, row 8's backward kernels against their plain version at every
dtype and head size (one-hot keys, bitwise repeats) and a train step with
the plain attention raising on the card, the column-tiled short segment
reduce bitwise its one-CTA launch and the plain version at a DDP bucket's
shape, the DynPlan
gather's transpose repeatable bit for bit and equal to the CPU's, and the
DDP step bitwise across worlds on the card; for the families' training
hymba's graph-backed scan Function against autograd through the eager
step loop, xlstm's chunk graphs bitwise its eager chunks, the flash
Function at whisper's cross shape against the plain
version, and a hymba smoke train step on the card against the CPU's;
for row 8's forward the split-KV kernels (short queries) and the
head-size-64 wgmma tiles against the plain versions, bitwise repeats, the
LSE, the route at the cut and its launch counts;
for the short segment reduce's vector kernel every dtype and op at 16 B,
48 B, 1 KB and 8 KB rows bitwise the plain fold and the scalar kernel
(NaN payloads, -0 / +0, empty segments, segments up to ``LONG_SEG``), a
misaligned view on the scalar kernel, wide rows beside the long route,
the DDP bucket's shape and a captured replay;
for measured backend selection a card-stamped priors table sending
``SFComm`` to each backend in turn, bitwise the other.

Every test is ``cuda``-marked and skips without a card; the file imports
no JAX, so the card's machine runs it:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_on_card.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import SFComm, StarForest
from repro_torch.kernels import ops as kops, sf_unpack

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

NEW_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.int64,
              torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this slice on "
                    "the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def static_selection(monkeypatch):
    """The static selection rule that the launch checks are written for,
    as ``chip_smoke.py`` runs its paths, whatever ``BENCH_torch_*.json``
    the checkout holds."""
    from repro_torch.core import priors
    monkeypatch.setenv("REPRO_SF_PRIORS", "0")
    priors.invalidate_priors_cache()
    yield
    priors.invalidate_priors_cache()


@pytest.fixture
def fixed_rule(monkeypatch):
    """Every tuned kind on its default, the fixed rule
    (``REPRO_SF_AUTOTUNE=0``), so a launch check names the one kernel that
    rule picks; the winner cache is emptied before and after."""
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "0")
    kops.tuning.clear_cache()
    yield
    kops.tuning.clear_cache()


def _general_sf(nranks=4, per_root=50, per_leaf=150, seed=0):
    """Random general SF: repeated roots, leafless roots, holes."""
    rng = np.random.default_rng(seed)
    sf = StarForest(nranks)
    for q in range(nranks):
        space = per_leaf + per_leaf // 10
        local = rng.permutation(space)[:per_leaf]
        remote = np.stack([rng.integers(0, nranks, per_leaf),
                           rng.integers(0, per_root, per_leaf)], 1)
        sf.set_graph(q, per_root, local, remote, nleafspace=space)
    return sf.setup()


def _values(shape, dtype, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -2 ** 40), min(info.max, 2 ** 40)
    return torch.randint(lo, hi, shape, generator=g, device=dev,
                         dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
@pytest.mark.parametrize("dtype", NEW_DTYPES)
def test_cuda_new_dtype_segment_reduce_matches_plain(dev, dtype, op):
    rng = np.random.default_rng(2)
    lens = rng.integers(0, 9, 300)
    lens[:4] = 0
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    st = torch.as_tensor(starts, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    for unit in [(), (3,)]:
        buf = _values((int(lens.sum()),) + unit, dtype, dev)
        if op == "prod" and dtype.is_floating_point:
            buf = (1 + 0.05 * buf.float()).to(dtype)
        if op in ("max", "min") and dtype.is_floating_point:
            buf[int(starts[10]) + 1] = float("nan")
        want = sf_unpack.segment_reduce_plain(buf, st, ln, op)
        for got in (sf_unpack.segment_reduce_sorted(buf, st, ln, op=op),
                    sf_unpack.segment_reduce_blocked(buf, st, ln,
                                                     segs_per_block=64,
                                                     op=op)):
            assert torch.equal(got.view(torch.uint8),
                               want.view(torch.uint8)), (dtype, op, unit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int8, torch.int64,
                                   torch.uint16, torch.uint32])
def test_cuda_reduce_dtypes_bitwise_and_repeatable(dev, dtype):
    """Every reduce dtype on both backends: bitwise equal to each other and
    from run to run (the global backend reduces floats without atomics)."""
    sf = _general_sf()
    cu = SFComm(sf, backend="cuda", device=dev)
    gl = SFComm(sf, backend="global", device=dev)
    leaf = (torch.rand(sf.nleafspace_total, 2, device=dev) * 100).to(dtype)
    root = (torch.rand(sf.nroots_total, 2, device=dev) * 100).to(dtype)
    for op in ("sum", "max", "min"):
        a = gl.reduce(leaf, root, op).view(torch.uint8)
        assert torch.equal(a, gl.reduce(leaf, root, op).view(torch.uint8))
        assert torch.equal(a, cu.reduce(leaf, root, op).view(torch.uint8))


def test_cuda_bundle_matches_global_bitwise(dev):
    """The fused mixed-dtype bcast (a uint32 and a uint16 carrier) and the
    f32 reduce of the kernel backend equal the global backend's."""
    sf = _general_sf()
    cu = SFComm(sf, backend="cuda", device=dev)
    gl = SFComm(sf, backend="global", device=dev)

    def fields(nrows):
        return [_values((nrows, 3), torch.float32, dev),
                _values((nrows,), torch.int32, dev),
                _values((nrows,), torch.bfloat16, dev),
                _values((nrows,), torch.int16, dev)]
    roots, leaves = fields(sf.nroots_total), fields(sf.nleafspace_total)
    assert cu._bundle(roots).ngroups("replace") == 2
    for a, b in zip(cu.bcast_multi(roots, leaves),
                    gl.bcast_multi(roots, leaves)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    f = [torch.randn(sf.nleafspace_total, 3, device=dev) for _ in range(2)]
    r = [torch.randn(sf.nroots_total, 3, device=dev) for _ in range(2)]
    for a, b in zip(cu.reduce_multi(f, r), gl.reduce_multi(f, r)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("interior", ["connect", "skip"])
def test_cuda_dmda_halo_matches_cpu(dev, interior):
    from repro_torch.meshdist import DMDA
    da = DMDA((12, 10, 9), 8, stencil="box", width=1, periodic=False,
              interior=interior)
    g = torch.randn(da.nglobal, 3)
    lv = torch.randn(da.nlocal_total, 3)
    want = da.global_to_local(g, backend="cuda", device="cpu")
    got = da.global_to_local(g.to(dev), backend="cuda", device=dev)
    assert torch.equal(got.cpu(), want)
    s_gl = da.local_to_global(lv.to(dev), backend="global", device=dev)
    s_cu = da.local_to_global(lv.to(dev), backend="cuda", device=dev)
    assert torch.equal(s_gl, s_cu)
    assert torch.equal(s_cu.cpu(), da.local_to_global(lv, backend="cuda",
                                                      device="cpu"))


@pytest.mark.parametrize("check_every", [0, 1, 3])
def test_cuda_graph_cg_async_equals_eager_chunks(dev, check_every):
    """The replayed graph and the same guarded chunks run eagerly take the
    same iterations to the same x, bit for bit; the launch counters count
    every replay's captured launches."""
    from repro_torch.meshdist import DMDA
    from repro_torch.solvers.cg import GRAPH_ITERS, _cg_async, cg_async
    from repro_torch.sparse import ParCSR
    A = ParCSR.from_dmda_stencil(DMDA((24, 24, 24), 8, stencil="star",
                                      periodic=False), device=dev)
    assert A.comm.backend_name == "cuda"
    b = torch.randn(A.shape[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    mv = lambda v: A.spmv(v, use_kernel=True)   # noqa: E731
    maxiter = 40 if check_every == 0 else 500
    kops.reset_launch_counts()
    got = cg_async(mv, b, tol=1e-5, maxiter=maxiter, check_every=check_every)
    ell = kops.spmv_ell.launches
    want = _cg_async(mv, b, None, 1e-5, maxiter, check_every, graph=False)
    assert got.graph_replays >= 1
    assert got.iters == want.iters
    assert torch.equal(got.x, want.x)
    blocks = len(A._diag_ell) + len(A._offd_ell)
    # warm-up, init, the side-stream warm-up chunk, then every replay
    assert ell == blocks * (2 + GRAPH_ITERS * (1 + got.graph_replays))


def _mg(dev, shape=(17, 17, 9)):
    from repro_torch.meshdist import DMDA
    from repro_torch.solvers import Multigrid
    da = DMDA(shape, 8, stencil="star", periodic=False)
    return da, Multigrid(da, nlevels=3, device=dev)


def test_cuda_vcycle_matches_cpu_and_repeats(dev, fixed_rule):
    """rtol 1e-4, atol 1e-5 x max|v| against the CPU (float32 sums in
    another order); bitwise from run to run on the card; the fixed rule's
    blocked kernels launched."""
    da, mg = _mg(dev)
    _, mg_cpu = _mg("cpu")
    b = torch.randn(da.nglobal, generator=torch.Generator().manual_seed(5))
    kops.reset_launch_counts()
    got = mg.vcycle(b.to(dev))
    counts = kops.launch_counts()
    assert counts["spmv_ell"] and counts["pack_blocked"] \
        and counts["segment_reduce_blocked"], counts
    want = mg_cpu.vcycle(b)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(mg.vcycle(b.to(dev)), got)


def test_cuda_prolong_slot_sums_repeat_bitwise(dev, fixed_rule):
    """The weighted slot sums run through the segment-reduce kernel (no
    float atomics; the blocked one by the fixed rule): the same bits on
    every call, and the CPU's."""
    from repro_torch.meshdist import DMDA
    from repro_torch.solvers import Transfer
    fine = DMDA((33, 17, 17), 8, stencil="star", periodic=False)
    t = Transfer(fine, fine.coarsen(), device=dev)
    t_cpu = Transfer(fine, fine.coarsen(), device="cpu")
    xc = torch.randn(t.ncoarse, 3, generator=torch.Generator().manual_seed(1))
    before = kops.segment_reduce_blocked.launches
    a = t.prolong(xc.to(dev))
    assert kops.segment_reduce_blocked.launches == before + 1
    for _ in range(3):
        assert torch.equal(t.prolong(xc.to(dev)), a)
    assert torch.equal(a.cpu(), t_cpu.prolong(xc))
    assert torch.equal(t.inject(xc.to(dev)).cpu(), t_cpu.inject(xc))


def test_cuda_graph_pcg_equals_eager_chunks(dev):
    """The V-cycle captured inside the graph's chunk: the replayed graph
    and the same guarded chunks run eagerly take the same iterations to the
    same x, bit for bit, at half the iterations of plain CG or fewer."""
    from repro_torch.solvers.cg import _cg_async, cg, cg_async
    da, mg = _mg(dev)
    A = mg.ops[0]
    b = torch.randn(da.nglobal, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    mv = lambda v: A.spmv(v, use_kernel=True)   # noqa: E731
    got = cg_async(mv, b, tol=1e-5, maxiter=200, M=mg.vcycle)
    want = _cg_async(mv, b, None, 1e-5, 200, 1, graph=False, M=mg.vcycle)
    host = cg(mv, b, tol=1e-5, maxiter=200, M=mg.vcycle)
    plain = cg(mv, b, tol=1e-5, maxiter=500)
    assert got.graph_replays >= 1 and got.converged
    assert got.iters == want.iters == host.iters
    assert torch.equal(got.x, want.x)
    assert 2 * got.iters <= plain.iters


def test_cuda_edge_element_assembly_bitwise(dev):
    from repro_torch.meshdist import DMDA
    from repro_torch.sparse import MatAssembler, ParCSR, Sparsity
    da = DMDA((17, 13, 11), 8, stencil="star", periodic=False)
    trips = chip_smoke.edge_element_triplets(da)
    sp = Sparsity(8, da.nglobal, da.nglobal,
                  np.concatenate([t[0] for t in trips]),
                  np.concatenate([t[1] for t in trips]),
                  row_offsets=da.owned_offsets, col_offsets=da.owned_offsets)
    want = ParCSR.from_dmda_stencil(da, device=dev)
    asm = MatAssembler(sp, device=dev)
    for _ in range(2):                   # the second reuses the flush SF
        for q, (r, c, v) in enumerate(trips):
            asm.add_values(q, r, c, v)
        got = asm.assemble()
        for a, b in zip(got.diag + got.offd, want.diag + want.offd):
            assert np.array_equal(a.indptr, b.indptr)
            assert np.array_equal(a.indices, b.indices)
            assert np.array_equal(a.data, b.data)
        for a, b in zip(got._diag_ell + got._offd_ell,
                        want._diag_ell + want._offd_ell):
            assert torch.equal(a.data, b.data)


def test_cuda_facade_hooks_under_capture_count_traced_only(dev):
    """While a CUDA graph is captured the hooks bump ``traced`` only (and
    read, fence and allocate nothing on the host); replays record
    nothing."""
    from repro_torch.core import sflog
    sf = _general_sf()
    comm = SFComm(sf, backend="cuda", device=dev)
    roots = torch.randn(sf.nroots_total, device=dev)
    leaves = torch.zeros(sf.nleafspace_total, device=dev)
    old = sflog.set_mode("fence")
    try:
        def body():
            pend = comm.bcast_begin(roots)
            out = pend.end(leaves)
            return comm.reduce(out, roots)
        body()                                         # warm the caches
        sflog.reset()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph):
                out = body()
        torch.cuda.current_stream(dev).wait_stream(side)
        snap = sflog.events_snapshot()
        assert snap == {
            "SFBcastBegin": {"count": 0, "traced": 1, "bytes": 0.0},
            "SFBcastEnd": {"count": 0, "traced": 1, "bytes": 0.0},
            "SFReduce": {"count": 0, "traced": 1, "bytes": 0.0}}, snap
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize(dev)
        assert sflog.events_snapshot() == snap
        assert torch.equal(out, body())
    finally:
        sflog.set_mode(old)
        sflog.reset()


def test_cuda_graph_cg_async_counts_replayed_matvecs(dev):
    """A graph solve's ``matvecs``: the warm-up and first residual, the
    side-stream warm-up chunk, then a captured chunk's ``GRAPH_ITERS``
    once per replay (the registry's counters gain as much); its x is the
    eager chunks' bit for bit.  Under a profiler the capture is a range
    inside the solve and each replay's flag read one inside the loop."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import sflog
    from repro_torch.meshdist import DMDA
    from repro_torch.solvers.cg import GRAPH_ITERS, _cg_async, cg_async
    from repro_torch.sparse import ParCSR
    A = ParCSR.from_dmda_stencil(DMDA((24, 24, 24), 8, stencil="star",
                                      periodic=False), device=dev)
    b = torch.randn(A.shape[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    mv = lambda v: A.spmv(v, use_kernel=True)   # noqa: E731
    c0 = sflog.counters()
    got = cg_async(mv, b, tol=1e-5, maxiter=500)
    c1 = sflog.counters()
    want = _cg_async(mv, b, None, 1e-5, 500, 1, graph=False)
    assert got.graph_replays >= 1
    assert got.matvecs == 2 + GRAPH_ITERS + GRAPH_ITERS * got.graph_replays
    assert got.matvecs == want.matvecs + GRAPH_ITERS
    assert got.iters == want.iters and torch.equal(got.x, want.x)
    assert c1["cg.captures"] - c0["cg.captures"] == 1
    assert c1["cg.replays"] - c0["cg.replays"] == got.graph_replays
    assert c1["cg.matvecs"] - c0["cg.matvecs"] == got.matvecs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = cg_async(mv, b, tol=1e-5, maxiter=500)
        torch.cuda.synchronize(dev)
    assert torch.equal(again.x, got.x)
    rs = {}
    for e in prof.events():
        # the host's ranges (the trace also holds each range's span on
        # every stream it launched on)
        if e.name.startswith("cg.") and \
                e.device_type == torch.autograd.DeviceType.CPU:
            rs.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    within = lambda r, outer: any(a <= r[0] and r[1] <= z    # noqa: E731
                                  for a, z in rs[outer])
    assert len(rs["cg.solve"]) == len(rs["cg.capture"]) == 1
    assert within(rs["cg.capture"][0], "cg.solve")
    assert len(rs["cg.flag"]) == again.graph_replays + 1
    assert all(within(f, "cg.loop") for f in rs["cg.flag"])


# ------------------------------------------------------ runtime-routed SFs
def _dyn_case(dev, nroots=300, nleaves=1000, unit=(8,), seed=3):
    rng = np.random.default_rng(seed)
    lr = rng.integers(0, nroots, nleaves)
    lr[rng.random(nleaves) < 0.1] = nroots
    lru = np.minimum(rng.permutation(nleaves), nroots)
    leaf = rng.standard_normal((nleaves,) + unit).astype(np.float32)
    root = rng.standard_normal((nroots,) + unit).astype(np.float32)
    return lr, lru, leaf, root


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dynplan_card_equals_cpu(dev, dtype):
    """Every DynPlan operation on the card (the gather and segment-reduce
    kernels, runtime-index route) equals the same on the CPU (the plain
    versions) bit for bit, and the general reduce equals the card's
    SFComm on the routing's SF."""
    from repro_torch.core import DynPlan, star_forest_from_assignment
    lr, lru, leaf, root = _dyn_case(dev)
    nroots, nleaves = root.shape[0], leaf.shape[0]
    plan = DynPlan(nroots, nleaves)
    on = {d: (torch.as_tensor(lr, device=d), torch.as_tensor(lru, device=d),
              torch.as_tensor(leaf, device=d).to(dtype),
              torch.as_tensor(root, device=d).to(dtype))
          for d in (torch.device("cpu"), dev)}

    def ops(a, au, lf, rt):
        return [plan.bcast(rt, a), plan.bcast(rt, a, lf),
                plan.reduce(lf, au, unique=True),
                plan.reduce(lf, au, rt, unique=True),
                plan.reduce(lf[:nleaves // 4], au, unique=True, leaf_rep=4),
                plan.reduce(lf, a, rt, op="sum"),
                plan.reduce(lf, a, rt, op="max")]
    for got, want in zip(ops(*on[dev]), ops(*on[torch.device("cpu")])):
        assert torch.equal(got.cpu(), want)
    comm = SFComm(star_forest_from_assignment(lr, nroots), backend="cuda",
                  device=dev)
    a, _, lf, rt = on[dev]
    assert torch.equal(plan.reduce(lf, a, rt), comm.reduce(lf, rt))


def test_dynamic_gathers_take_odd_wide_rows(dev):
    """The MoE rows on the runtime-index route: 8,192- and 8,194-byte bf16
    rows (the decode's fused hidden state + gate weight), int64 and int32
    indices, a source off the 16-byte alignment."""
    from repro_torch.kernels import sf_pack
    g = torch.Generator(device=dev).manual_seed(0)
    for width in (4096, 4097):
        data = torch.randn(41, width, generator=g, device=dev).bfloat16()
        for idx in (torch.randint(0, 41, (33,), generator=g, device=dev),
                    torch.randint(0, 40, (16,), generator=g, device=dev,
                                  dtype=torch.int32)):
            for src in (data, data[1:]):
                i = idx.clamp(max=src.shape[0] - 1)
                before = sf_pack.pack.launches
                got = kops.pack_rows(src, i, dynamic=True)
                assert sf_pack.pack.launches == before + 1
                assert torch.equal(got, src[i.long()])


@pytest.mark.parametrize("row_bytes", [256, 258, 1020, 1024, 1030, 8192,
                                       8194, 14338, 16388])
def test_wide_pack_odd_and_misaligned_rows_bitwise(dev, row_bytes):
    """``pack``'s wide gather over ``chip_smoke.py``'s sweep at one row
    width: int8 / bool / bf16 / f32 / f64 where the element divides it,
    sources 0-8 bytes off the 16-byte alignment, an output off it, 1-4,097
    rows, checked and unchecked, each bitwise against ``pack_plain``."""
    before = kops.pack.launches
    cases = chip_smoke.pack_sweep_width(row_bytes, dev,
                                        np.random.default_rng(row_bytes))
    assert cases >= 3 * len(chip_smoke.PACK_SWEEP_ROWS)
    assert kops.pack.launches - before >= cases // 2


@pytest.mark.parametrize("route", ["bcast", "bcast_wide", "unique",
                                   "general", "pack_odd"])
def test_out_of_range_leaf_root_fails_on_card(dev, route):
    """An index outside the source fails loudly on the card: the gather
    kernel traps, ``scatter_`` / ``_assert_async`` assert.  Each ends the
    CUDA context, so each runs in a child process."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py"), "--out-of-range",
         route, "cuda"], capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "went through" not in proc.stdout


@pytest.mark.parametrize("shape", [(8, 1), (1, 300)])
def test_moe_layer_kernels_equal_plain_without_host_sync(dev, shape):
    """phi3.5-moe's layer at a narrow width: the SF dispatch on the
    kernels bitwise against its plain gathers and within the reference's
    tolerance of the dense dispatch, run under
    ``set_sync_debug_mode("error")`` (no host read on either lowering)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("phi3.5-moe-42b-a6.6b").scaled(
        dtype="float32", d_model=256, moe_dff=128)
    g = torch.Generator(device=dev).manual_seed(4)
    p = {k: v[0] for k, v in M.init_moe(cfg, 1, generator=g,
                                        device=dev).items()}
    x = torch.randn(shape + (cfg.d_model,), generator=g, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = M.moe_layer(x, p, cfg, dispatch="sf")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with chip_smoke.plain_kernels():
        y_plain, _ = M.moe_layer(x, p, cfg, dispatch="sf")
    assert torch.equal(y, y_plain)
    y_d, aux_d = M.moe_layer(x, p, cfg, dispatch="dense")
    torch.testing.assert_close(y, y_d, rtol=1e-5, atol=1e-6)
    assert float(aux) == float(aux_d)


@pytest.mark.parametrize("d_model", [256, 1024])
def test_moe_decode_fused_rows_take_wide_gather(dev, d_model):
    """A decode step's fused dispatch rows (d_model + 1 float32: 4 bytes
    past a 16-byte multiple) go through ``pack``'s wide gather, and the SF
    dispatch stays within the reference's rtol 1e-5 / atol 1e-6 of the
    dense one."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("phi3.5-moe-42b-a6.6b").scaled(
        dtype="float32", d_model=d_model, moe_dff=128)
    g = torch.Generator(device=dev).manual_seed(5)
    p = {k: v[0] for k, v in M.init_moe(cfg, 1, generator=g,
                                        device=dev).items()}
    x = torch.randn((8, 1, cfg.d_model), generator=g, device=dev)
    before = kops.pack.launches
    y, _ = M.moe_layer(x, p, cfg, dispatch="sf")
    assert kops.pack.launches > before
    y_d, _ = M.moe_layer(x, p, cfg, dispatch="dense")
    torch.testing.assert_close(y, y_d, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ long segments
SEG_OPS = ["sum", "prod", "max", "min"]
SEG_DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.float16,
              torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64]


def _raw(t):
    if not t.dtype.is_floating_point:
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("op", SEG_OPS)
@pytest.mark.parametrize("dtype", SEG_DTYPES, ids=lambda d: str(d)[6:])
def test_long_segments_every_dtype_op_bitwise(dev, dtype, op):
    """Segments at the cut, one over it, C - 1, C and C + 1 rows beside
    short, empty, overlapping and unsorted ones, units (), (3,), (2, 2) and
    256-element rows (300 for the ordered route's unit tiles) through both
    wrappers: bitwise equal to the plain fold, NaN payloads included."""
    rng = np.random.default_rng(20)
    name = str(dtype)[6:]
    buf, st, ln = chip_smoke.long_case(name, op, rng, dev)
    assert sf_unpack.reduce_route(int(ln.max()), dtype, op) != "short"
    want = sf_unpack.segment_reduce_plain(buf, st, ln, op)
    for unit, b, w in (((), buf[:, 0].contiguous(), want[:, 0]),
                       ((3,), buf[:, :3].contiguous(), want[:, :3]),
                       ((2, 2), buf.reshape(-1, 2, 2),
                        want.reshape(-1, 2, 2))):
        for got in (sf_unpack.segment_reduce_sorted(b, st, ln, op=op),
                    sf_unpack.segment_reduce_blocked(b, st, ln,
                                                     segs_per_block=64,
                                                     op=op)):
            assert torch.equal(_raw(got), _raw(w)), unit
    widths = (256,) if sf_unpack.order_free(dtype, op) else (256, 300)
    for width in widths:
        buf, st, ln = chip_smoke.long_case(name, op, rng, dev, width=width)
        got = sf_unpack.segment_reduce_sorted(buf, st, ln, op=op)
        want = sf_unpack.segment_reduce_plain(buf, st, ln, op)
        assert torch.equal(_raw(got), _raw(want)), width


def test_long_segment_of_many_chunks(dev):
    """One segment of 41 chunks (more than a warp's lanes, so a lane folds
    a run of several partials) from a misaligned start: sums against its
    length, max / min against numpy, an int64 product of +-1 against the
    count of -1s."""
    n = 40 * sf_unpack.LONG_CHUNK_ROWS + 3
    st = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    ln = torch.tensor([0, n], dtype=torch.int32, device=dev)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n + 1).astype(np.float32)
    xs = torch.as_tensor(x, device=dev)
    for op, want in (("max", x[1:].max()), ("min", x[1:].min())):
        got = sf_unpack.segment_reduce_blocked(xs, st, ln, segs_per_block=64,
                                               op=op)
        assert got[1].item() == want
    for dt in (torch.int32, torch.float32):
        got = sf_unpack.segment_reduce_blocked(
            torch.ones(n + 1, dtype=dt, device=dev), st, ln,
            segs_per_block=64, op="sum")
        assert int(got[1].item()) == n and got[0].item() == 0
    signs = rng.choice([-1, 1], n + 1)
    got = sf_unpack.segment_reduce_blocked(
        torch.as_tensor(signs, device=dev), st, ln, segs_per_block=64,
        op="prod")
    assert got[1].item() == (-1) ** int((signs[1:] < 0).sum())


def test_long_plan_on_card_equals_cpu(dev):
    """The chunks depend on the (start, len) values alone, not the device."""
    rng = np.random.default_rng(4)
    lens = rng.integers(0, 3 * sf_unpack.LONG_CHUNK_ROWS, 200)
    starts = rng.integers(0, 1 << 20, 200)
    cpu = sf_unpack.long_plan(starts, lens, torch.device("cpu"))
    st, ln = (torch.as_tensor(a, device=dev) for a in (starts, lens))
    card = sf_unpack.long_plan(st, ln, st.device)
    assert card.seg.device.type == "cuda"
    np.testing.assert_array_equal(card.chunks(), cpu.chunks())


@pytest.mark.parametrize("dtype,op", [(torch.int32, "sum"),
                                      (torch.float32, "max"),
                                      (torch.float32, "sum")])
def test_long_route_replays_in_a_cuda_graph(dev, dtype, op):
    """After ``prepare`` a long-route reduce reads nothing back, so it can
    be captured; its replays equal the eager call."""
    buf, st, ln = chip_smoke.long_case(str(dtype)[6:], op,
                                       np.random.default_rng(6), dev)
    buf = buf[:, 0].contiguous()
    sf_unpack.prepare(st, ln, st.device)
    want = sf_unpack.segment_reduce_blocked(buf, st, ln, segs_per_block=64,
                                            op=op)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        sf_unpack.segment_reduce_blocked(buf, st, ln, segs_per_block=64,
                                         op=op)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = sf_unpack.segment_reduce_blocked(buf, st, ln,
                                               segs_per_block=64, op=op)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_raw(got), _raw(want))


# ------------------------------------------- the short route's vector kernel
SHORT_LENGTHS = (0, 1, 2, 7, 8, 9, 15, 16, 17, 0, 3, sf_unpack.LONG_SEG - 1,
                 sf_unpack.LONG_SEG, 0, 5)


def _short_case(dtype, op: str, row_bytes: int, rng, dev):
    """``(buf, st, ln)``: rows of ``row_bytes`` bytes of ``dtype`` in
    segments of every length around the vector kernel's batches of
    ``SHORT_ROWS`` up to ``LONG_SEG``, empty ones among them, sorted, with
    an unsorted and overlapping tail; float max / min get NaNs with
    distinct payloads (one in an empty segment's neighbour, two in one
    segment) and a segment whose extremum 0 is reached by -0 and +0 in
    turn; integers span their whole range (odd for prod)."""
    U = row_bytes // torch.tensor([], dtype=dtype).element_size()
    ln = np.array(SHORT_LENGTHS + tuple(rng.integers(0, 12, 20)))
    st = np.concatenate([[0], np.cumsum(ln)[:-1]])
    M = int(ln.sum())
    st = np.concatenate([st, rng.integers(0, M - 20, 6)])
    ln = np.concatenate([ln, rng.integers(0, 20, 6)])
    if dtype.is_floating_point:
        vals = rng.standard_normal((M, U))
        if op == "prod":
            vals = 1 + 0.01 * vals
        if op in ("max", "min"):
            zs = slice(int(st[4]), int(st[4] + ln[4]))     # 8 rows
            sign = -1 if op == "max" else 1
            vals[zs] = sign * (np.abs(vals[zs]) + 1)
            vals[zs.start + 2] = -0.0
            vals[zs.start + 5] = 0.0
        buf = torch.as_tensor(vals, device=dev).to(dtype)
        if op in ("max", "min"):
            iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                buf.element_size()]
            rows = (int(st[5]) + 1, int(st[5]) + 6, int(st[12]) + 100)
            for row, bits in zip(rows, chip_smoke.NAN_BITS[str(dtype)[6:]]):
                buf.view(iv)[row, row % U] = chip_smoke._signed(
                    bits, buf.element_size())
            buf.view(iv)[int(st[5]) + 6, (int(st[5]) + 1) % U] = \
                chip_smoke._signed(chip_smoke.NAN_BITS[str(dtype)[6:]][1],
                                   buf.element_size())
    else:
        info = torch.iinfo(dtype)
        vals = rng.integers(info.min, info.max, (M, U), endpoint=True)
        if op == "prod":
            vals |= 1
        buf = torch.as_tensor(vals, device=dev).to(dtype)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    return buf, i32(st), i32(ln)


@pytest.mark.parametrize("row_bytes", [16, 48, 1024, 8192])
@pytest.mark.parametrize("op", SEG_OPS)
@pytest.mark.parametrize("dtype", SEG_DTYPES, ids=lambda d: str(d)[6:])
def test_vector_route_every_dtype_op_bitwise(dev, dtype, op, row_bytes):
    """Rows of 16 B, 48 B, 1 KB and 8 KB take the vector kernel through
    both wrappers (one and 64 segments a CTA) and equal the plain fold and
    the scalar kernel (``short_variant(route="scalar")``) bit for bit: NaN
    payloads, -0 / +0, wrapped integers, empty segments and segments up to
    LONG_SEG."""
    rng = np.random.default_rng(row_bytes + 7)
    buf, st, ln = _short_case(dtype, op, row_bytes, rng, dev)
    out = torch.empty((st.numel(),) + tuple(buf.shape[1:]), dtype=dtype,
                      device=dev)
    assert sf_unpack.plan_of(buf, out, 1).route == "vector"
    want = sf_unpack.segment_reduce_plain(buf, st, ln, op)
    scalar = sf_unpack.short_variant(buf, st, ln, segs_per_block=1,
                                     route="scalar", op=op)
    assert torch.equal(_raw(scalar), _raw(want))
    for got in (sf_unpack.segment_reduce_sorted(buf, st, ln, op=op),
                sf_unpack.segment_reduce_blocked(buf, st, ln,
                                                 segs_per_block=64, op=op),
                sf_unpack.short_variant(buf, st, ln, segs_per_block=3,
                                        route="vector", op=op)):
        assert torch.equal(_raw(got), _raw(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_misaligned_view_takes_the_scalar_route(dev, dtype):
    """A buffer one element off a 16-byte boundary (a view into a flat
    tensor) keeps the scalar kernel; forcing the vector route raises; the
    result is the plain fold's bits, and the aligned copy's through the
    vector kernel."""
    rng = np.random.default_rng(2)
    buf, st, ln = _short_case(dtype, "sum", 1024, rng, dev)
    flat = torch.empty(buf.numel() + 1, dtype=dtype, device=dev)
    view = flat[1:].view(buf.shape)
    view.copy_(buf)
    out = torch.empty((st.numel(),) + tuple(buf.shape[1:]), dtype=dtype,
                      device=dev)
    assert sf_unpack.plan_of(view, out, 1).route == "scalar"
    with pytest.raises(ValueError, match="vector route"):
        sf_unpack.short_variant(view, st, ln, segs_per_block=1,
                                route="vector")
    want = sf_unpack.segment_reduce_plain(buf, st, ln, "sum")
    assert torch.equal(_raw(sf_unpack.segment_reduce_sorted(view, st, ln)),
                       _raw(want))
    assert torch.equal(_raw(sf_unpack.segment_reduce_sorted(buf, st, ln)),
                       _raw(want))


def test_vector_route_beside_the_long_route(dev):
    """Wide aligned rows with segments over LONG_SEG: the vector kernel
    skips them and the long route writes them in the same call (and so
    beside the scalar kernel, forced)."""
    rng = np.random.default_rng(4)
    ln = np.array([3, sf_unpack.LONG_SEG + 1, 0, 600, 9])
    st = torch.as_tensor(np.concatenate([[0], np.cumsum(ln)[:-1]]),
                         dtype=torch.int32, device=dev)
    ln = torch.as_tensor(ln, dtype=torch.int32, device=dev)
    for dtype, op in ((torch.float32, "sum"), (torch.bfloat16, "max"),
                      (torch.int32, "prod")):
        buf = torch.as_tensor(rng.integers(-3, 4, (int(ln.sum()), 256)),
                              device=dev).to(dtype)
        want = sf_unpack.segment_reduce_plain(buf, st, ln, op)
        got = sf_unpack.segment_reduce_sorted(buf, st, ln, op=op)
        assert torch.equal(_raw(got), _raw(want)), (dtype, op)
        got = sf_unpack.short_variant(buf, st, ln, segs_per_block=1,
                                      route="scalar", op=op)
        assert torch.equal(_raw(got), _raw(want)), (dtype, op)


def test_vector_route_ddp_bucket(dev):
    """The DDP bucket's shape, one segment of 4 grains x 10,485,760 bf16:
    the vector kernel equals the plain fold and the column-tiled scalar
    kernel bit for bit."""
    buf = torch.randn(4, 10_485_760, device=dev).to(torch.bfloat16)
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    ln = torch.full((1,), 4, dtype=torch.int32, device=dev)
    out = torch.empty((1, buf.shape[1]), dtype=buf.dtype, device=dev)
    plan = sf_unpack.plan_of(buf, out, 1)
    assert plan.route == "vector" and plan.chunks > 1000
    want = sf_unpack.segment_reduce_plain(buf, st, ln, "sum")
    assert torch.equal(_raw(sf_unpack.segment_reduce_sorted(buf, st, ln)),
                       _raw(want))
    assert torch.equal(_raw(sf_unpack.short_variant(
        buf, st, ln, segs_per_block=1, route="scalar")), _raw(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_route_replays_in_a_cuda_graph(dev, dtype):
    """A vector-route reduce captured into a CUDA graph: its replays equal
    the eager call."""
    buf, st, ln = _short_case(dtype, "sum", 1024,
                              np.random.default_rng(8), dev)
    sf_unpack.prepare(st, ln, st.device)
    want = sf_unpack.segment_reduce_sorted(buf, st, ln)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        sf_unpack.segment_reduce_sorted(buf, st, ln)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = sf_unpack.segment_reduce_sorted(buf, st, ln)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_raw(got), _raw(want))


# --------------------------------------------- the distributed backend
@pytest.mark.parametrize("low", ["auto", "general"])
def test_cuda_dist_world1_nccl_is_the_cuda_backends_bits(dev, low,
                                                        fixed_rule):
    """``DistSF`` and ``SFComm(backend="dist")`` on an NCCL group of one
    rank against ``"cuda"`` bit for bit (a 12^3 column-gather SF; units ()
    and (3,), every op, fetch-and-add), the reduce through the hand
    kernels (the blocked segment reduce, by the fixed rule)."""
    from repro_torch.core import DistSF
    sf, _ = chip_smoke.column_gather_sf(12)
    n, E = sf.nroots_total, sf.nleafspace_total
    cu = SFComm(sf, backend="cuda", device=dev)
    with chip_smoke.world1_group(dev) as group:
        comm = SFComm(sf, backend="dist", device=dev, group=group,
                      lowering=low)
        sfo = comm.backend.dist
        assert sfo.lowering == ("local_only" if low == "auto" else "general")
        for unit in [(), (3,)]:
            root = _values((n,) + unit, torch.float32, dev, seed=3)
            leaf = _values((E,) + unit, torch.float32, dev, seed=4)
            rs = chip_smoke.padded(root, sfo.plan.root_pad)
            ls = chip_smoke.padded(leaf, sfo.plan.leaf_pad)
            for kind, op in chip_smoke.DIST_OPS:
                want = chip_smoke.dist_op(cu, kind, op, root, leaf)
                kops.reset_launch_counts()
                got = chip_smoke.dist_op(comm, kind, op, root, leaf)
                if kind == "reduce" and op != "replace":
                    assert kops.segment_reduce_blocked.launches == 1
                assert chip_smoke.same_bits(got, want), (unit, kind, op)
                assert chip_smoke.same_bits(
                    chip_smoke.dist_op(sfo, kind, op, rs, ls), want)
        ri = _values((n,), torch.int32, dev, seed=5) % 100
        li = _values((E,), torch.int32, dev, seed=6) % 100
        for a, b in zip(comm.fetch_and_op(ri, li), cu.fetch_and_op(ri, li)):
            assert torch.equal(a, b)
        plain = DistSF(sf, group=group, device=dev, lowering=low,
                       use_kernels=False)
        root = _values((n,), torch.float32, dev, seed=7)
        leaf = _values((E,), torch.float32, dev, seed=8)
        rs = chip_smoke.padded(root, plain.plan.root_pad)
        ls = chip_smoke.padded(leaf, plain.plan.leaf_pad)
        for kind, op in chip_smoke.DIST_OPS:
            assert chip_smoke.same_bits(
                chip_smoke.dist_op(plain, kind, op, rs, ls),
                chip_smoke.dist_op(cu, kind, op, root, leaf))


def test_cuda_dist_refuses_a_group_that_cannot_carry_the_card(dev, tmp_path):
    """A gloo group with CUDA shards raises, naming the mismatch; nothing
    is moved to the CPU."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.core import DistSF
    sf, _ = chip_smoke.column_gather_sf(4)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="gloo process group does not "
                                             "carry cuda tensors"):
            DistSF(sf, device=dev)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ training slice
@pytest.mark.parametrize("S,H,Hkv,D,window", [(256, 8, 2, 128, None),
                                              (300, 5, 1, 64, 100),
                                              (130, 4, 4, 32, None)])
def test_flash_function_gradients_equal_plain(dev, S, H, Hkv, D, window):
    """The Function's gradients (forward kernel, then the backward kernels,
    launched once) within FLASH_BWD_REL of the plain backward and of
    autograd through the plain version."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(S, h, D, generator=g, device=dev).bfloat16()
               .requires_grad_() for h in (H, Hkv, Hkv))
    go = torch.randn(S, H, D, generator=g, device=dev).bfloat16()
    before = fa.flash_attention.launches
    y = kops.flash_attention(q, k, v, causal=True, window=window)
    assert fa.flash_attention.launches == before + 1
    before = fa.flash_attention_backward.launches
    got = torch.autograd.grad(y, (q, k, v), go)
    assert fa.flash_attention_backward.launches == before + 1
    plain = fa.flash_attention_backward_plain(
        q.detach(), k.detach(), v.detach(), y.detach(), go, causal=True,
        window=window)
    auto = torch.autograd.grad(fa.flash_attention_plain(
        q, k, v, causal=True, window=window), (q, k, v), go)
    for a, b, c in zip(got, plain, auto):
        assert a.is_contiguous() and a.dtype == torch.bfloat16
        assert chip_smoke.grad_rel(a, b) <= chip_smoke.FLASH_BWD_REL
        assert chip_smoke.grad_rel(a, c) <= chip_smoke.FLASH_BWD_REL
    with pytest.raises(RuntimeError, match="require grad"):
        fa.flash_attention(q, k, v)


BWD_CASES = [  # B, Sq, Skv, H, Hkv, causal, window
    (1, 300, 300, 8, 2, True, None), (2, 100, 333, 4, 4, True, None),
    (1, 130, 70, 4, 1, True, None), (1, 200, 200, 6, 3, True, 50),
    (2, 77, 150, 4, 2, False, None), (1, 64, 129, 2, 1, False, 40)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("case", BWD_CASES)
def test_cuda_flash_backward_matches_plain(dev, case, D, dtype):
    """Both backward kernels against flash_attention_backward_plain at
    every dtype and head size (FLASH_BWD_REL for bf16, FLASH_BWD_F32_REL
    for float32), rows that see no key giving 0, and a second call bitwise
    the first."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hkv, causal, window = case
    rng = np.random.default_rng(Sq + Skv + D)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev,
                               dtype=torch.float32).to(dtype)
    q, k, v = rand(B, Sq, H, D), rand(B, Skv, Hkv, D), rand(B, Skv, Hkv, D)
    do = rand(B, Sq, H, D)
    kw = dict(causal=causal, window=window)
    o = fa.flash_attention(q, k, v, **kw)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, o, do, **kw)
    again = fa.flash_attention_backward(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == before + 2
    want = fa.flash_attention_backward_plain(q, k, v, o, do, **kw)
    tol = chip_smoke.FLASH_BWD_REL if dtype == torch.bfloat16 \
        else chip_smoke.FLASH_BWD_F32_REL
    for name, a, b, c in zip("qkv", got, want, again):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert chip_smoke.grad_rel(a, b) <= tol, (name,
                                                  chip_smoke.grad_rel(a, b))
        assert chip_smoke.same_raw_bits(a, c), name
    if causal and Sq > Skv:
        assert bool((got[0][:, : Sq - Skv] == 0).all())


def test_cuda_flash_backward_one_hot_keys(dev):
    """Each row puts all its weight on one key (a logit of 64 against 0 or
    -64 at scale 1): P is one-hot, so dv[j] is the sum of dO over the rows
    that chose key j and dq, dk vanish.  A P or dS fragment that reached
    the wrong row or key shows at once."""
    from repro_torch.kernels import flash_attention as fa
    D, Skv, Sq = 64, 128, 200
    rng = np.random.default_rng(5)
    pi = rng.integers(0, Skv, Sq)
    k = np.zeros((Skv, 1, D), np.float32)
    k[np.arange(Skv), 0, np.arange(Skv) % D] = np.where(
        np.arange(Skv) < D, 8.0, -8.0)
    q = np.zeros((Sq, 1, D), np.float32)
    q[np.arange(Sq), 0, pi % D] = np.where(pi < D, 8.0, -8.0)
    v = rng.standard_normal((Skv, 1, D)).astype(np.float32)
    do = rng.standard_normal((Sq, 1, D)).astype(np.float32)
    tq, tk, tv, tdo = (torch.as_tensor(a, device=dev).bfloat16()
                       for a in (q, k, v, do))
    o = fa.flash_attention(tq, tk, tv, causal=False, scale=1.0)
    dq, dk, dv = fa.flash_attention_backward(tq, tk, tv, o, tdo,
                                             causal=False, scale=1.0)
    want_dv = np.zeros((Skv, 1, D), np.float32)
    np.add.at(want_dv, pi, tdo.float().cpu().numpy())
    assert np.allclose(dv.float().cpu().numpy(), want_dv, rtol=2e-2,
                       atol=2e-2)
    assert float(dq.float().abs().max()) < 1e-2
    assert float(dk.float().abs().max()) < 1e-2


# ---------------------------------------- row 8's forward: split KV, D = 64
SPLIT_CARD_CASES = [  # B, Sq, Skv, H, Hkv, D, causal, window
    (8, 1, 1500, 8, 8, 64, False, None),    # whisper's cross at decode
    (8, 4, 1500, 8, 8, 64, False, None),    # at its 4-token prefill
    (1, 1, 4096, 32, 8, 128, True, None),   # GQA decode over 4,096 keys
    (2, 4, 1500, 8, 2, 128, True, 300),     # 16 rows, causal and window
    (1, 8, 1500, 4, 1, 64, False, None),    # 32 rows: 4 m16 tiles, 2 idle
    (1, 16, 1500, 32, 8, 128, False, None),  # 64 rows: four
    (1, 40, 300, 8, 2, 64, True, 100),      # 160 rows: three row blocks
    (1, 4, 2, 8, 2, 64, True, None),        # rows 0, 1 see no key
    (2, 2, 1500, 4, 4, 64, True, 0),        # no row sees a key
]


@pytest.mark.parametrize("case", SPLIT_CARD_CASES)
def test_cuda_flash_split_kernels_match_plain(dev, case):
    """The split-KV kernel and its combine (``launch_kernel(SPLIT)``)
    against the plain version and against the plain split-and-combine
    version within FLASH_TOL, two calls bitwise, o bitwise with and
    without the LSE, the LSE within FLASH_LSE_ATOL of the plain one (-inf
    exactly where a row sees no key, whose o is 0), one count a call."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hkv, D, causal, window = case
    g = torch.Generator(device=dev).manual_seed(13 * Sq + Skv + D)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    before = (fa.flash_attention.launches, fa.flash_attention.launches_sm90,
              fa.flash_attention.launches_split)
    got = fa.launch_kernel(fa.SPLIT, q, k, v, **kw)
    again = fa.launch_kernel(fa.SPLIT, q, k, v, **kw)
    o, lse = fa.launch_kernel(fa.SPLIT, q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.launches_sm90,
            fa.flash_attention.launches_split) == \
        (before[0] + 3, before[1], before[2] + 3)
    assert chip_smoke.same_raw_bits(got, again)
    assert chip_smoke.same_raw_bits(got, o)
    want, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    chip_smoke.flash_check(got, want, f"split {case}")
    chip_smoke.flash_check(got, fa.flash_attention_split_plain(
        q, k, v, sms=fa._sm_count(dev.index), **kw), f"split plain {case}")
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), seen)
    assert bool(torch.isneginf(lse[~seen]).all())
    if seen.any():
        assert float((lse[seen] - want_lse[seen]).abs().max()) <= \
            chip_smoke.FLASH_LSE_ATOL
    assert bool((got.transpose(1, 2)[~seen] == 0).all())


@pytest.mark.parametrize("case", SPLIT_CARD_CASES[:4])
def test_cuda_flash_routes_short_queries_by_the_cut(dev, case):
    """``flash_attention`` (the operator the models call) takes the split
    route where a KV head has at most SPLIT_ROWS query rows over more than
    one 128-key tile, and the wgmma kernel otherwise: one call counts once
    in ``launches`` and once in its route's counter, and gives the route's
    bits."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hkv, D, causal, window = case
    g = torch.Generator(device=dev).manual_seed(Sq + Skv)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    took = fa.call_route(q, k)
    assert took == (fa.SPLIT if Sq * H // Hkv <= fa.SPLIT_ROWS
                    and Skv > fa.SPLIT_BC else fa.SM90)
    before = (fa.flash_attention.launches, fa.flash_attention.launches_sm90,
              fa.flash_attention.launches_split)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention.launches_sm90,
            fa.flash_attention.launches_split) == \
        (before[0] + 1, before[1] + (took == fa.SM90),
         before[2] + (took == fa.SPLIT))
    assert chip_smoke.same_raw_bits(got, fa.launch_kernel(took, q, k, v,
                                                          **kw))


D64_CARD_CASES = [  # B, Sq, Skv, H, Hkv, causal, window
    (1, 700, 700, 25, 5, True, 300),     # 128-row tiles, windowed
    (1, 700, 700, 25, 5, True, None),
    (2, 300, 300, 8, 8, False, None),    # 64-row tiles (64-key tiles)
    (1, 129, 1000, 4, 2, True, None),    # ragged, Sq < Skv
    (1, 300, 130, 8, 2, True, 50),       # rows that see no key
]


@pytest.mark.parametrize("case", D64_CARD_CASES)
def test_cuda_flash_d64_tiles_match_plain(dev, case):
    """The wgmma kernel at head size 64 (at 128-row tiles 128-key tiles, a
    3-slot ring, the two consumer warpgroups in turns) against the plain
    version within FLASH_TOL, two calls bitwise, o bitwise with and
    without the LSE, the LSE within FLASH_LSE_ATOL."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hkv, causal, window = case
    g = torch.Generator(device=dev).manual_seed(Sq + H)
    q = torch.randn(B, Sq, H, 64, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, Skv, Hkv, 64, generator=g, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    assert fa.call_route(q, k) == fa.SM90
    got = fa.flash_attention(q, k, v, **kw)
    assert chip_smoke.same_raw_bits(got, fa.flash_attention(q, k, v, **kw))
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    assert chip_smoke.same_raw_bits(got, o)
    want, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    chip_smoke.flash_check(got, want, f"D64 {case}")
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), seen)
    assert float((lse[seen] - want_lse[seen]).abs().max()) <= \
        chip_smoke.FLASH_LSE_ATOL
    if causal and Sq > Skv:
        assert bool((got[:, : Sq - Skv] == 0).all())


SM90_PATH_SHAPES = [  # B, Sq, Skv, H, Hkv, D, causal, window
    (4, 1024, 1024, 32, 8, 128, True, None),    # qwen3-4b's step
    (1, 1024, 1024, 32, 8, 128, True, None),    # the DDP grain (split)
    (2, 3072, 3072, 25, 5, 64, True, 2048),     # hymba, windowed layers
    (2, 3072, 3072, 25, 5, 64, True, None),     # hymba, global layers
    (8, 1500, 1500, 8, 8, 64, False, None),     # whisper's encoder
    (8, 448, 1500, 8, 8, 64, False, None),      # its cross-attention
    (8, 448, 448, 8, 8, 64, True, None)]        # its decoder


@pytest.mark.parametrize("case", SM90_PATH_SHAPES)
def test_cuda_flash_sm90_backward_at_path_shapes(dev, case):
    """The sm90 route on the forward's saved LSE at the train path's
    shapes: within FLASH_BWD_REL of the plain backward, two calls
    bitwise; the forward's o bitwise with and without the LSE, the LSE
    within FLASH_LSE_ATOL of the plain version's; and, where the plan
    keeps one dkdv CTA per KV head, no float32 share buffers (the call's
    peak stays under what the two (B, Skv, H, D) shares alone take)."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hkv, D, causal, window = case
    g = torch.Generator(device=dev).manual_seed(Sq + H)
    q, do = (torch.randn(B, Sq, H, D, generator=g, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    assert chip_smoke.same_raw_bits(o, fa.flash_attention(q, k, v, **kw))
    _, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), seen)
    assert float((lse[seen] - want_lse[seen]).abs().max()) <= \
        chip_smoke.FLASH_LSE_ATOL
    del want_lse, seen
    split = fa.bwd_tiles(B, Sq, Skv, H, Hkv, D, fa._sm_count(dev.index))[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert fa.flash_attention_backward.launches == before + 1
    if not split:
        assert peak < 2 * B * Skv * H * D * 4
    again = fa.flash_attention_backward(q, k, v, o, do, lse=lse, **kw)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, **kw)
    for a, b, c in zip(got, want, again):
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
        assert chip_smoke.grad_rel(a, b) <= chip_smoke.FLASH_BWD_REL
        assert chip_smoke.same_raw_bits(a, c)


@pytest.mark.parametrize("tiles", [(64, False), (128, False), (64, True),
                                   (128, True)])
@pytest.mark.parametrize("D", [64, 128])
def test_cuda_flash_sm90_backward_every_tile_choice(dev, D, tiles):
    """Each (dq rows, split) the plan may take, and the plan's
    own choice, against the plain backward on ragged lengths with a window
    and rows that see no key."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, H, Hkv = 2, 300, 200, 6, 2
    kw = dict(causal=True, window=150)
    g = torch.Generator(device=dev).manual_seed(D)
    q, do = (torch.randn(B, Sq, H, D, generator=g, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Skv, Hkv, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    got = fa._launch_backward_sm90(q, k, v, o, do, lse, tiles=tiles, **kw)
    plan = fa._launch_backward_sm90(q, k, v, o, do, lse, **kw)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, **kw)
    for a, b, c in zip(got, want, plan):
        assert chip_smoke.grad_rel(a, b) <= chip_smoke.FLASH_BWD_REL
        assert bool(torch.isfinite(a).all())
    # rows 0..99 see no key (Sq > Skv, causal): their dq is 0
    assert bool((got[0][:, : Sq - Skv] == 0).all())


def test_cuda_train_step_takes_no_plain_attention(dev):
    """A bf16 training step of qwen3-4b's smoke config on the card with
    ``flash_attention_plain`` raising on CUDA tensors: every layer's
    attention backward launches the kernels once."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config("qwen3-4b").smoke_config().scaled(remat="block")
    ocfg = OptConfig(lr=1e-3, warmup_steps=1)
    p0 = T.init_params(cfg, device=dev)
    step = make_train_step(cfg, ocfg)
    audit = {}
    before = fa.flash_attention_backward.launches
    with chip_smoke.attention_backward_audit(audit):
        _, _, m = step(p0, init_opt_state(p0, ocfg), make_batch(cfg, 2, 64))
    assert np.isfinite(float(m["loss"]))
    assert audit["backward_calls"] == cfg.n_layers
    assert audit["backward_calls_not_one_launch"] == 0
    assert sum(e["calls"] for e in audit["shapes"]) == cfg.n_layers
    assert fa.flash_attention_backward.launches - before == cfg.n_layers


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grains,U", [(4, 1_000_003), (2, 5000), (8, 77)])
def test_column_tiled_segment_reduce_bitwise(dev, dtype, grains, U):
    buf = torch.randn(grains, U, device=dev).to(dtype)
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    ln = torch.full((1,), grains, dtype=torch.int32, device=dev)
    want = sf_unpack.segment_reduce_plain(buf, st, ln, "sum")
    for tiles in (0, 1, 3):
        got = sf_unpack.short_variant(buf, st, ln, segs_per_block=1,
                                      col_tiles=tiles)
        assert chip_smoke.same_raw_bits(got, want), tiles
    assert chip_smoke.same_raw_bits(
        kops.segment_reduce_rows(buf, st, ln, op="sum"), want)


def test_dynplan_transpose_repeatable_and_equals_cpu(dev):
    from repro_torch.core import DynPlan
    gen = torch.Generator(device=dev).manual_seed(3)
    lr = chip_smoke.dyn_routing(500, 4000, gen, dev)
    root = torch.randn(500, 96, generator=gen, device=dev).requires_grad_()
    cot = torch.randn(4000, 96, generator=gen, device=dev)
    plan = DynPlan(500, 4000)
    got = [torch.autograd.grad(plan.bcast(root, lr), root, cot)[0]
           for _ in range(2)]
    assert chip_smoke.same_raw_bits(got[0], got[1])
    rc = root.detach().cpu().requires_grad_()
    want = torch.autograd.grad(plan.bcast(rc, lr.cpu()), rc, cot.cpu())[0]
    assert torch.equal(got[0].cpu(), want)


def test_ddp_step_world_invariant_on_card(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.pytree import tree_leaves
    from repro_torch.training.train_loop import make_ddp_train_step
    cfg = get_config("qwen3-4b").smoke_config()
    p0 = T.init_params(cfg, device=dev)
    ocfg = OptConfig(lr=1e-3, warmup_steps=1)
    batch = make_batch(cfg, 4, 32)
    outs = []
    for world in (1, 2, 4):
        step, _ = make_ddp_train_step(cfg, ocfg, world=world,
                                      byte_budget=4096, grains=4,
                                      params_template=p0)
        outs.append(step(p0, init_opt_state(p0, ocfg), batch)[0])
    for o in outs[1:]:
        assert all(chip_smoke.same_raw_bits(a, b) for a, b in
                   zip(tree_leaves(outs[0]), tree_leaves(o)))


# ------------------------------------------------- training of the families
@pytest.mark.parametrize("S,chunk", [(600, 256), (45, 16)])
def test_scan_function_graphs_equal_eager_steps(dev, S, chunk):
    """The scan Function replays its graphs (forward, recompute, reverse);
    its forward is bitwise the inference loop's, its gradients within
    chip_smoke.SCAN_GRAD_REL of autograd through the eager step loop."""
    from repro_torch.models import ssm as PSSM
    g = torch.Generator(device=dev).manual_seed(S)
    B, Hm, hd, N = 2, 25, 64, 16
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    ins = [r(B, S, Hm, 1).abs() * 0.3, r(B, S, Hm, hd), r(B, S, Hm, N),
           r(B, S, Hm, N), -r(Hm, N).abs() - 0.1, r(B, Hm, hd, N) * 0.1]
    cot = (r(S, B, Hm, hd, 1), r(B, Hm, hd, N))
    h_inf = ins[5].clone()
    ys_inf = PSSM._scan(*ins[:5], h_inf, chunk)
    a = [t.clone().requires_grad_() for t in ins]
    out = PSSM._SelectiveScan.apply(*a, chunk)
    assert torch.equal(out[0].detach(), ys_inf)
    assert torch.equal(out[1].detach(), h_inf)
    got = torch.autograd.grad(out, a, cot)
    kinds = {k[0] for k in PSSM._GRAPHS if k[1] == chunk and k[2] == B}
    assert kinds == {"_ChunkGraph", "_ChunkBackGraph"}
    b = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(chip_smoke.plain_scan(*b), b, cot)
    for x, w in zip(got, want):
        assert float((x - w).abs().max()) <= \
            chip_smoke.SCAN_GRAD_REL * float(w.abs().max())


def test_xlstm_chunk_graphs_equal_eager_chunks(dev):
    """One xlstm pair under grad at S = 300 (chunks of 128, 128 and 44):
    the chunk graphs' outputs, state and gradients bitwise the eager
    chunks' (``chip_smoke.train_xlstm_check`` at a smoke width)."""
    sz = chip_smoke.Sizes(**chip_smoke.TRAIN_SMOKE)
    sz.xlstm_check_train = (2, 300)
    rec = chip_smoke.train_xlstm_check(sz, dev)
    assert rec["bitwise"] and rec["graphs"] >= 4


def test_flash_function_at_whisper_cross_shape(dev):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(1500)
    q = torch.randn(2, 448, 8, 64, generator=g, device=dev).bfloat16() \
        .requires_grad_()
    k, v = (torch.randn(2, 1500, 8, 64, generator=g, device=dev)
            .bfloat16().requires_grad_() for _ in range(2))
    go = torch.randn(2, 448, 8, 64, generator=g, device=dev).bfloat16()
    got = torch.autograd.grad(kops.flash_attention(q, k, v, causal=False),
                              (q, k, v), go)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v,
                                                        causal=False),
                               (q, k, v), go)
    for a, b in zip(got, want):
        assert chip_smoke.grad_rel(a, b) <= chip_smoke.FLASH_BWD_REL


def test_hymba_smoke_train_step_card_equals_cpu(dev):
    """One float32 train step of hymba's smoke config (40 tokens: the
    sliding layer's window of 16 masks) on the card and on the CPU from
    the same parameters: each element within 5e-3 and each leaf's
    difference within 1e-3 of the CPU step's norm."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.pytree import tree_leaves, tree_map
    from repro_torch.training.train_loop import make_train_step
    cfg = get_config("hymba-1.5b").smoke_config().scaled(dtype="float32",
                                                         remat="block")
    ocfg = OptConfig(lr=1e-2, warmup_steps=1)
    p0 = T.init_params(cfg, device="cpu")
    b = make_batch(cfg, 2, 40)
    step = make_train_step(cfg, ocfg)
    want = step(p0, init_opt_state(p0, ocfg), b)[0]
    pc = tree_map(lambda t: t.to(dev), p0)
    got = step(pc, init_opt_state(pc, ocfg), b)[0]
    for g_, w, b0 in zip(tree_leaves(got), tree_leaves(want),
                         tree_leaves(p0)):
        d = g_.cpu().double() - w.double()
        assert float(d.abs().max()) <= 5e-3
        assert float(d.norm()) <= 1e-3 * float((w.double() - b0.double())
                                               .norm())


def test_cuda_priors_table_routes_sfcomm(dev, monkeypatch):
    """A card-stamped priors table that favours ``"global"`` at the scalar
    message size and ``"cuda"`` at 64-lane rows sends ``SFComm`` (no
    ``backend``) to each in turn; each one's bcast and reduce are bitwise
    the other fixed backend's, and a CPU SF keeps the static rule."""
    from repro_torch.core import estimate_message_bytes
    from repro_torch.core import priors as priors_mod
    sf = _general_sf()
    small = estimate_message_bytes(sf)
    big = estimate_message_bytes(sf, unit=(64,))
    table = priors_mod.PriorsTable(meta=priors_mod.current_env())
    for bk, nb, us in (("global", small, 10.0), ("global", big, 300.0),
                       ("cuda", small, 100.0), ("cuda", big, 30.0)):
        table.record(bk, nb, us)
    monkeypatch.setattr(priors_mod, "default_priors", lambda: table)
    assert table.meta["platform"] == "gpu"
    for unit, want in ((None, "global"), ((64,), "cuda")):
        auto = SFComm(sf, device=dev, unit=unit)
        assert auto.backend_name == want
        other = SFComm(sf, backend={"global": "cuda", "cuda": "global"}[want],
                       device=dev, unit=unit)
        rows = () if unit is None else unit
        root = _values((sf.nroots_total,) + rows, torch.float32, dev, 5)
        leaf = _values((sf.nleafspace_total,) + rows, torch.float32, dev, 6)
        for op in ("replace", "sum"):
            assert chip_smoke.same_raw_bits(auto.bcast(root, leaf, op),
                                            other.bcast(root, leaf, op))
        for op in ("sum", "max"):
            assert chip_smoke.same_raw_bits(auto.reduce(leaf, root, op),
                                            other.reduce(leaf, root, op))
    assert SFComm(sf, device="cpu", unit=(64,)).backend_name == "global"
