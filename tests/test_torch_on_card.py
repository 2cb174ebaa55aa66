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
against the CPU's, and a long-route reduce captured into a CUDA graph.

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
