"""Card twins of the CPU parity tests: the new segment-reduce dtypes
against their plain version, both backends' reduce bit for bit (and from
run to run), the fused multi-field exchange, the DMDA halo against the CPU,
the CUDA-graph ``cg_async`` against the same guarded chunks run eagerly;
and for the composed-SF slice the V-cycle against the CPU, the graph PCG
against its eager chunks, the prolong slot sums repeatable bit for bit,
the edge-element stash assembly, and the ``sflog`` facade hooks during a
capture (``traced`` only, nothing per replay).

Every test is ``cuda``-marked and skips without a card; the file imports
no JAX, so the card's machine runs it:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_on_card.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SFComm, StarForest
from repro_torch.kernels import ops as kops, sf_unpack

pytestmark = pytest.mark.cuda

NEW_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.int64,
              torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this slice on "
                    "the card")
    return torch.device("cuda")


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


def test_cuda_vcycle_matches_cpu_and_repeats(dev):
    """rtol 1e-4, atol 1e-5 x max|v| against the CPU (float32 sums in
    another order); bitwise from run to run on the card."""
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


def test_cuda_prolong_slot_sums_repeat_bitwise(dev):
    """The weighted slot sums run through the segment-reduce kernel (no
    float atomics): the same bits on every call, and the CPU's."""
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
    import chip_smoke
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
