"""Port parity, structured grids: ``repro_torch.meshdist.DMDA`` (its ghost
star forest, ``global_to_local`` / ``local_to_global`` on both port
backends, CPU tensors) and ``ParCSR.from_dmda_stencil`` / ``diagonal``
against the reference DMDA on the same grids.

Plan arrays, replace exchanges, integer reductions, the stencil matrix and
its diagonal are bitwise; float sums hold the reference ``test_dmda.py``
tolerance (1e-5) and are bitwise between the two port backends (both fold
each root's contributions in the same sorted order).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from torch_parity import n, t  # noqa: E402

from repro.meshdist import dmda as ref_dmda  # noqa: E402
from repro.sparse.parmat import ParCSR as RefParCSR  # noqa: E402
from repro_torch.meshdist import DMDA, default_proc_grid  # noqa: E402
from repro_torch.sparse import ParCSR  # noqa: E402

BACKENDS = ["global", "cuda"]
CPU = "cpu"

# (shape, nranks, kwargs): 2D and 3D, star / box, width 1-2, periodic or
# not or mixed, connect / skip
CONFIGS = [
    ((9, 7), 4, dict(stencil="star", width=1, periodic=True)),
    ((9, 7), 4, dict(stencil="box", width=2, periodic=False)),
    ((9, 7), 4, dict(stencil="star", width=2, periodic=(True, False),
                     interior="skip")),
    ((8, 6), 4, dict(stencil="box", width=1, periodic=True,
                     interior="skip")),
    ((4, 5, 6), 6, dict(stencil="star", width=1, periodic=True)),
    ((6, 6, 5), 8, dict(stencil="box", width=1, periodic=False,
                        interior="skip")),
    ((7, 6, 6), 8, dict(stencil="star", width=2, periodic=False)),
]
IDS = [f"{'x'.join(map(str, s))}-{r}-{k['stencil']}{k['width']}-"
       f"{k.get('interior', 'connect')}-p{k['periodic']}"
       for s, r, k in CONFIGS]
_DAS = {}


def _das(i):
    if i not in _DAS:
        shape, nranks, kw = CONFIGS[i]
        _DAS[i] = (ref_dmda.DMDA(shape, nranks, **kw),
                   DMDA(shape, nranks, **kw))
    return _DAS[i]


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=IDS)
def test_star_forest_and_layout_match_reference(i):
    ref, da = _das(i)
    assert da.proc_grid == ref.proc_grid
    assert da.periodic == ref.periodic
    for a, b in zip(da.splits, ref.splits):
        np.testing.assert_array_equal(a, b)
    for name in ("owned_counts", "owned_offsets", "local_offsets",
                 "_interior_dst", "_interior_src"):
        np.testing.assert_array_equal(getattr(da, name), getattr(ref, name))
    np.testing.assert_array_equal(da.stencil_offsets(),
                                  ref.stencil_offsets())
    assert (da.nglobal, da.nlocal_total) == (ref.nglobal, ref.nlocal_total)
    assert da.sf.nedges_total == ref.sf.nedges_total
    for r in range(da.nranks):
        g, h = da.sf.graph(r), ref.sf.graph(r)
        assert (g.nroots, g.nleafspace) == (h.nroots, h.nleafspace)
        for name in ("local", "remote_rank", "remote_offset"):
            np.testing.assert_array_equal(getattr(g, name), getattr(h, name))
        assert da.ghosted_box(r) == ref.ghosted_box(r)
    coords = np.stack(np.meshgrid(*[np.arange(e) for e in da.shape],
                                  indexing="ij"), -1).reshape(-1, da.ndim)
    np.testing.assert_array_equal(da.natural_to_global(coords),
                                  ref.natural_to_global(coords))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("unit", [(), (3,)])
@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=IDS)
def test_global_to_local_matches_reference(i, unit, backend, rng):
    ref, da = _das(i)
    g = rng.standard_normal((da.nglobal,) + unit).astype(np.float32)
    want = np.asarray(ref.global_to_local(jnp.asarray(g), backend="global"))
    got = da.global_to_local(t(g), backend=backend, device=CPU)
    np.testing.assert_array_equal(n(got), want)
    lv = rng.standard_normal((da.nlocal_total,) + unit).astype(np.float32)
    want = np.asarray(ref.global_to_local(jnp.asarray(g), jnp.asarray(lv),
                                          backend="global"))
    np.testing.assert_array_equal(
        n(da.global_to_local(t(g), t(lv), backend=backend, device=CPU)),
        want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=IDS)
def test_local_to_global_matches_reference(i, op, backend, rng):
    ref, da = _das(i)
    lv = rng.standard_normal((da.nlocal_total, 2)).astype(np.float32)
    want = np.asarray(ref.local_to_global(jnp.asarray(lv), op=op,
                                          backend="global"))
    got = da.local_to_global(t(lv), op=op, backend=backend, device=CPU)
    if op == "sum":
        np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(n(got), want)
    other = "global" if backend == "cuda" else "cuda"
    assert torch.equal(got, da.local_to_global(t(lv), op=op, backend=other,
                                               device=CPU))
    li = rng.integers(-1000, 1000, (da.nlocal_total,)).astype(np.int32)
    gi = rng.integers(-1000, 1000, (da.nglobal,)).astype(np.int32)
    np.testing.assert_array_equal(
        n(da.local_to_global(t(li), t(gi), op=op, backend=backend,
                             device=CPU)),
        np.asarray(ref.local_to_global(jnp.asarray(li), jnp.asarray(gi),
                                       op=op, backend="global")))


def test_interior_skip_equals_connect(rng):
    kw = dict(stencil="star", width=1, periodic=True)
    full = DMDA((8, 6), 4, interior="connect", **kw)
    halo = DMDA((8, 6), 4, interior="skip", **kw)
    assert halo.sf.nedges_total < full.sf.nedges_total
    g = t(rng.standard_normal((full.nglobal,)).astype(np.float32))
    for backend in BACKENDS:
        assert torch.equal(halo.global_to_local(g, backend=backend,
                                                device=CPU),
                           full.global_to_local(g, backend=backend,
                                                device=CPU))
        lv = t(rng.standard_normal((full.nlocal_total,)).astype(np.float32))
        np.testing.assert_allclose(
            n(halo.local_to_global(lv, backend=backend, device=CPU)),
            n(full.local_to_global(lv, backend=backend, device=CPU)),
            rtol=1e-5, atol=1e-5)


def test_multi_field_halo_is_one_exchange_per_group(rng):
    """The 5-field halo of the card's dmda phase at a small size: a
    mixed-dtype ``bcast_multi`` on the DMDA's comm fuses 6 uint32 columns
    and one bf16 column, equal bit for bit to one global_to_local per
    field; ``reduce_multi`` fuses the f32 columns."""
    da = DMDA((6, 6, 6), 8, stencil="box", width=1, periodic=False)
    comm = da.comm("cuda", device=CPU)

    def fields(nrows):
        f = [t(rng.standard_normal((nrows, 3)).astype(np.float32)),
             t(rng.standard_normal(nrows).astype(np.float32)),
             t(rng.standard_normal(nrows).astype(np.float32)),
             t(rng.integers(0, 9, nrows).astype(np.int32)),
             torch.as_tensor(rng.standard_normal(nrows)).to(torch.bfloat16)]
        f[0].view(torch.int32)[::7, 1] = 0x7FC01234     # NaN payloads
        return f
    g = fields(da.nglobal)
    bundle = comm._bundle(g)
    assert bundle.ngroups("replace") == 2
    assert [grp.width for grp in bundle._byte_groups] == [6, 1]
    assert bundle.ngroups("sum") == 3
    lz = [x.new_zeros((da.nlocal_total,) + x.shape[1:]) for x in g]
    for got, x, z in zip(comm.bcast_multi(g, lz), g, lz):
        want = da.global_to_local(x, z, backend="cuda", device=CPU)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    lv = fields(da.nlocal_total)
    lv[0].copy_(torch.nan_to_num(lv[0]))
    sums = comm.reduce_multi(lv, [x.new_zeros((da.nglobal,) + x.shape[1:])
                                  for x in lv])
    for got, x in zip(sums, lv):
        assert torch.equal(got, da.local_to_global(x, backend="global",
                                                   device=CPU))


def test_proc_grid_and_errors():
    for shape, r in [((64, 64), 4), ((128, 8), 4), ((16, 16, 16), 6),
                     ((128, 128, 128), 8), ((30, 7, 5), 12)]:
        assert default_proc_grid(shape, r) == ref_dmda.default_proc_grid(shape, r)
    with pytest.raises(ValueError, match="cannot place"):
        DMDA((2, 2), 8)
    with pytest.raises(ValueError, match="stencil"):
        DMDA((8, 8), 2, stencil="diamond")
    with pytest.raises(ValueError, match="width"):
        DMDA((8, 8), 2, width=0)
    with pytest.raises(ValueError, match="proc_grid"):
        DMDA((8, 8), 4, proc_grid=(3, 1))
    with pytest.raises(ValueError, match="one bool per dim"):
        DMDA((8, 8), 2, periodic=(True, False, True))
    da = DMDA((8, 8), 2)
    with pytest.raises(ValueError, match="move it there"):
        da.global_to_local(torch.zeros(64, device="meta"), device=CPU)


def test_coarsen_refine_match_reference():
    kw = dict(stencil="box", width=1, periodic=False)
    ref, da = ref_dmda.DMDA((9, 9, 5), 4, **kw), DMDA((9, 9, 5), 4, **kw)
    for a, b in ((da.coarsen(), ref.coarsen()), (da.refine(), ref.refine())):
        assert (a.shape, a.proc_grid) == (b.shape, b.proc_grid)
        assert a.sf.nedges_total == b.sf.nedges_total
    with pytest.raises(ValueError, match="odd"):
        DMDA((8, 9), 2, periodic=False).coarsen()
    with pytest.raises(ValueError, match="non-periodic"):
        DMDA((9, 9), 2).refine()


# ------------------------------------------------- stencil matrix + SpMV
@pytest.mark.parametrize("shape,nranks,kw,coeffs", [
    ((6, 5), 4, dict(stencil="star", periodic=True), None),
    ((5, 4), 2, dict(stencil="star", periodic=False),
     [6.0, -1.0, -1.0, -2.0, -2.0]),
    ((5, 4, 6), 8, dict(stencil="star", periodic=False), None),
    ((4, 4, 3), 4, dict(stencil="box", periodic=(True, False, False)),
     None),
])
def test_stencil_matrix_and_diagonal_match_reference(shape, nranks, kw,
                                                     coeffs, rng):
    ref = RefParCSR.from_dmda_stencil(ref_dmda.DMDA(shape, nranks, **kw),
                                      coeffs=coeffs)
    A = ParCSR.from_dmda_stencil(DMDA(shape, nranks, **kw), coeffs=coeffs,
                                 device=CPU)
    np.testing.assert_array_equal(A.toarray(), ref.toarray())
    np.testing.assert_array_equal(A.diagonal(), ref.diagonal())
    for a, b in zip(A.diag + A.offd, ref.diag + ref.offd):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    for use_kernel in (False, True):
        np.testing.assert_allclose(
            n(A.spmv(t(x), use_kernel=use_kernel)),
            np.asarray(ref.spmv(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_stencil_coeff_count_is_checked():
    da = DMDA((5, 4), 2, stencil="star", periodic=False)
    with pytest.raises(ValueError, match="coeffs"):
        ParCSR.from_dmda_stencil(da, coeffs=[1.0, 2.0], device=CPU)
    A = ParCSR.from_dmda_stencil(DMDA((6, 6, 6), 8, stencil="star",
                                      periodic=False), device=CPU)
    assert (A.diagonal() == 6).all()
    assert A.comm.backend_name == "global"    # select_backend on the CPU
