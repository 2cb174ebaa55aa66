"""Port parity, the Galerkin and assembly layer of ``repro_torch.sparse``:
``spgemm`` against the reference's dict-per-row product (float64, rtol
1e-12, empty and ragged rows, row chunks), ``fetch_rows`` / ``spmm`` /
``ptap`` against the reference's (bitwise: the same products summed in the
same order), and stash assembly — ``Sparsity`` / ``MatAssembler`` bitwise
equal to ``np.add.at`` and to the reference's arrays and invariant to the
insertion order, ``KeyError`` on an unplanned entry, the cached flush SF,
exactly one ``SFReduce`` per ``assemble()`` counted by the port's
``sflog``, ``assemble_coo``'s stash path equal to its fetch path, and
``chip_smoke.py``'s edge-element assembly equal to
``ParCSR.from_dmda_stencil`` bit for bit.  Every port call runs on the CPU
(both backends), the reference's under ``JAX_PLATFORMS=cpu``."""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.sparse import csr as ref_csr  # noqa: E402
from repro.sparse import parmat as ref_parmat  # noqa: E402

from repro_torch.core import sflog  # noqa: E402
from repro_torch.meshdist import DMDA  # noqa: E402
from repro_torch.sparse import csr, parmat  # noqa: E402
from repro_torch.sparse.parmat import (MatAssembler, ParCSR,  # noqa: E402
                                       Sparsity, assemble_coo)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

BACKENDS = ["global", "cuda"]


def _local(c):
    return csr.LocalCSR(c.shape, c.indptr, c.indices, c.data)


def _rand_csr(m, n, nnz, seed, empty_rows=()):
    r = np.random.default_rng(seed)
    rows, cols = r.integers(0, m, nnz), r.integers(0, n, nnz)
    keep = ~np.isin(rows, empty_rows)
    return ref_csr.csr_from_coo(m, n, rows[keep], cols[keep],
                                r.standard_normal(nnz)[keep])


def assert_same_parcsr(got, want, exact=True):
    """Blocks, garray and ELL values of two ParCSRs (port, reference)."""
    np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
    for r in range(want.nranks):
        for a, b in ((got.diag[r], want.diag[r]), (got.offd[r],
                                                    want.offd[r])):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.indptr, b.indptr)
            np.testing.assert_array_equal(a.indices, b.indices)
            if exact:
                np.testing.assert_array_equal(a.data, b.data)
            else:
                np.testing.assert_allclose(a.data, b.data, rtol=1e-12)
        np.testing.assert_array_equal(got.garray[r], want.garray[r])


@pytest.mark.parametrize("case", [
    (30, 20, 25, 120, ()), (50, 40, 60, 90, (0, 3, 17)), (7, 9, 5, 0, ()),
    (64, 64, 64, 900, (5, 6, 7, 8)), (1, 40, 3, 30, ())])
@pytest.mark.parametrize("chunk", [1 << 22, 37])
def test_spgemm_matches_reference(case, chunk, monkeypatch):
    """rtol 1e-12 (float64; the products of each entry are added in the
    reference's order, so in practice the values are the same bits)."""
    m, k, n, nnz, empty = case
    monkeypatch.setattr(csr, "SPGEMM_CHUNK", chunk)
    a, b = _rand_csr(m, k, nnz, 1, empty), _rand_csr(k, n, nnz, 2, empty)
    want = ref_csr.spgemm(a, b)
    got = csr.spgemm(_local(a), _local(b))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        csr.spgemm(_local(a), _local(a)) if m != k else \
            csr.spgemm(_local(a), _local(_rand_csr(m + 1, 2, 3, 0)))


def _pair(nranks, m, n, nnz, seed, backend="cuda"):
    r = np.random.default_rng(seed)
    rows, cols = r.integers(0, m, nnz), r.integers(0, n, nnz)
    vals = r.integers(-8, 9, nnz) / 4.0
    ref = ref_parmat.ParCSR.from_global_coo(nranks, m, n, rows, cols, vals)
    port = ParCSR.from_global_coo(nranks, m, n, rows, cols, vals,
                                  device="cpu", backend=backend)
    return ref, port


@pytest.mark.parametrize("backend", BACKENDS)
def test_fetch_rows_spmm_ptap_match_reference(backend, monkeypatch):
    monkeypatch.setattr(parmat, "SFComm", _on_backend(backend))
    refA, A = _pair(4, 40, 40, 300, 3, backend)
    refP, P = _pair(4, 40, 13, 90, 4, backend)
    wanted = [np.array([0, 39, 7, 7]), np.array([], np.int64),
              np.array([12, 3]), np.arange(0, 40, 5)]
    for (gi, gc, gv), (wi, wc, wv) in zip(P.fetch_rows(wanted),
                                          refP.fetch_rows(wanted)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)
        assert gv.dtype == wv.dtype == np.float32
        np.testing.assert_array_equal(gv, wv)
    assert_same_parcsr(A.spmm(P), refA.spmm(refP))
    Pc = P.spmm(ParCSR.from_global_coo(4, 13, 13, np.arange(13),
                                       np.arange(13), np.ones(13),
                                       col_offsets=P.col_offsets,
                                       row_offsets=P.col_offsets,
                                       device="cpu", backend=backend))
    assert_same_parcsr(Pc, refP.spmm(ref_parmat.ParCSR.from_global_coo(
        4, 13, 13, np.arange(13), np.arange(13), np.ones(13),
        col_offsets=refP.col_offsets, row_offsets=refP.col_offsets)))
    got, want = A.ptap(P), refA.ptap(refP)
    assert_same_parcsr(got, want)
    np.testing.assert_array_equal(got.toarray(), want.toarray())


def _case(seed, exact=True):
    r = np.random.default_rng(seed)
    nranks = int(r.integers(2, 5))
    m, n = int(r.integers(nranks, 13)), int(r.integers(1, 11))
    nins = int(r.integers(0, 61))
    rows, cols = r.integers(0, m, nins), r.integers(0, n, nins)
    vals = (r.integers(-128, 129, nins) / 8.0 if exact
            else r.uniform(-1e3, 1e3, nins)).astype(np.float32)
    return nranks, m, n, rows, cols, vals, r.integers(0, nranks, nins)


def _assemble(asm_cls, sp, case, order=None, chunks=1, **kw):
    nranks, m, n, rows, cols, vals, src = case
    asm = asm_cls(sp, **kw)
    order = np.arange(rows.size) if order is None else order
    for q in range(nranks):
        idx = order[src[order] == q]
        for chunk in np.array_split(idx, chunks):
            asm.add_values(q, rows[chunk], cols[chunk], vals[chunk])
    return asm.assemble()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(6))
def test_stash_assembly_bitwise_equals_serial_and_reference(backend, seed):
    case = _case(seed)
    nranks, m, n, rows, cols, vals, src = case
    sp = Sparsity(nranks, m, n, rows, cols)
    ref_sp = ref_parmat.Sparsity(nranks, m, n, rows, cols)
    for f in ("keys", "rows_of", "cols_of", "row_nnz", "row_slot_start"):
        for a, b in zip(getattr(sp, f), getattr(ref_sp, f)):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(sp.nnz, ref_sp.nnz)
    np.testing.assert_array_equal(sp.slot_offsets, ref_sp.slot_offsets)
    got = _assemble(MatAssembler, sp, case, device="cpu", backend=backend)
    want = np.zeros((m, n), np.float32)
    np.add.at(want, (rows, cols), vals)
    np.testing.assert_array_equal(got.toarray().astype(np.float32), want)
    assert_same_parcsr(got, _assemble(ref_parmat.MatAssembler, ref_sp, case))


@pytest.mark.parametrize("seed", range(4))
def test_stash_assembly_insert_order_invariant(seed):
    """Arbitrary float32 values: shuffled inserts and call chunking change
    no bit of the assembled matrix."""
    case = _case(seed + 10, exact=False)
    nranks, m, n, rows, cols, vals, src = case
    sp = Sparsity(nranks, m, n, rows, cols)
    base = _assemble(MatAssembler, sp, case, device="cpu").toarray()
    rng = np.random.default_rng(seed)
    for chunks in (1, 3):
        got = _assemble(MatAssembler, sp, case, order=rng.permutation(
            rows.size), chunks=chunks, device="cpu").toarray()
        np.testing.assert_array_equal(got, base)


def test_sparsity_rejects_unplanned_entry():
    sp = Sparsity(2, 4, 4, np.array([0, 3]), np.array([0, 3]))
    asm = MatAssembler(sp, device="cpu")
    with pytest.raises(KeyError, match="not in the preallocated"):
        asm.add_values(0, [0], [1], [1.0])
    with pytest.raises(KeyError):
        asm.add_values(1, [3], [2], [1.0])      # an unplanned stash entry
    with pytest.raises(ValueError, match="out of range"):
        Sparsity(2, 4, 4, np.array([4]), np.array([0]))


@pytest.fixture
def logged():
    old = sflog.set_mode("on")
    sflog.reset()
    yield
    sflog.reset()
    sflog.set_mode(old)


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_reduce_per_assemble_and_cached_flush_sf(backend, logged,
                                                     monkeypatch):
    """Every ``assemble()`` is exactly one SFReduce (the flush) and, after
    the first, nothing else: a re-assembly with the stash pattern reuses
    the flush SF and its comm (no second compose_inverse, no second
    section bcast) and gives the same bits."""
    built = []
    real = parmat.compose_inverse
    monkeypatch.setattr(parmat, "compose_inverse",
                        lambda A, B: built.append(1) or real(A, B))
    rows = np.array([0, 5, 5, 2, 4, 1])
    cols = np.array([1, 0, 3, 2, 2, 0])
    sp = Sparsity(3, 6, 4, rows, cols)
    asm = MatAssembler(sp, backend=backend, device="cpu")
    outs = []
    for i in range(3):
        before = sflog.events_snapshot()
        asm.add_values(0, rows, cols, np.full(6, 1.5, np.float32))
        asm.add_values(2, rows[:3], cols[:3], np.ones(3, np.float32))
        outs.append(asm.assemble().toarray())
        delta = sflog.events_delta(before)
        assert delta["SFReduce"]["count"] == 1, delta
        assert not [k for k in delta if k.startswith("SFReduce")
                    and k != "SFReduce"]
        if i:
            assert set(delta) == {"SFReduce"}, delta
    assert asm.stats["flushes"] == 3 and len(built) == 1
    assert all(np.array_equal(o, outs[0]) for o in outs)
    first = asm._flush_cache[1]
    asm.add_values(1, [4], [2], [2.0])           # a new stash pattern
    asm.assemble()
    assert len(built) == 2 and asm._flush_cache[1] is not first


@pytest.mark.parametrize("backend", BACKENDS)
def test_assemble_coo_stash_equals_fetch(backend, monkeypatch):
    """Small integers: both paths are exact, so equal bit for bit, and
    equal to the reference's stash path."""
    r = np.random.default_rng(7)
    trips = [(r.integers(0, 30, k), r.integers(0, 20, k),
              r.integers(-5, 6, k).astype(np.float64))
             for k in (40, 0, 25, 60)]
    monkeypatch.setattr(parmat, "SFComm", _on_backend(backend))
    stash = assemble_coo(4, 30, 20, trips, device="cpu")
    fetch = assemble_coo(4, 30, 20, trips, method="fetch", device="cpu")
    assert_same_parcsr(stash, fetch)
    assert_same_parcsr(stash, ref_parmat.assemble_coo(4, 30, 20, trips))
    with pytest.raises(ValueError, match="unknown assembly method"):
        assemble_coo(4, 30, 20, trips, method="dense", device="cpu")


def _on_backend(backend):
    """``SFComm`` with ``backend`` as its default."""
    real = parmat.SFComm

    def make(sf, **kw):
        return real(sf, backend=kw.pop("backend", None) or backend, **kw)
    return make


@pytest.mark.parametrize("shape,nranks", [((7, 6, 5), 8), ((9, 7), 4),
                                          ((5, 4, 6), 3)])
def test_edge_element_assembly_equals_stencil(shape, nranks):
    """chip_smoke.py's assembly phase at a small size: edge elements
    through the stash give ``from_dmda_stencil``'s matrix bit for bit."""
    da = DMDA(shape, nranks, stencil="star", width=1, periodic=False)
    trips = chip_smoke.edge_element_triplets(da)
    rows = np.concatenate([t[0] for t in trips])
    cols = np.concatenate([t[1] for t in trips])
    sp = Sparsity(nranks, da.nglobal, da.nglobal, rows, cols,
                  row_offsets=da.owned_offsets, col_offsets=da.owned_offsets)
    asm = MatAssembler(sp, device="cpu")
    for q, (r, c, v) in enumerate(trips):
        asm.add_values(q, r, c, v)
    got = asm.assemble()
    assert asm.stats["stashed_inserts"] > 0
    want = ParCSR.from_dmda_stencil(da, device="cpu")
    assert_same_parcsr(got, want)
    for a, b in zip(got._diag_ell + got._offd_ell,
                    want._diag_ell + want._offd_ell):
        assert torch.equal(a.data, b.data) and torch.equal(a.cols, b.cols)
    dense = np.zeros((da.nglobal, da.nglobal))
    np.add.at(dense, (rows, cols), np.concatenate([t[2] for t in trips]))
    np.testing.assert_array_equal(got.toarray(), dense)
