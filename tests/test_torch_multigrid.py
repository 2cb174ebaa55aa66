"""Port parity, geometric multigrid: ``repro_torch.solvers.multigrid``
against ``repro.solvers.multigrid`` on the same DMDAs.

* ``Transfer``'s slot arrays (weights, fine rows, coarse columns) and its
  interpolation and injection SFs: equal to the reference's, array for
  array, on 2D and 3D DMDAs over 1, 2, 4 and 8 ranks;
* ``prolong`` / ``restrict`` / ``inject`` against ``P x`` / ``Pᵀ x`` /
  ``(P ∘ [P = 1]) x`` at the reference test's tolerances (rtol = atol =
  1e-5, 1e-4, and 1e-6 / 0), and against the reference's own transfers;
* the Galerkin operators: bitwise equal to the reference's, and to
  ``Pᵀ A P`` within the reference test's 1e-4;
* ``vcycle`` against the reference's: rtol 1e-4, atol 1e-5 (float32 sums
  in another order); single level: the dense pseudo-inverse, 1e-5;
* the V(1,1)-PCG golden test on 17×17 over 1, 2 and 4 ranks: the port's
  count equals the reference's, is 8 ± 1, does not depend on the rank
  count, and is at most half of plain CG's;
* ``cg_async(M=)`` at ``check_every`` 0, 1 and 3: the reference's
  iteration counts;
* ``M=None``: ``cg`` and the eager ``cg_async`` chunks give the bits of
  the unpreconditioned loop this slice started from (kept below).
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from torch_parity import n, port_sf  # noqa: E402

from repro.meshdist.dmda import DMDA as RDMDA  # noqa: E402
from repro.solvers import multigrid as RMG  # noqa: E402
from repro.solvers.cg import cg as ref_cg, cg_async as ref_cg_async  # noqa: E402

from repro_torch.meshdist import DMDA  # noqa: E402
from repro_torch.solvers import Multigrid, Transfer, build_hierarchy  # noqa: E402
from repro_torch.solvers import cg, cg_async  # noqa: E402
cg_mod = importlib.import_module("repro_torch.solvers.cg")

from test_torch_compose import assert_same_graphs  # noqa: E402


def _das(shape, nranks):
    return (DMDA(shape, nranks, periodic=False),
            RDMDA(shape, nranks, periodic=False))


def _natural_rhs(da, seed=0):
    """The reference test's rank-layout-independent RHS: drawn in natural
    order, permuted into ``da``'s global ordering."""
    rng = np.random.default_rng(seed)
    bnat = rng.standard_normal(da.nglobal).astype(np.float32)
    b = np.empty(da.nglobal, np.float32)
    b[da.natural_to_global(DMDA.box_coords([(0, e) for e in da.shape]))] = \
        bnat
    return b


@pytest.mark.parametrize("shape", [(9, 9), (9, 5), (5, 9, 7), (9, 9, 9)])
@pytest.mark.parametrize("nranks", [1, 2, 4, 8])
def test_transfer_arrays_and_sfs_match_reference(shape, nranks):
    if nranks == 8 and len(shape) == 2:
        nranks = 6           # 8 ranks need an axis of 4 on 5 coarse points
    fine, rfine = _das(shape, nranks)
    t = Transfer(fine, fine.coarsen(), device="cpu")
    rt = RMG.Transfer(rfine, rfine.coarsen())
    for f in ("weights", "seg_ids", "coarse_cols"):
        a, b = getattr(t, f), getattr(rt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.nslots == rt.nslots
    assert_same_graphs(t.sf, rt.sf)
    assert_same_graphs(t.injection_sf, rt.injection_sf)


@pytest.mark.parametrize("backend", ["global", "cuda"])
@pytest.mark.parametrize("shape,nranks", [((9, 9), 4), ((5, 9, 5), 8)])
def test_transfer_matches_interpolation_matrix(backend, shape, nranks):
    fine, rfine = _das(shape, nranks)
    t = Transfer(fine, fine.coarsen(), backend=backend, device="cpu")
    rt = RMG.Transfer(rfine, rfine.coarsen())
    P = t.as_parcsr().toarray()
    np.testing.assert_array_equal(P, rt.as_parcsr().toarray())
    rng = np.random.default_rng(1)
    xc = rng.standard_normal(t.ncoarse).astype(np.float32)
    xf = rng.standard_normal(t.nfine).astype(np.float32)
    pro = n(t.prolong(torch.as_tensor(xc)))
    res = n(t.restrict(torch.as_tensor(xf)))
    inj = n(t.inject(torch.as_tensor(xc)))
    np.testing.assert_allclose(pro, P @ xc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res, P.T @ xf, rtol=1e-4, atol=1e-4)
    w1 = P == 1.0
    assert w1.sum() == t.ncoarse
    np.testing.assert_allclose(inj, (P * w1) @ xc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(pro, np.asarray(rt.prolong(jnp.asarray(xc))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res, np.asarray(rt.restrict(jnp.asarray(xf))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(inj, np.asarray(rt.inject(jnp.asarray(xc))))
    # multi-RHS payloads ride the same plans
    X = rng.standard_normal((t.ncoarse, 3)).astype(np.float32)
    np.testing.assert_allclose(n(t.prolong(torch.as_tensor(X))), P @ X,
                               rtol=1e-5, atol=1e-5)


def _vcycle_case(mg, rmg, b):
    got = n(mg.vcycle(torch.as_tensor(b)))
    np.testing.assert_allclose(got, np.asarray(rmg.vcycle(jnp.asarray(b))),
                               rtol=1e-4, atol=1e-5)
    return got


@pytest.mark.parametrize("shape,nranks,nlevels", [((5, 7, 5), 8, 2),
                                                  ((5, 5), 2, 1)])
def test_vcycle_matches_reference(shape, nranks, nlevels):
    da, rda = _das(shape, nranks)
    mg = Multigrid(da, nlevels=nlevels, device="cpu")
    rmg = RMG.Multigrid(rda, nlevels=nlevels)
    b = _natural_rhs(da, seed=3)
    got = _vcycle_case(mg, rmg, b)
    if nlevels == 1:     # the dense coarse solve alone
        want = np.linalg.pinv(mg.ops[0].toarray()).astype(np.float32) @ b
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def golden():
    """The 17x17 problem over 1, 2 and 4 ranks: port and reference."""
    out = {}
    for nranks in (1, 2, 4):
        da, rda = _das((17, 17), nranks)
        out[nranks] = (Multigrid(da, nlevels=3, device="cpu"),
                       RMG.Multigrid(rda, nlevels=3), _natural_rhs(da))
    return out


def test_hierarchy_and_galerkin_operators_match_reference(golden):
    assert [d.shape for d in build_hierarchy(DMDA((17, 17), 4,
                                                  periodic=False), 3)] == \
        [(17, 17), (9, 9), (5, 5)]
    mg, rmg, _ = golden[4]
    for l in range(3):
        got, want = mg.ops[l], rmg.ops[l]
        for r in range(4):
            for a, b in ((got.diag[r], want.diag[r]),
                         (got.offd[r], want.offd[r])):
                np.testing.assert_array_equal(a.indptr, b.indptr)
                np.testing.assert_array_equal(a.indices, b.indices)
                np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(got.garray[r], want.garray[r])
        np.testing.assert_array_equal(n(mg.diags[l]), np.asarray(
            rmg.diags[l]))
    for l in range(2):
        P = mg.transfers[l].as_parcsr().toarray()
        A = mg.ops[l].toarray()
        np.testing.assert_allclose(mg.ops[l + 1].toarray(), P.T @ A @ P,
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(mg._coarse_inv), np.asarray(rmg._coarse_inv),
                               rtol=1e-5, atol=1e-6)


def test_vcycle_three_levels_matches_reference(golden):
    mg, rmg, _ = golden[4]
    _vcycle_case(mg, rmg, _natural_rhs(mg.das[0], seed=3))


def test_mg_pcg_golden_iteration_count(golden):
    iters = {}
    for nranks, (mg, rmg, b) in golden.items():
        A, bt = mg.ops[0], torch.as_tensor(b)
        plain = cg(A, bt, tol=1e-6, maxiter=200)
        pre = cg(A, bt, tol=1e-6, maxiter=200, M=mg.vcycle)
        ref = ref_cg(rmg.ops[0].spmv, jnp.asarray(b), tol=1e-6, maxiter=200,
                     M=rmg.vcycle)
        assert plain.converged and pre.converged and ref.converged
        assert pre.iters == ref.iters, (nranks, pre.iters, ref.iters)
        assert 2 * pre.iters <= plain.iters, (nranks, pre.iters, plain.iters)
        np.testing.assert_allclose(A.toarray() @ n(pre.x), b, atol=1e-3)
        iters[nranks] = pre.iters
    assert len(set(iters.values())) == 1, f"rank-dependent iters: {iters}"
    assert abs(iters[1] - 8) <= 1, f"golden count drifted: {iters}"


@pytest.mark.parametrize("check_every", [0, 1, 3])
def test_mg_pcg_async_matches_reference_iterations(golden, check_every):
    mg, rmg, b = golden[2]
    maxiter = 11 if check_every == 0 else 100
    got = cg_async(mg.ops[0], torch.as_tensor(b), tol=1e-6, maxiter=maxiter,
                   check_every=check_every, M=mg.vcycle)
    want = ref_cg_async(rmg.ops[0].spmv, jnp.asarray(b), tol=1e-6,
                        maxiter=maxiter, check_every=check_every,
                        M=rmg.vcycle)
    assert got.iters == want.iters, (got.iters, want.iters)
    assert bool(torch.isfinite(got.x).all())
    if check_every:
        assert got.converged
        host = cg(mg.ops[0], torch.as_tensor(b), tol=1e-6, maxiter=100,
                  M=mg.vcycle)
        # the guarded loop's live steps are the host loop's
        assert got.iters >= host.iters
        if check_every == 1:
            assert torch.equal(got.x, host.x)
        np.testing.assert_allclose(n(got.x), np.asarray(want.x), atol=1e-3)


# -------------------------------------------------- M=None is unchanged
def _old_step(matvec, x, r, p, rr):
    """The unpreconditioned step as this slice found it."""
    Ap = matvec(p)
    alpha = rr / cg_mod._dot(p, Ap)
    x = x + alpha * p
    r = r - alpha * Ap
    rr_new = cg_mod._dot(r, r)
    p = r + (rr_new / rr) * p
    return x, r, p, rr_new


def _old_cg(matvec, b, tol, maxiter):
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p, rr = r, cg_mod._dot(r, r)
    bnorm = float(torch.sqrt(cg_mod._dot(b, b)))
    it, rnorm = 0, float(torch.sqrt(rr))
    while it < maxiter and rnorm > tol * max(bnorm, 1e-30):
        x, r, p, rr = _old_step(matvec, x, r, p, rr)
        rnorm = float(torch.sqrt(rr))
        it += 1
    return x, it


def test_m_none_is_the_unpreconditioned_loop_bitwise(golden):
    mg, _, b = golden[4]
    A, bt = mg.ops[0], torch.as_tensor(b)
    want_x, want_it = _old_cg(A.spmv, bt, 1e-6, 200)
    got = cg(A, bt, tol=1e-6, maxiter=200)
    assert got.iters == want_it and torch.equal(got.x, want_x)
    for check_every in (1, 3):
        a = cg_async(A, bt, tol=1e-6, maxiter=200, check_every=check_every)
        if check_every == 1:
            assert a.iters == want_it and torch.equal(a.x, want_x)
        else:
            assert a.iters >= want_it and a.iters % 3 == 0
    # check_every=0: exactly maxiter of the old steps
    x, r = torch.zeros_like(bt), bt - A.spmv(torch.zeros_like(bt))
    p, rr = r, cg_mod._dot(r, r)
    for _ in range(13):
        x, r, p, rr = _old_step(A.spmv, x, r, p, rr)
    a0 = cg_async(A, bt, maxiter=13, check_every=0)
    assert a0.iters == 13 and torch.equal(a0.x, x)
