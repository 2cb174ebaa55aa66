"""Port parity, the whole slice: ``ParCSR`` SpMV / SpMV^T / multi-RHS SpMV
and CG / CGAsync of ``repro_torch`` against the reference on the same
matrices and right-hand sides (CPU tensors, so the kernels' plain versions).

SpMV agrees to rtol 1e-5; CG iteration counts agree within ±1 (float32
dots are summed in another order) and ``x`` within atol 1e-3, the
tolerance of the reference's ``test_solvers.py``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from torch_parity import n, port_parcsr  # noqa: E402

from repro.solvers.cg import cg as ref_cg, cg_async as ref_cg_async  # noqa: E402
from repro.sparse.parmat import ParCSR as RefParCSR  # noqa: E402

from repro_torch.solvers import as_matvec, cg, cg_async  # noqa: E402
from repro_torch.sparse import ParCSR  # noqa: E402


def _rand_coo(m, nn, nnz, seed):
    r = np.random.default_rng(seed)
    return r.integers(0, m, nnz), r.integers(0, nn, nnz), r.standard_normal(nnz)


def _tridiag(nn=64):
    i = np.arange(nn)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([np.full(nn, 2.5), -np.ones(2 * nn - 2)])
    return nn, rows, cols, vals


def _poisson3d(g):
    idx = np.arange(g ** 3)
    coords = (idx % g, (idx // g) % g, idx // (g * g))
    rows, cols, vals = [idx], [idx], [np.full(idx.size, 6.0)]
    for c, step in zip(coords, (1, g, g * g)):
        for s in (-1, 1):
            ok = (c + s >= 0) & (c + s < g)
            rows.append(idx[ok]); cols.append(idx[ok] + s * step)
            vals.append(-np.ones(int(ok.sum())))
    return g ** 3, np.concatenate(rows), np.concatenate(cols), \
        np.concatenate(vals)


@pytest.fixture(scope="module")
def rand_pair():
    rows, cols, vals = _rand_coo(37, 37, 300, 5)
    ref = RefParCSR.from_global_coo(4, 37, 37, rows, cols, vals)
    port = ParCSR.from_global_coo(4, 37, 37, rows, cols, vals, device="cpu",
                                  backend="cuda")
    return ref, port


def test_from_global_coo_matches_reference_blocks(rand_pair):
    ref, port = rand_pair
    for a, b in zip(port.diag + port.offd, ref.diag + ref.offd):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    for a, b in zip(port.garray, ref.garray):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.toarray(), ref.toarray())
    # the SpMV star forest's leaves are contiguous, as in the reference
    from repro_torch.core import patterns
    rep = patterns.analyze(port.sf)
    assert rep.kind == "general"
    assert all(leaf_c for _, leaf_c in rep.pair_contiguous.values())


@pytest.mark.parametrize("backend", ["global", "cuda"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_spmv_and_transpose_match_reference(rand_pair, backend, use_kernel,
                                            rng):
    ref, _ = rand_pair
    port = port_parcsr(ref)
    if backend == "cuda":
        port = ParCSR(port.nranks, port.row_offsets, port.col_offsets,
                      port.diag, port.offd, port.garray, device="cpu",
                      backend="cuda")
    assert port.comm.backend_name == backend
    x = rng.standard_normal(37).astype(np.float32)
    tx = torch.as_tensor(x)
    np.testing.assert_allclose(
        n(port.spmv(tx, use_kernel=use_kernel)),
        n(ref.spmv(jnp.asarray(x), use_kernel=use_kernel)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        n(port.spmv_transpose(tx, use_kernel=use_kernel)),
        n(ref.spmv_transpose(jnp.asarray(x), use_kernel=use_kernel)),
        rtol=1e-5, atol=1e-5)
    X = rng.standard_normal((37, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(port.spmv_multi(torch.as_tensor(X), use_kernel=use_kernel)),
        n(ref.spmv_multi(jnp.asarray(X), use_kernel=use_kernel)),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="spmv_multi expects"):
        port.spmv_multi(tx)


@pytest.fixture(scope="module")
def spd_pair():
    nn, rows, cols, vals = _tridiag()
    return (RefParCSR.from_global_coo(4, nn, nn, rows, cols, vals),
            ParCSR.from_global_coo(4, nn, nn, rows, cols, vals, device="cpu",
                                   backend="cuda"))


def _b(seed, size):
    return np.random.default_rng(seed).standard_normal(size).astype(
        np.float32)


def _agree(got, want):
    assert abs(got.iters - want.iters) <= 1, (got.iters, want.iters)
    assert got.converged == want.converged
    np.testing.assert_allclose(n(got.x), n(want.x), atol=1e-3)


def test_cg_matches_reference(spd_pair):
    ref, port = spd_pair
    b = _b(0, 64)
    want = ref_cg(ref.spmv, jnp.asarray(b), tol=1e-6, maxiter=300)
    got = cg(port, torch.as_tensor(b), tol=1e-6, maxiter=300)
    _agree(got, want)
    assert got.converged
    np.testing.assert_allclose(port.toarray() @ n(got.x), b, atol=1e-3)


@pytest.mark.parametrize("check_every", [1, 0, 10])
def test_cg_async_matches_reference(spd_pair, check_every):
    ref, port = spd_pair
    b = _b(1, 64)
    maxiter = 50 if check_every == 0 else 300
    want = ref_cg_async(ref.spmv, jnp.asarray(b), tol=1e-6, maxiter=maxiter,
                        check_every=check_every)
    got = cg_async(lambda v: port.spmv(v, use_kernel=True),
                   torch.as_tensor(b), tol=1e-6, maxiter=maxiter,
                   check_every=check_every)
    _agree(got, want)
    if check_every == 0:
        assert got.iters == want.iters == 50
    elif check_every == 10:
        assert got.iters % 10 == 0


def test_cg_on_poisson_kernel_path_matches_reference():
    """The slice's main path at a small size: 3D Poisson (10^3) over 4
    ranks, SpMV through the ELL kernel's plain version, CG to 1e-5."""
    nn, rows, cols, vals = _poisson3d(10)
    ref = RefParCSR.from_global_coo(4, nn, nn, rows, cols, vals)
    port = ParCSR.from_global_coo(4, nn, nn, rows, cols, vals, device="cpu",
                                  backend="cuda")
    b = _b(2, nn)
    want = ref_cg(lambda v: ref.spmv(v, use_kernel=True), jnp.asarray(b),
                  tol=1e-5, maxiter=500)
    got = cg(lambda v: port.spmv(v, use_kernel=True), torch.as_tensor(b),
             tol=1e-5, maxiter=500)
    _agree(got, want)
    A = port.toarray()
    assert np.linalg.norm(b - A @ n(got.x).astype(np.float64)) \
        <= 1e-4 * np.linalg.norm(b)


def test_as_matvec_accepts_operator_and_callable(spd_pair):
    _, port = spd_pair
    assert as_matvec(port) == port.spmv
    f = lambda v: v  # noqa: E731
    assert as_matvec(f) is f
    with pytest.raises(TypeError):
        as_matvec(3)
