"""Port parity, kernel modules: each kernel's plain PyTorch version (what a
wrapper runs for CPU tensors) against the reference Pallas kernel in
interpret mode, or against ``repro.kernels.ref`` where the Pallas kernel
does not run on this jax (``pack_strided``, ``segment_reduce_sorted``).

Copies and integer ops are bitwise; float sum/prod use rtol 1e-6 (the
reference's ``jnp.sum`` is not taken in buffer order); spmv uses rtol 1e-5.
The ``cuda``-marked tests hold the CUDA kernels against their plain
versions and skip without a card; ``chip_smoke.py`` runs them there.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as R  # noqa: E402
from repro.kernels.sf_pack import bcast_fused as ref_bcast_fused  # noqa: E402
from repro.kernels.sf_pack import pack as ref_pack  # noqa: E402
from repro.kernels.sf_pack import pack_blocked as ref_pack_blocked  # noqa: E402
from repro.kernels.sf_unpack import segment_reduce_blocked as ref_seg_blocked  # noqa: E402
from repro.kernels.spmv_ell import spmv_ell as ref_spmv_ell  # noqa: E402

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402
from repro_torch.kernels import sf_pack, sf_unpack  # noqa: E402
from repro_torch.kernels import spmv_ell as ell  # noqa: E402

OPS = ["sum", "prod", "max", "min"]


def _data(rng, shape, dt):
    if dt == np.int32:
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _segments(rng, M, S):
    """Sorted segments covering [0, M) plus zero-length ones."""
    cuts = np.sort(rng.choice(np.arange(1, M), S - 1, replace=False))
    start = np.concatenate([[0], cuts]).astype(np.int64)
    length = np.diff(np.append(start, M))
    start = np.concatenate([start, [M, 0]])
    length = np.concatenate([length, [0, 0]])      # zero-length segments
    return start, length


# ------------------------------------------------------------------ pack
@pytest.mark.parametrize("N,unit,M", [(16, (8,), 5), (33, (3,), 17),
                                      (40, (), 64), (20, (2, 2), 9)])
@pytest.mark.parametrize("dt", [np.float32, np.int32])
def test_pack_matches_pallas(N, unit, M, dt, rng):
    data = _data(rng, (N,) + unit, dt)
    idx = rng.integers(0, N, M).astype(np.int32)
    kdata = data if unit else data[:, None]
    want = np.asarray(ref_pack(jnp.asarray(kdata), jnp.asarray(idx),
                               interpret=True)).reshape((M,) + unit)
    td = torch.as_tensor(data)
    np.testing.assert_array_equal(sf_pack.pack(td, idx).numpy(), want)
    got_t = sf_pack.pack(td, torch.as_tensor(idx))
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(kops.pack_rows(td, idx).numpy(), want)
    np.testing.assert_array_equal(PR.pack_ref(td, idx).numpy(), want)


@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("dt", [np.float32, np.int32])
def test_pack_blocked_matches_pallas(B, dt, rng):
    data = _data(rng, (50, 3), dt)
    idx = rng.integers(0, 50, 37).astype(np.int32)
    want = np.asarray(ref_pack_blocked(jnp.asarray(data), jnp.asarray(idx),
                                       block_rows=B, interpret=True))
    got = sf_pack.pack_blocked(torch.as_tensor(data), idx, block_rows=B)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dims,strides,start", [
    ((4, 3, 2), (1, 8, 48), 2),
    ((8, 1, 1), (1, 8, 8), 0),
    ((2, 5, 4), (1, 16, 80), 7),
])
@pytest.mark.parametrize("unit", [(), (3,)])
def test_pack_strided_matches_ref(dims, strides, start, unit, rng):
    n_rows = start + strides[2] * dims[2] + strides[1] * dims[1] + dims[0] + 4
    data = rng.standard_normal((n_rows,) + unit).astype(np.float32)
    want = np.asarray(R.pack_strided_ref(jnp.asarray(data), start, dims,
                                         strides))
    td = torch.as_tensor(data)
    got = sf_pack.pack_strided(td, start=start, dims=dims, strides=strides)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        kops.sf_pack_strided(td, start=start, dims=dims,
                             strides=strides).numpy(), want)
    np.testing.assert_array_equal(
        PR.pack_strided_ref(td, start, dims, strides).numpy(), want)


def test_pack_strided_checks_bounds_and_stride():
    data = torch.zeros(10, 2)
    with pytest.raises(IndexError):
        sf_pack.pack_strided(data, start=5, dims=(3, 2, 1), strides=(1, 4, 8))
    with pytest.raises(ValueError, match="unit inner stride"):
        sf_pack.pack_strided(data, start=0, dims=(2, 1, 1), strides=(2, 4, 4))


@pytest.mark.parametrize("unit", [(), (3,)])
@pytest.mark.parametrize("dt", [np.float32, np.int32])
def test_bcast_fused_matches_pallas(unit, dt, rng):
    root = _data(rng, (12,) + unit, dt)
    leaf = _data(rng, (15,) + unit, dt)
    gl = rng.permutation(15)[:9]
    gr = rng.integers(0, 12, 9)
    kr, kl = (root, leaf) if unit else (root[:, None], leaf[:, None])
    want = np.asarray(ref_bcast_fused(jnp.asarray(kr), jnp.asarray(kl),
                                      jnp.asarray(gr), jnp.asarray(gl),
                                      interpret=True)).reshape(leaf.shape)
    src = sf_pack.inverse_map(gr, gl, 15)
    got = sf_pack.bcast_fused(torch.as_tensor(root), torch.as_tensor(leaf),
                              src)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        kops.local_bcast_rows(torch.as_tensor(root), torch.as_tensor(leaf),
                              src).numpy(), want)


def test_bcast_fused_casts_and_refuses():
    root = torch.randn(5, 2, dtype=torch.float64)
    leaf = torch.zeros(4, 2, dtype=torch.float32)
    src = np.array([4, -1, 0, 2], np.int32)
    got = sf_pack.bcast_fused(root, leaf, src)
    want = leaf.clone()
    want[[0, 2, 3]] = root[[4, 0, 2]].float()
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="casts only"):
        sf_pack.bcast_fused(root, leaf.to(torch.int32), src)
    with pytest.raises(ValueError, match="duplicate-free"):
        sf_pack.inverse_map([0, 1], [2, 2], 4)


# ---------------------------------------------------------- segment reduce
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", [np.float32, np.int32])
@pytest.mark.parametrize("SB", [1, 8, 64])
def test_segment_reduce_blocked_matches_pallas(op, dt, SB, rng):
    M, S, U = 40, 9, 3
    buf = _data(rng, (M, U), dt)
    if op == "prod" and dt == np.float32:
        buf = (1 + 0.1 * buf).astype(np.float32)
    start, length = _segments(rng, M, S)
    Lmax = int(length.max())
    padded = np.concatenate([buf, np.zeros((Lmax, U), buf.dtype)])
    want = np.asarray(ref_seg_blocked(
        jnp.asarray(padded), jnp.asarray(start), jnp.asarray(length),
        num_segments=start.size, Lmax=Lmax, segs_per_block=SB, op=op,
        interpret=True))
    got = sf_unpack.segment_reduce_blocked(torch.as_tensor(buf), start,
                                           length, segs_per_block=SB, op=op)
    if dt == np.float32 and op in ("sum", "prod"):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("unit", [(), (2, 2)])
def test_segment_reduce_sorted_matches_ref(op, unit, rng):
    M, S = 30, 7
    buf = rng.standard_normal((M,) + unit).astype(np.float32)
    start, length = _segments(rng, M, S)
    seg_ids = np.repeat(np.arange(start.size), length)
    want = np.asarray(R.unpack_segment_ref(jnp.asarray(buf),
                                           jnp.asarray(seg_ids), start.size,
                                           op))
    tb = torch.as_tensor(buf)
    got = sf_unpack.segment_reduce_sorted(tb, start, length, op=op)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        PR.unpack_segment_ref(tb, torch.as_tensor(seg_ids), start.size,
                              op).numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        kops.segment_reduce_rows(tb, start, length, op=op).numpy(), want,
        rtol=1e-6, atol=1e-6)


def test_segment_reduce_plain_is_sequential_fold_with_nan():
    """The plain fold runs in buffer order from the identity, max/min
    propagate NaN, zero-length segments give the identity."""
    # in float32, (1 + 1e8) - 1e8 == 0 while 1 + (1e8 - 1e8) == 1
    buf = torch.tensor([1.0, 1e8, -1e8, float("nan"), 2.0, 3.0])
    start, length = np.array([0, 3, 5, 6]), np.array([3, 2, 1, 0])
    s = sf_unpack.segment_reduce_plain(buf, torch.as_tensor(start),
                                       torch.as_tensor(length), "sum")
    assert s[0].item() == 0.0 and s[3].item() == 0.0
    mx = sf_unpack.segment_reduce_blocked(buf, start, length,
                                          segs_per_block=2, op="max")
    assert torch.isnan(mx[1]) and mx[2] == 3.0 and mx[3] == -float("inf")
    mn = sf_unpack.segment_reduce_sorted(buf, start, length, op="min")
    assert torch.isnan(mn[1]) and mn[3] == float("inf")


@pytest.mark.parametrize("op", OPS)
def test_sf_unpack_matches_ref(op, rng):
    """Segment reduce + duplicate-free scatter, against the reference
    oracle (the reference ``sf_unpack`` runs ``segment_reduce_sorted``,
    which does not run on this jax)."""
    M, S, U = 37, 9, 4
    buf = rng.standard_normal((M, U)).astype(np.float32)
    start, length = _segments(rng, M, S)
    start, length = start[:S], length[:S]
    dst = rng.permutation(20)[:S]
    target = rng.standard_normal((20, U)).astype(np.float32)
    red = np.asarray(R.unpack_segment_ref(
        jnp.asarray(buf), jnp.asarray(np.repeat(np.arange(S), length)), S,
        op))
    want = target.copy()
    combine = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
               "min": np.minimum}[op]
    want[dst] = combine(want[dst], red)
    got = kops.sf_unpack(torch.as_tensor(target), torch.as_tensor(buf),
                         start, length, dst, op=op)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_segment_reduce_refuses_bad_input():
    buf = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        sf_unpack.segment_reduce_sorted(buf, [0], [5])
    with pytest.raises(IndexError):
        sf_unpack.segment_reduce_sorted(buf.int(), [3], [4])
    with pytest.raises(ValueError, match="op must be"):
        sf_unpack.segment_reduce_sorted(buf.int(), [0], [5], op="mean")


# ------------------------------------------------------------------- spmv
@pytest.mark.parametrize("N,K,Nx", [(50, 7, 40), (256, 16, 300), (8, 1, 8)])
def test_spmv_ell_matches_pallas(N, K, Nx, rng):
    data = rng.standard_normal((N, K)).astype(np.float32)
    cols = rng.integers(0, Nx, (N, K)).astype(np.int32)
    x = np.zeros(Nx + 1, np.float32)
    x[:Nx] = rng.standard_normal(Nx)
    want = np.asarray(ref_spmv_ell(jnp.asarray(data), jnp.asarray(cols),
                                   jnp.asarray(x), block_rows=64,
                                   interpret=True))
    td, tx = torch.as_tensor(data), torch.as_tensor(x)
    got = ell.spmv_ell(td, cols, tx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(PR.spmv_ell_ref(td, cols, tx).numpy(), want,
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(IndexError):
        ell.spmv_ell(td, np.full((N, K), Nx + 1, np.int32), tx)


# -------------------------------------------------------- counters, cache
def test_cpu_path_counts_no_launch(rng):
    """Plain versions on CPU tensors are not kernel launches."""
    kops.reset_launch_counts()
    data = torch.randn(10, 3)
    kops.pack_rows(data, np.arange(4))
    kops.segment_reduce_rows(data, [0, 4], [4, 6], op="sum")
    assert set(kops.launch_counts().values()) == {0}
    assert sorted(kops.kernel_wrappers()) == sorted(
        ["pack", "pack_blocked", "pack_strided", "bcast_fused",
         "segment_reduce_sorted", "segment_reduce_blocked", "spmv_ell",
         "flash_attention"])


def test_prepared_index_cache_follows_source():
    """The prepared index is reused while its source is unchanged and
    rebuilt after an in-place change (the bounds check sees the edit)."""
    from repro_torch.kernels._index import device_index
    cpu = torch.device("cpu")
    idx = torch.tensor([0, 2, 1])
    a = device_index(idx, cpu)
    assert device_index(idx, cpu)[0] is a[0] and a[1:] == (0, 2)
    idx[1] = 7
    b = device_index(idx, cpu)
    assert b[0] is not a[0] and b[2] == 7
    with pytest.raises(IndexError):
        sf_pack.pack(torch.zeros(5), idx)
    with pytest.raises(TypeError, match="integer"):
        device_index(torch.zeros(3), cpu)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.int32, torch.bfloat16])
def test_cuda_pack_kernels_match_plain(cuda_device, dt):
    data = (torch.randn(300, 3, device=cuda_device) * 100).to(dt)
    idx = torch.randint(0, 300, (211,), device=cuda_device)
    want = sf_pack.pack_plain(data, idx)
    before = sf_pack.pack_blocked.launches
    assert torch.equal(sf_pack.pack(data, idx), want)
    assert torch.equal(sf_pack.pack_blocked(data, idx, block_rows=16), want)
    assert sf_pack.pack_blocked.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_cuda_segment_reduce_matches_plain_bitwise(cuda_device, op):
    buf = torch.randn(500, 2, device=cuda_device)
    start, length = _segments(np.random.default_rng(1), 500, 60)
    want = sf_unpack.segment_reduce_plain(buf, torch.as_tensor(start),
                                          torch.as_tensor(length), op)
    for got in (sf_unpack.segment_reduce_sorted(buf, start, length, op=op),
                sf_unpack.segment_reduce_blocked(buf, start, length,
                                                 segs_per_block=8, op=op)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_spmv_and_fused_bcast_match_plain(cuda_device):
    data = torch.randn(100, 7, device=cuda_device)
    cols = torch.randint(0, 90, (100, 7), device=cuda_device)
    x = torch.randn(91, device=cuda_device)
    want = ell.spmv_ell_plain(data, cols, x)
    got = ell.spmv_ell(data, cols, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    root = torch.randn(40, 3, device=cuda_device)
    leaf = torch.randn(30, 3, device=cuda_device)
    src = torch.as_tensor(sf_pack.inverse_map(np.arange(10), np.arange(10) * 2,
                                              30), device=cuda_device)
    assert torch.equal(sf_pack.bcast_fused(root, leaf, src),
                       sf_pack.bcast_fused_plain(root, leaf, src))
