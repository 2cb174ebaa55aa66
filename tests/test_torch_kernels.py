"""Port parity, kernel modules: each kernel's plain PyTorch version (what a
wrapper runs for CPU tensors) against the reference Pallas kernel in
interpret mode, or against ``repro.kernels.ref`` where the Pallas kernel
does not run on this jax (``pack_strided``, ``segment_reduce_sorted``).

Copies and integer ops are bitwise; float sum/prod use rtol 1e-6 (the
reference's ``jnp.sum`` is not taken in buffer order); spmv uses rtol 1e-5.
The launch-plan tests walk ``sf_pack.row_plan`` in numpy.  The
``cuda``-marked tests hold the CUDA kernels against their plain versions
and skip without a card; the reference tests skip without JAX, so on the
card's machine ``python -m pytest -m cuda tests/test_torch_kernels.py``
runs the card tests alone.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:
    import jax.numpy as jnp
    from repro.kernels import ref as R
    from repro.kernels.sf_pack import bcast_fused as ref_bcast_fused
    from repro.kernels.sf_pack import pack as ref_pack
    from repro.kernels.sf_pack import pack_blocked as ref_pack_blocked
    from repro.kernels.sf_unpack import \
        segment_reduce_blocked as ref_seg_blocked
    from repro.kernels.spmv_ell import spmv_ell as ref_spmv_ell
    HAVE_JAX = True
except ImportError:          # the card's machine has no JAX
    HAVE_JAX = False
needs_reference = pytest.mark.skipif(
    not HAVE_JAX, reason="needs jax and the JAX package (the reference)")

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
@needs_reference
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


@needs_reference
@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("dt", [np.float32, np.int32])
def test_pack_blocked_matches_pallas(B, dt, rng):
    data = _data(rng, (50, 3), dt)
    idx = rng.integers(0, 50, 37).astype(np.int32)
    want = np.asarray(ref_pack_blocked(jnp.asarray(data), jnp.asarray(idx),
                                       block_rows=B, interpret=True))
    got = sf_pack.pack_blocked(torch.as_tensor(data), idx, block_rows=B)
    np.testing.assert_array_equal(got.numpy(), want)


@needs_reference
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


@needs_reference
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


# ------------------------------------------------------------ launch plan
RAGGED_K = 2100          # 4k + r rows: more tiles than one SM's CTAs hold


def _ragged_counts(row_bytes):
    k = RAGGED_K if row_bytes <= 16 else 40
    return [0, 1, 3, 4 * k + 1, 4 * k + 2, 4 * k + 3]


def _check_walk(plan, *, src_ptrs, out_ptr, idx_ptr):
    """The plan's walk writes every output byte exactly once, touches no
    row outside [0, M), and makes every vector access aligned."""
    M, rb = plan.M, plan.row_bytes
    w = plan.walk()
    starts, widths = w["stores"]
    assert starts.size == 0 or (starts.min() >= 0
                                and (starts + widths).max() <= M * rb)
    touched = [np.zeros(0, np.int64)] + [
        starts[widths == b] + k for b in np.unique(widths) for k in range(b)]
    hits = np.bincount(np.concatenate(touched).astype(np.int64),
                       minlength=M * rb)
    assert hits.size == M * rb and (hits == 1).all()
    assert ((out_ptr + starts) % widths == 0).all()
    ioff, iw = w["index_loads"]
    assert ioff.size == 0 or (ioff.min() >= 0 and (ioff + iw).max() <= 4 * M)
    assert ((idx_ptr + ioff) % iw == 0).all()
    rl = w["row_load_bytes"]
    assert rb % rl == 0 and all(p % rl == 0 for p in src_ptrs)
    if plan.narrow:
        assert 128 <= plan.threads <= 256 and plan.threads % 32 == 0
        assert plan.tile_rows == 4 * plan.threads
        assert plan.tiles == -(-M // plan.tile_rows)
        assert (plan.grid == 0) == (M == 0) and plan.grid <= plan.tiles


# data / index bases: aligned, data[1:] (one row in), idx[1:] (4 bytes in)
_BASES = {"aligned": (0, 0), "data[1:]": (1, 0), "idx[1:]": (0, 4)}


@pytest.mark.parametrize("base", sorted(_BASES))
@pytest.mark.parametrize("row_bytes", [1, 2, 3, 4, 8, 12, 16, 1020])
def test_gather_plan_covers_every_word_once(row_bytes, base):
    """pack_blocked's launch plan, walked in numpy as the kernel walks it,
    over ragged row counts, block_rows 1 / 5 / 64 / 1024 and one SM or
    132 (the grid-stride loop and one wave)."""
    data_rows, idx_off = _BASES[base]
    src = (1 << 20) + data_rows * row_bytes
    out, idx = 1 << 21, (1 << 22) + idx_off
    for M in _ragged_counts(row_bytes):
        for block_rows in (1, 5, 64, 1024):
            for sms in (1, 132):
                plan = sf_pack.row_plan(M, row_bytes, block_rows,
                                        src_ptrs=(src,), out_ptr=out,
                                        idx_ptr=idx, sms=sms)
                assert plan.narrow == (row_bytes in (4, 8, 12, 16))
                # one load per row: the rows layout, else the lanes one
                assert plan.lanes == (plan.narrow
                                      and plan.load_words < plan.words)
                assert plan.idx_vec == (plan.narrow and not plan.lanes
                                        and idx_off == 0)
                _check_walk(plan, src_ptrs=(src,), out_ptr=out,
                            idx_ptr=idx)


@pytest.mark.parametrize("base", sorted(_BASES))
@pytest.mark.parametrize("unit_bytes,elems", [(2, 1), (2, 3), (4, 3),
                                              (8, 2), (8, 4), (4, 5)])
def test_bcast_plan_covers_every_word_once(unit_bytes, elems, base):
    """bcast_fused's plans (copy of rows of elems x unit_bytes, and a cast
    into leaf elements of unit_bytes) walked as the kernels walk them."""
    data_rows, idx_off = _BASES[base]
    rb = unit_bytes * elems
    root, leaf = (1 << 20) + data_rows * rb, (1 << 23) + data_rows * rb
    out, idx = 1 << 21, (1 << 22) + idx_off
    for M in _ragged_counts(rb):
        for cast in (None, unit_bytes):
            plan = sf_pack.row_plan(M, rb, 64, src_ptrs=(root, leaf),
                                    out_ptr=out, idx_ptr=idx,
                                    cast_unit_bytes=cast)
            words = rb // 4 if cast is None else elems
            assert plan.narrow == (1 <= words <= 4
                                   and (cast is not None or rb % 4 == 0))
            _check_walk(plan, src_ptrs=(root, leaf) if cast is None else (),
                        out_ptr=out, idx_ptr=idx)


def test_plan_takes_narrow_path_on_main_shapes():
    """The SpMV ghost pack is one short wave; the general SF's 4M-row
    packs and the local-only fused bcast stride with equal tiles per
    CTA."""
    def plan(M, rb, cast=None, src=(0,)):
        return sf_pack.row_plan(M, rb, kops.PACK_BLOCK_ROWS, src_ptrs=src,
                                out_ptr=0, idx_ptr=0, cast_unit_bytes=cast)
    spmv = plan(229376, 4)
    assert spmv.narrow and spmv.idx_vec and spmv.grid == spmv.tiles
    assert spmv.grid <= 132 * (2048 // spmv.threads)
    for rb in (4, 12):
        gen = plan(4194304, rb)
        assert gen.narrow and gen.words == rb // 4 and gen.grid < gen.tiles
        assert gen.lanes == (rb == 12)
        assert gen.tiles % gen.grid == 0
    for cast, rb in ((None, 12), (2, 6)):
        p = plan(1114112, rb, cast, (0, 0))
        assert p.narrow and p.lanes == (cast is None) and p.words == 3
        assert p.tiles % p.grid == 0
    assert not plan(65536, 1024).narrow         # the wide-row SF: generic
    with pytest.raises(ValueError):
        sf_pack.row_plan(4, 4, 0, src_ptrs=(0,), out_ptr=0, idx_ptr=0)


# ---------------------------------------------------------- segment reduce
@needs_reference
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


@needs_reference
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


@needs_reference
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
@needs_reference
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
    want = sf_unpack.segment_reduce_plain(
        buf, torch.as_tensor(start, device=cuda_device),
        torch.as_tensor(length, device=cuda_device), op)
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


def _ragged_cases(device, rng, dt, unit):
    """(data, idx) pairs: ragged row counts, data[1:] and idx[1:]."""
    n = 700
    if dt == torch.bool:
        data = torch.as_tensor(rng.random((n,) + unit) > .5, device=device)
    else:
        data = torch.as_tensor(rng.standard_normal((n,) + unit) * 100,
                               device=device).to(dt)
    for M in (1, 3, 4 * 101 + 1, 4 * 101 + 2, 4 * 101 + 3, 4 * 3000 + 1):
        idx = torch.as_tensor(rng.integers(0, n - 1, M + 1),
                              dtype=torch.int32, device=device)
        yield data, idx[:M]
        yield data[1:], idx[1:]


_DTYPES = [torch.float32, torch.float64, torch.int32, torch.bfloat16,
           torch.int8, torch.bool]


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [(), (2,), (3,), (4,), (2, 2), (5,)])
@pytest.mark.parametrize("dt", _DTYPES)
def test_cuda_pack_blocked_ragged_misaligned(cuda_device, dt, unit):
    rng = np.random.default_rng(3)
    for data, idx in _ragged_cases(cuda_device, rng, dt, unit):
        want = sf_pack.pack_plain(data, idx)
        for block_rows in (1, 5, 64, 1024):
            got = sf_pack.pack_blocked(data, idx, block_rows=block_rows)
            assert torch.equal(got, want), (dt, unit, idx.numel(),
                                            block_rows)
        assert torch.equal(sf_pack.gather_generic(data, idx,
                                                  rows_per_cta=64), want)


@pytest.mark.cuda
@pytest.mark.parametrize("unit", [(), (2,), (3,), (4,), (5,)])
@pytest.mark.parametrize("rdt,ldt", [(a, a) for a in _DTYPES] + [
    (a, b) for a in (torch.float32, torch.float64, torch.bfloat16)
    for b in (torch.float32, torch.float64, torch.bfloat16) if a != b])
def test_cuda_bcast_fused_ragged_misaligned(cuda_device, rdt, ldt, unit):
    rng = np.random.default_rng(4)
    for root, idx in _ragged_cases(cuda_device, rng, rdt, unit):
        M = idx.numel()
        leaf = torch.as_tensor(rng.standard_normal((M + 1,) + unit) * 100,
                               device=cuda_device).to(ldt)[1:] \
            if ldt != torch.bool else torch.zeros((M,) + unit,
                                                  dtype=torch.bool,
                                                  device=cuda_device)
        src = idx.clone()
        src[torch.as_tensor(rng.random(M) < 0.3, device=cuda_device)] = -1
        for s in (src, torch.cat([src[:1], src])[1:]):     # map off 16 B
            want = sf_pack.bcast_fused_plain(root, leaf, s)
            assert torch.equal(sf_pack.bcast_fused(root, leaf, s).view(
                torch.uint8), want.view(torch.uint8)), (rdt, ldt, unit, M)
            got = sf_pack.bcast_variant(root, leaf, s, route="generic")
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
