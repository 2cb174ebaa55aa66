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

import dataclasses

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


# odd row widths (the MoE decode's fused 8,194-byte rows: (4097,) bf16)
# and a source one row in (data[1:] of 257-byte rows: off every alignment)
@needs_reference
@pytest.mark.parametrize("unit,dt,first", [
    ((4097,), "bfloat16", 0), ((4097,), "bfloat16", 1), ((257,), "int8", 1),
    ((257,), "int8", 0), ((3, 43), "bfloat16", 1), ((257,), "float32", 1)])
def test_pack_odd_rows_match_pallas(unit, dt, first, rng):
    N, M = 9, 6
    vals = rng.integers(-120, 120, (N,) + unit) if dt == "int8" else \
        rng.standard_normal((N,) + unit)
    vals = vals.astype(np.float32)
    idx = rng.integers(0, N - first, M).astype(np.int32)
    jd = jnp.asarray(vals).astype(dt)[first:]
    want = np.asarray(ref_pack(jd, jnp.asarray(idx), interpret=True)
                      .astype(jnp.float32))
    td = torch.as_tensor(vals).to(getattr(torch, dt))[first:]
    for got in (sf_pack.pack(td, idx), sf_pack.pack(td, torch.as_tensor(idx)),
                kops.pack_rows(td, idx)):
        assert got.dtype == td.dtype and got.shape == (M,) + unit
        np.testing.assert_array_equal(got.float().numpy(), want)


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


# ------------------------------------------------------- wide gather plan
_WIDE_OFFSETS = (0, 1, 2, 4, 8)


def _wide_offsets(M):
    """(source, output) base offsets mod 16: every pair at small M; at
    4,097 rows five pairs, each offset once on each side."""
    if M < 4097:
        return [(a, b) for a in _WIDE_OFFSETS for b in _WIDE_OFFSETS]
    return list(zip(_WIDE_OFFSETS, _WIDE_OFFSETS[1:] + _WIDE_OFFSETS[:1]))


def _check_wide_walk(plan, rows, src, out, sms=132):
    """pack's plan, walked in numpy as the wide kernel walks it: the stores
    tile the output (every byte once), are naturally aligned, and narrower
    than 16 bytes only outside the row's aligned interior; each store's
    bytes come from its row's source row; every load is an aligned
    granule holding a byte of its row, and a row's loads cover it."""
    M, rb = plan.M, plan.row_bytes
    w = plan.walk(rows)
    st, wd = w["stores"]
    order = np.argsort(st, kind="stable")
    st, wd = st[order], wd[order]
    assert st[0] == 0 and st[-1] + wd[-1] == M * rb
    assert (st[1:] == st[:-1] + wd[:-1]).all()
    assert np.isin(wd, (1, 2, 4, 8, 16)).all()
    assert ((out + st) % wd == 0).all()
    r = st // rb
    assert ((st + wd - 1) // rb == r).all()
    begin, end = out + r * rb, out + (r + 1) * rb
    inner0, inner1 = -(-begin // 16) * 16, end // 16 * 16
    narrow = wd < 16
    assert ((out + st + wd <= inner0) | (out + st >= inner1))[narrow].all()
    mo, ms, mb = w["moves"]
    assert np.array_equal(np.sort(mo), st)
    assert (ms == rows[mo // rb] * rb + mo % rb).all()
    lo, lw, lr = w["loads"]
    first = rows[lr] * rb
    assert (lw == 16).all() and ((src + lo) % 16 == 0).all()
    assert ((lo + 16 > first) & (lo < first + rb)).all()
    g0 = (src + rows * rb) // 16
    spans = (src + rows * rb + rb - 1) // 16 - g0 + 1
    assert np.unique(lr * (1 << 40) + (src + lo) // 16).size == spans.sum()
    warps = plan.threads // 32
    assert 1 <= warps <= 4 and plan.threads % 32 == 0
    assert plan.items <= plan.grid * warps < plan.items + warps
    if M * max(1, -(-(rb // 16) // 32)) >= sms:
        assert plan.grid >= sms


@pytest.mark.parametrize("M", [1, 32, 4097])
@pytest.mark.parametrize("row_bytes", [256, 257, 258, 1024, 1030, 8194,
                                       14338, 16388])
def test_wide_plan_writes_every_byte_once(row_bytes, M, rng):
    """pack's launch plan over odd and misaligned widths, source and
    output bases off the 16-byte alignment, one row, a decode step's 32
    rows and 4,097 rows (chunks walked grid-stride)."""
    for so, oo in _wide_offsets(M):
        src, out = (1 << 30) + so, (1 << 31) + oo
        plan = sf_pack.wide_plan(M, row_bytes, src_ptr=src, out_ptr=out)
        assert (plan.src_mod, plan.out_mod) == (so, oo)
        _check_wide_walk(plan, rng.integers(0, 9, M), src, out)


@pytest.mark.parametrize("row_bytes", [1, 3, 15, 17, 31, 100])
@pytest.mark.parametrize("K", [None, 1, 4])
def test_wide_plan_takes_narrow_rows(row_bytes, K, rng):
    """Rows of fewer than 32 bytes (a head and a tail, or a row inside one
    granule) and forced chunk sizes, with one SM or 132."""
    for so, oo in ((0, 0), (1, 8), (15, 3)):
        for M in (1, 7, 300):
            for sms in (1, 132):
                src, out = (1 << 30) + so, (1 << 31) + oo
                plan = sf_pack.wide_plan(M, row_bytes, src_ptr=src,
                                         out_ptr=out, sms=sms, K=K)
                assert K is None or plan.K == K
                _check_wide_walk(plan, rng.integers(0, 5, M), src, out, sms)


def test_wide_plan_on_main_shapes():
    """A decode step's 32 fused rows spread over the SMs in 512-byte
    chunks; the wide-row SF's 1 KB rows are a warp's chunk each; kimi's
    prefill rows are 7 chunks of 2 KB."""
    def plan(M, rb):
        return sf_pack.wide_plan(M, rb, src_ptr=0, out_ptr=0)
    for rb in (8194, 16388):
        p = plan(32, rb)
        assert p.K == 1 and p.grid >= 132
    p = plan(65536, 1024)
    assert (p.K, p.chunks, p.threads, p.grid) == (2, 1, 128, 16384)
    p = plan(10368, 14336)
    assert (p.K, p.chunks) == (4, 7)
    with pytest.raises(ValueError):
        sf_pack.wide_plan(4, 16, src_ptr=0, out_ptr=0, K=5)
    with pytest.raises(ValueError):
        sf_pack.wide_plan(2 ** 30, 16388, src_ptr=0, out_ptr=0)


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
    for dt in (torch.uint16, torch.uint32, torch.bool):
        with pytest.raises(TypeError, match="int64, float16, not"):
            sf_unpack.segment_reduce_sorted(buf.to(dt), [0], [5])
    with pytest.raises(IndexError):
        sf_unpack.segment_reduce_sorted(buf.int(), [3], [4])
    with pytest.raises(ValueError, match="op must be"):
        sf_unpack.segment_reduce_sorted(buf.int(), [0], [5], op="mean")


# ------------------------------------------------------- long segments
# The long route (segments over LONG_SEG rows): its plan, an emulation of
# its combine order against the plain fold, its routes, and long segments
# against the reference.  The card twins are in test_torch_on_card.py.
LONG_SEG, C = sf_unpack.LONG_SEG, sf_unpack.LONG_CHUNK_ROWS
EDGE_LENGTHS = (0, 1, LONG_SEG - 1, LONG_SEG, LONG_SEG + 1, C - 1, C, C + 1,
                2 * C - 1, 2 * C, 2 * C + 1, 3 * C + 5)
INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)
FLOAT_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)
ORDER_FREE = [(dt, op) for dt in INT_DTYPES for op in OPS] + \
    [(dt, op) for dt in FLOAT_DTYPES for op in ("max", "min")]


def _plan_oracle(start, length, cut, chunk_rows):
    """(segment, first row, rows) of every chunk, walked in numpy."""
    out = []
    for s, (a, n) in enumerate(zip(start, length)):
        if n > cut:
            out += [(s, a + k, min(chunk_rows, n - k))
                    for k in range(0, n, chunk_rows)]
    return np.array(out, np.int64).reshape(-1, 3)


@pytest.mark.parametrize("seed", range(4))
def test_long_plan_covers_each_long_row_once(seed):
    """Every row of a long segment lies in exactly one chunk of that
    segment, chunks run in row order from the segment's first row in steps
    of C, short segments are left out, and the plan is a function of the
    (start, len) values alone: int32 / int64 tensors and numpy arrays of
    the same values give the same chunks."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([EDGE_LENGTHS, rng.integers(0, 3 * C, 6),
                           rng.integers(0, 2 * LONG_SEG, 6)])
    rng.shuffle(lens)
    starts = rng.integers(0, 4 * C, lens.size)   # unsorted, overlapping
    chunks = None
    for st_, ln_ in ((starts, lens),
                     (torch.as_tensor(starts), torch.as_tensor(lens)),
                     (torch.as_tensor(starts, dtype=torch.int32),
                      torch.as_tensor(lens, dtype=torch.int32))):
        plan = sf_unpack.long_plan(st_, ln_, torch.device("cpu"))
        got = plan.chunks()
        if chunks is None:
            chunks = got
        np.testing.assert_array_equal(got, chunks)
    np.testing.assert_array_equal(chunks,
                                  _plan_oracle(starts, lens, LONG_SEG, C))
    long = np.flatnonzero(lens > LONG_SEG)
    assert plan.n_long == long.size and plan.n_chunks == len(chunks)
    np.testing.assert_array_equal(plan.seg.numpy(), long)
    for s in long:
        mine = chunks[chunks[:, 0] == s]
        rows = np.concatenate([np.arange(a, a + n) for _, a, n in mine])
        np.testing.assert_array_equal(rows, starts[s] + np.arange(lens[s]))
        assert (mine[:, 2] >= 1).all() and (mine[:, 2] <= C).all()
        assert ((mine[:, 1] - starts[s]) % C == 0).all()
    assert not np.isin(chunks[:, 0], np.flatnonzero(lens <= LONG_SEG)).any()


def test_long_plan_without_long_segments():
    plan = sf_unpack.long_plan(np.array([0, 5]), np.array([5, LONG_SEG]),
                               torch.device("cpu"))
    assert plan.n_long == plan.n_chunks == 0 and plan.chunks().shape == (0, 3)


def test_chunk_rows_match_the_source():
    """LONG_CHUNK_ROWS is the C that csrc/sf_unpack.cu compiles in."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "sf_unpack.cu").read_text()
    m = re.search(r"constexpr int kLongChunkRows = (\d+);", src)
    assert m and int(m.group(1)) == C


@pytest.mark.parametrize("dt", INT_DTYPES + FLOAT_DTYPES)
def test_long_route_predicate(dt):
    """Short segments keep the one-thread kernel; over the cut, float sum
    and prod keep the buffer order (never split), everything else splits."""
    for op in OPS:
        for lmax in (0, 1, LONG_SEG):
            assert sf_unpack.reduce_route(lmax, dt, op) == "short"
        for lmax in (LONG_SEG + 1, C + 1, 1 << 22):
            route = sf_unpack.reduce_route(lmax, dt, op)
            if dt.is_floating_point and op in ("sum", "prod"):
                assert route == "ordered"
                assert not sf_unpack.order_free(dt, op)
            else:
                assert route == "split" and sf_unpack.order_free(dt, op)


def _kernel_combine(op, acc, v):
    """combine(acc, v) of csrc/sf_unpack.cu, acc first."""
    if op == "sum":
        return acc + v
    if op == "prod":
        return acc * v
    keep = torch.isnan(acc) | ~(torch.isnan(v) | (v > acc if op == "max"
                                                   else v < acc))
    return torch.where(keep, acc, v)


def _merge_at(op, a, ra, b, rb):
    """merge_at of csrc/sf_unpack.cu: of two elements the one the
    sequential max / min keeps (NaN first, then the extremum, then the
    earlier row)."""
    an, bn = torch.isnan(a), torch.isnan(b)
    gb, ga = (b > a, a > b) if op == "max" else (b < a, a < b)
    take = torch.where(an | bn, torch.where(an & bn, rb < ra, bn),
                       torch.where(gb, True, torch.where(ga, False,
                                                         rb < ra)))
    return torch.where(take, b, a), torch.where(take, rb, ra)


def _emulate_long_route(buf, start, length, op, cut, chunk_rows, threads,
                        vec, lanes):
    """The split route's combine order in torch: pass 1 deals each chunk's
    rows to ``threads`` threads ``vec`` rows at a time; a thread folds its
    rows in order (floats: merge_at with rows), then an ascending tree over
    the threads; pass 2 gives lane l of ``lanes`` a contiguous run of the
    segment's chunk partials and folds the lanes by an ascending tree, the
    lower lane left."""
    track = buf.dtype.is_floating_point
    unit = buf.shape[1:]
    ident = sf_unpack._identity(op, buf.dtype)
    out = sf_unpack.segment_reduce_plain(buf, torch.as_tensor(start),
                                         torch.as_tensor(length), op)
    big = torch.full(unit, 2 ** 40, dtype=torch.int64)
    parts = {}
    for s, first, n in _plan_oracle(start, length, cut, chunk_rows):
        acc = [torch.full(unit, ident, dtype=buf.dtype) for _ in
               range(threads)]
        row = [big.clone() for _ in range(threads)]
        for i in range(n):
            t = (i // vec) % threads
            x = buf[first + i]
            if track:
                acc[t], row[t] = _merge_at(op, acc[t], row[t], x,
                                           torch.full(unit, i))
            else:
                acc[t] = _kernel_combine(op, acc[t], x)
        d = 1
        while d < threads:
            for t in range(0, threads, 2 * d):
                if track:
                    acc[t], row[t] = _merge_at(op, acc[t], row[t],
                                               acc[t + d], row[t + d])
                else:
                    acc[t] = _kernel_combine(op, acc[t], acc[t + d])
            d *= 2
        parts.setdefault(int(s), []).append(acc[0])
    for s, p in parts.items():
        q = -(-len(p) // lanes)
        lane = []
        for l in range(lanes):
            a = torch.full(unit, ident, dtype=buf.dtype)
            for x in p[l * q:(l + 1) * q]:
                a = _kernel_combine(op, a, x)
            lane.append(a)
        d = 1
        while d < lanes:
            for l in range(0, lanes, 2 * d):
                lane[l] = _kernel_combine(op, lane[l], lane[l + d])
            d *= 2
        out[s] = lane[0]
    return out


def _adversarial(dt, op, M, unit, rng):
    """Rows that a wrong combine order would betray: in the first third,
    NaNs with distinct payloads (some with the sign bit) in a fifth of the
    elements; in the second, values of one sign with -0 and +0 where the
    extremum is 0; +-inf; an all-identity run; integers over their whole
    range (odd for prod: products that wrap and stay non-zero)."""
    shape = (M,) + unit
    if dt.is_floating_point:
        x = torch.as_tensor(rng.standard_normal(shape)).to(dt)
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        nbits = 8 * x.element_size()
        quiet = {torch.float32: 0x7FC00000, torch.float64: 0x7FF8 << 48,
                 torch.bfloat16: 0x7FC0, torch.float16: 0x7E00}[dt]
        third = M // 3
        block = x[:third].view(iv).reshape(-1)
        hit = np.flatnonzero(rng.random(block.numel()) < 0.2)
        for k, i in enumerate(hit):
            bits = quiet | (k % 63 + 1) | ((1 << (nbits - 1)) if k % 3 == 0
                                           else 0)
            block[i] = bits - (1 << nbits) if bits >> (nbits - 1) else bits
        sign = -1.0 if op == "max" else 1.0
        mag = sign * (1 + rng.random((third,) + unit))
        zeros = rng.random((third,) + unit) < 0.4
        signed0 = rng.choice([-0.0, 0.0], (third,) + unit)
        x[third:2 * third] = torch.as_tensor(
            np.where(zeros, signed0, mag)).to(dt)
        infs = rng.choice(M, 3, replace=False)
        x[torch.as_tensor(infs)] = torch.as_tensor(
            rng.choice([-np.inf, np.inf], (3,) + unit)).to(dt)
    else:
        info = torch.iinfo(dt)
        v = rng.integers(info.min, info.max, shape, endpoint=True)
        if op == "prod":
            v |= 1
        x = torch.as_tensor(v).to(dt)
    a = int(rng.integers(0, M - M // 8))
    x[a:a + M // 8] = sf_unpack._identity(op, dt)
    return x


def _bits(t):
    if not t.dtype.is_floating_point:
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


from hypothesis import (example, given, settings,  # noqa: E402
                        strategies as hst)


@pytest.mark.parametrize("dt,op", ORDER_FREE,
                         ids=[f"{str(d)[6:]}-{o}" for d, o in ORDER_FREE])
@settings(max_examples=8)
@given(seed=hst.integers(0, 2 ** 31 - 1),
       chunk_rows=hst.sampled_from([1, 3, 5, 8, 16]),
       threads=hst.sampled_from([1, 2, 4]), vec=hst.sampled_from([1, 2, 4]),
       lanes=hst.sampled_from([1, 2, 4, 32]),
       unit=hst.sampled_from([(), (3,)]))
def test_long_route_order_equals_plain_fold_bitwise(dt, op, seed, chunk_rows,
                                                    threads, vec, lanes,
                                                    unit):
    """The split route's combine order (per-chunk folds with interleaved
    threads, then a left-first tree over the chunks) gives the plain
    sequential fold's bits for every order-free (dtype, op): NaN payloads,
    signs of zero, wrapped integers.  Small chunks and cuts stand in for C
    and LONG_SEG so that segments cross many chunk edges."""
    rng = np.random.default_rng(seed)
    M, cut = 96, 6
    x = _adversarial(dt, op, M, unit, rng)
    lens = rng.integers(0, 40, 9)
    lens[:3] = (cut, cut + 1, 0)
    starts = rng.integers(0, M - lens + 1)
    want = sf_unpack.segment_reduce_plain(x, torch.as_tensor(starts),
                                          torch.as_tensor(lens), op)
    got = _emulate_long_route(x, starts, lens, op, cut, chunk_rows, threads,
                              vec, lanes)
    assert torch.equal(_bits(got), _bits(want))


def test_plain_fold_keeps_first_nan_payload_and_zero_sign():
    """segment_reduce_plain is the kernels' fold: the first NaN with its
    payload, else the first extremum (-0 before +0 keeps -0)."""
    nan1 = torch.tensor([0x7FC00001], dtype=torch.int32).view(torch.float32)
    nan2 = torch.tensor([0x7FC00002], dtype=torch.int32).view(torch.float32)
    buf = torch.cat([torch.tensor([-1.0]), nan1, nan2, torch.tensor(
        [-0.0, 0.0, -2.0, 0.0, -0.0])])
    st, ln = torch.tensor([0, 3, 6]), torch.tensor([3, 3, 2])
    mx = sf_unpack.segment_reduce_plain(buf, st, ln, "max")
    assert mx[:1].view(torch.int32).item() == 0x7FC00001
    assert str(mx[1].item()) == "-0.0" and str(mx[2].item()) == "0.0"
    mn = sf_unpack.segment_reduce_plain(buf, st, ln, "min")
    assert mn[:1].view(torch.int32).item() == 0x7FC00001
    assert mn[1].item() == -2.0 and str(mn[2].item()) == "0.0"


@needs_reference
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", [np.float32, np.int32])
@pytest.mark.parametrize("SB", [1, 8])
def test_long_segments_match_pallas(op, dt, SB, rng):
    """Segments over LONG_SEG rows (with short and empty ones beside them)
    through the port's segment_reduce_blocked against the Pallas kernel in
    interpret mode.  Integers and max / min bitwise; float sums and
    products of small integers and powers of two, which are exact in any
    order, within the reference test's tolerance."""
    U = 3
    lens = np.array([LONG_SEG + 1, 3, 0, 2 * LONG_SEG + 7, LONG_SEG, 5])
    M = int(lens.sum())
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    if dt == np.int32:
        buf = rng.integers(-2 ** 31, 2 ** 31 - 1, (M, U), endpoint=True,
                           dtype=np.int64).astype(np.int32)
    elif op == "sum":
        buf = rng.integers(-1000, 1000, (M, U)).astype(np.float32)
    elif op == "prod":
        buf = rng.choice(np.float32([1, 2, 0.5, -1]), (M, U))
    else:
        buf = rng.standard_normal((M, U)).astype(np.float32)
        buf[700, 1] = np.nan
    assert sf_unpack.reduce_route(int(lens.max()), torch.float32 if dt ==
                                  np.float32 else torch.int32, op) != "short"
    Lmax = int(lens.max())
    padded = np.concatenate([buf, np.zeros((Lmax, U), buf.dtype)])
    want = np.asarray(ref_seg_blocked(
        jnp.asarray(padded), jnp.asarray(start), jnp.asarray(lens),
        num_segments=start.size, Lmax=Lmax, segs_per_block=SB, op=op,
        interpret=True))
    got = sf_unpack.segment_reduce_blocked(torch.as_tensor(buf), start,
                                           lens, segs_per_block=SB, op=op)
    if dt == np.float32 and op in ("sum", "prod"):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ short plan
# The short route's layout (sf_unpack.short_plan): its walk in numpy at the
# paths' shapes and on drawn shapes, its route choice, its constants
# against the source, and wide units against the reference.  The card
# twins are in test_torch_on_card.py.
def _sf_segments(rng, roots, rows):
    """The wide-row SF's reduce metadata: ``rows`` leaves on ``roots``
    random roots, one segment a root that has leaves."""
    ln = np.bincount(rng.integers(0, roots, rows))
    ln = ln[ln > 0]
    return np.concatenate([[0], np.cumsum(ln)[:-1]]), ln


def _token_segments(rng, vocab, tokens):
    """A token lookup's transpose: one segment a vocabulary row, most of
    them empty."""
    ln = np.bincount(rng.integers(0, vocab, tokens), minlength=vocab)
    return np.concatenate([[0], np.cumsum(ln)[:-1]]), ln


def _check_short_walk(plan, start, length, cut=LONG_SEG, window=None):
    """Every output element of a segment of at most ``cut`` rows written
    by exactly one fold, none of a longer one; each fold's reads are its
    segment's rows start .. start + len - 1 in order; lanes and warps in
    range.  CTAs in windows of ``window`` (all at once by default)."""
    start, length = np.asarray(start), np.asarray(length)
    V = plan.V
    assert plan.U % V == 0
    cover = np.zeros(plan.S * plan.U // V, np.int64)
    n_ctas = int(np.prod(plan.grid))
    step = window or n_ctas
    for lo in range(0, n_ctas, step):
        w = plan.walk(start, length, long_cut=cut, ctas=range(lo, lo + step))
        assert (w["width"] == V).all() and (w["elem"] % V == 0).all()
        assert (w["lane"] < 32).all() and (w["warp"] < plan.threads // 32
                                           ).all()
        assert ((w["cta"] >= lo) & (w["cta"] < lo + step)).all()
        assert (w["elem"] // plan.U == w["seg"]).all()
        cover += np.bincount(w["elem"] // V, minlength=cover.size)
        fold, row = w["reads"]
        n = length[w["seg"]]
        assert np.array_equal(np.bincount(fold, minlength=n.size), n)
        assert (np.diff(fold) >= 0).all()
        k = np.arange(fold.size) - np.repeat(np.cumsum(n) - n, n)
        assert np.array_equal(row, start[w["seg"]][fold] + k)
    want = np.repeat((length <= cut).astype(np.int64), plan.U // V)
    assert np.array_equal(cover, want)


PATH_SHAPES = {
    # (S, U, element bytes, metadata)
    "sf_wide_f32": lambda rng: (256, 4, *_sf_segments(rng, 1 << 14,
                                                      1 << 16)),
    "ddp_bucket_bf16": lambda rng: (10_485_760, 2, np.array([0]),
                                    np.array([4])),
    "token_transpose_bf16": lambda rng: (2560, 2, *_token_segments(
        rng, 151_936, 4096)),
    "moe_dispatch_bf16": lambda rng: (4096, 2, *_token_segments(
        rng, 4096, 8192)),
}


@pytest.mark.parametrize("shape", sorted(PATH_SHAPES))
def test_short_plan_walk_path_shapes(shape):
    """The paths' four row-5 shapes (metadata only) take the vector route
    and their walk writes each output element once, folding each
    segment's rows in order: the wide-row SF's reduce (65,536 rows of 256
    f32), the DDP bucket (one segment of 4 rows x 10,485,760 bf16),
    qwen3-4b's token transpose (4,096 tokens onto 151,936 rows of 2,560
    bf16) and phi3.5-moe's dispatch transpose (8,192 slots onto 4,096
    tokens of 4,096 bf16)."""
    U, eb, start, length = PATH_SHAPES[shape](np.random.default_rng(5))
    plan = sf_unpack.short_plan(length.size, U, eb, rows=int(length.sum()),
                                buf_ptr=0, out_ptr=0, segs_per_cta=1)
    assert plan.route == "vector" and plan.lanes == 32
    assert 1 <= plan.K <= sf_unpack.SHORT_MAX_K
    assert plan.grid[0] * plan.per_cta >= plan.items > \
        (plan.grid[0] - 1) * plan.per_cta
    _check_short_walk(plan, start, length, window=2048)


@settings(max_examples=40, deadline=None)
@given(S=hst.integers(1, 70), U=hst.integers(1, 700),
       eb=hst.sampled_from([1, 2, 4, 8]), buf_mod=hst.sampled_from(
           [0, 0, 1, 2, 4, 8]), out_mod=hst.sampled_from([0, 0, 8]),
       SB=hst.sampled_from([1, 3, 64]), col_tiles=hst.sampled_from(
           [0, 0, 0, 1, 3]), sms=hst.sampled_from([1, 4, 132]),
       seed=hst.integers(0, 2 ** 31 - 1))
@example(S=1, U=(1 << 24) + 8, eb=2, buf_mod=0, out_mod=0, SB=1,
         col_tiles=0, sms=132, seed=0)
@example(S=1, U=(1 << 24) + 3, eb=4, buf_mod=0, out_mod=0, SB=1,
         col_tiles=0, sms=132, seed=0)
def test_short_plan_walk_drawn(S, U, eb, buf_mod, out_mod, SB, col_tiles,
                               sms, seed):
    """Drawn segment counts, units, element sizes, offsets, CTA groups,
    tiles and SM counts: every output element written once, each fold's
    rows in order, segments over a small cut (standing in for LONG_SEG)
    and empty segments included; a single segment over 2^24 elements."""
    rng = np.random.default_rng(seed)
    length = rng.integers(0, 12, S)
    length[rng.random(S) < 0.3] = 0
    if S > 2:
        length[1] = 30                       # over the cut below
    start = rng.integers(0, 40, S)
    plan = sf_unpack.short_plan(S, U, eb, rows=int((start + length).max()),
                                buf_ptr=buf_mod, out_ptr=out_mod,
                                segs_per_cta=SB, sms=sms,
                                col_tiles=col_tiles)
    _check_short_walk(plan, start, length, cut=20)


@pytest.mark.parametrize("U,eb,buf_mod,out_mod,route", [
    (256, 4, 0, 0, "vector"), (4, 4, 0, 0, "vector"),      # 16 B
    (12, 4, 0, 0, "vector"), (8, 2, 0, 0, "vector"),       # 48 B, 16 B
    (4096, 2, 0, 0, "vector"), (2, 8, 0, 0, "vector"),
    (16, 1, 0, 0, "vector"), (1, 4, 0, 0, "scalar"),       # U = 1
    (3, 4, 0, 0, "scalar"), (5, 2, 0, 0, "scalar"),        # 12 B, 10 B
    (256, 4, 4, 0, "scalar"), (4096, 2, 2, 0, "scalar"),   # data[1:]
    (256, 4, 0, 8, "scalar"), (4097, 2, 0, 0, "scalar"),   # odd width
    (1, 16, 0, 0, "vector")])
def test_short_plan_route(U, eb, buf_mod, out_mod, route):
    """Vector for rows of whole 16-byte vectors on 16-byte boundaries,
    scalar otherwise (narrower rows, odd widths, a view one element in);
    column tiles mean the scalar route; forcing the vector route where the
    rows do not qualify raises."""
    plan = sf_unpack.short_plan(100, U, eb, rows=400, buf_ptr=buf_mod,
                                out_ptr=out_mod, segs_per_cta=1)
    assert plan.route == route
    kw = dict(rows=400, buf_ptr=buf_mod, out_ptr=out_mod, segs_per_cta=1)
    assert sf_unpack.short_plan(100, U, eb, route="scalar", **kw
                                ).route == "scalar"
    assert sf_unpack.short_plan(100, U, eb, col_tiles=1, **kw
                                ).route == "scalar"
    if route == "scalar":
        with pytest.raises(ValueError, match="vector route"):
            sf_unpack.short_plan(100, U, eb, route="vector", **kw)
    with pytest.raises(ValueError, match="col_tiles"):
        sf_unpack.short_plan(100, U, eb, col_tiles=2, route="vector", **kw)


def test_short_plan_candidates_name_different_launches():
    """The tuner's "row" and "block:SB" candidates give different vector
    launches at the wide-row SF's and the DDP bucket's shapes (the plan
    reads segs_per_cta as the least number of items a CTA walks), and one
    launch where the card would not stay full."""
    mk = lambda S, U, M, SB: sf_unpack.short_plan(
        S, U, 4, rows=M, buf_ptr=0, out_ptr=0, segs_per_cta=SB)
    for S, U, M in ((16_000, 256, 65_536), (1, 1 << 22, 4)):
        row, block = mk(S, U, M, 1), mk(S, U, M, 64)
        assert row.route == block.route == "vector"
        assert row.per_cta < block.per_cta and row.grid != block.grid
    few = mk(1, 4096, 4, 1)
    assert few == dataclasses.replace(mk(1, 4096, 4, 64), segs_per_cta=1)


def test_short_plan_rule_at_the_path_shapes():
    """The rule's choices at the paths' shapes (the sweep's fastest within
    its noise, PERF.md): K 1 where segments hold rows (the wide-row SF,
    the DDP bucket), 4 where they are almost all empty (the token
    transpose), 2 between (the MoE dispatch: two slots a token); 4 warps a
    CTA; the almost empty segments two items a warp."""
    plan = lambda S, U, eb, M: sf_unpack.short_plan(
        S, U, eb, rows=M, buf_ptr=0, out_ptr=0, segs_per_cta=1)
    got = {k: (p.K, p.threads, p.per_cta) for k, p in (
        ("sf", plan(16_063, 256, 4, 65_536)),
        ("ddp", plan(1, 10_485_760, 2, 4)),
        ("token", plan(151_936, 2560, 2, 4096)),
        ("moe", plan(4096, 4096, 2, 8192)))}
    assert got == {"sf": (1, 128, 8), "ddp": (1, 128, 8),
                   "token": (4, 128, 8), "moe": (2, 128, 4)}


def test_short_plan_constants_match_the_source():
    """SHORT_ROWS, SHORT_MAX_K and SHORT_WARPS are the R, K and warps
    that csrc/sf_unpack.cu compiles in."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "sf_unpack.cu").read_text()
    for name, value in (("kShortRows", sf_unpack.SHORT_ROWS),
                        ("kShortMaxK", sf_unpack.SHORT_MAX_K),
                        ("kShortWarps", sf_unpack.SHORT_WARPS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name


@needs_reference
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("U,dt", [(256, np.float32), (4096, "bfloat16")])
def test_wide_units_match_pallas(op, U, dt, rng):
    """Wide units (rows the vector route takes on the card: 256 f32, 4,096
    bf16) over a few segments, empty ones among them, through the port's
    segment_reduce_sorted against the Pallas segment reduce in interpret
    mode at one segment a grid step (``segment_reduce_blocked`` with
    ``segs_per_block=1``: the Pallas ``segment_reduce_sorted`` does not
    run on this jax).  Values are small integers (powers of two for prod),
    exact in any order, so the reference's ``jnp.sum`` matches the
    sequential fold bitwise."""
    lens = np.array([3, 0, 7, 1, 0, 14, 2])
    M = int(lens.sum())
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    if op == "prod":
        vals = rng.choice(np.float32([1, 2, 0.5, -1]), (M, U))
    else:
        vals = rng.integers(-8, 8, (M, U)).astype(np.float32)
    tdt = torch.float32 if dt == np.float32 else torch.bfloat16
    buf = torch.as_tensor(vals).to(tdt)
    plan = sf_unpack.short_plan(lens.size, U, buf.element_size(), rows=M,
                                buf_ptr=0, out_ptr=0, segs_per_cta=1)
    assert plan.route == "vector"
    Lmax = int(lens.max())
    jbuf = jnp.asarray(vals, dtype=jnp.float32 if dt == np.float32
                       else jnp.bfloat16)
    padded = jnp.concatenate([jbuf, jnp.zeros((Lmax, U), jbuf.dtype)])
    want = np.asarray(ref_seg_blocked(
        padded, jnp.asarray(start), jnp.asarray(lens),
        num_segments=start.size, Lmax=Lmax, segs_per_block=1, op=op,
        interpret=True).astype(jnp.float32))
    got = sf_unpack.segment_reduce_sorted(buf, start, lens, op=op)
    np.testing.assert_array_equal(got.float().numpy(), want)


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
         "flash_attention", "flash_attention_backward"])


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


@pytest.mark.parametrize("what,source", [
    ("index", lambda: torch.arange(9, dtype=torch.int32)),
    ("index", lambda: torch.arange(9)),
    ("index", lambda: np.arange(9)),
    ("segments", lambda: torch.arange(9, dtype=torch.int32)),
    ("segments", lambda: torch.arange(9, dtype=torch.int32).reshape(3, 3))],
    ids=["int32", "int64", "numpy", "segments-int32", "segments-int32-2d"])
def test_prepared_index_cache_entry_dies_with_its_source(what, source):
    """An entry lives only as long as its source, also where the prepared
    tensor is the source itself (an int32 tensor on the data's device) or
    its flat view: a repeat call returns them again, and dropping the
    source drops the entry and its memory."""
    import gc
    from repro_torch.kernels import _index
    cpu = torch.device("cpu")
    before = len(_index._CACHE)
    src = source()
    call = (lambda: _index.device_index(src, cpu)) if what == "index" \
        else (lambda: _index.segment_meta(src, src, cpu))
    a, b = call(), call()
    assert len(_index._CACHE) == before + 1
    assert b[0] is a[0] or b[0].data_ptr() == a[0].data_ptr()
    assert [x for x in a[1:] if not isinstance(x, torch.Tensor)] == \
        [x for x in b[1:] if not isinstance(x, torch.Tensor)]
    if isinstance(src, torch.Tensor) and src.dtype == torch.int32:
        assert a[0].data_ptr() == src.data_ptr()
    del a, b, call, src
    gc.collect()
    assert len(_index._CACHE) == before


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
