"""The split-KV route and the head-size-64 tiles of row 8's forward, on the
CPU.

``kernels/flash_attention.py::split_plan`` mirrors the split kernels of
``csrc/flash_attention.cu`` (``flash_attention_split_fwd``): the rows of a
KV head a CTA takes, the KV tiles some query row can see and their cut
into contiguous ranges, folded in range order by the combine.  Here: the
plan's walk takes every visible (row, key) pair in exactly one range and
nothing else; the ranges cover the tiles in order and fill two waves of
the SMs; :func:`route` sends a call to the split route exactly up to
``SPLIT_ROWS`` query rows per KV head; the plain split-and-combine version
(:func:`flash_attention_split_plain`) gives :func:`flash_attention_plain`'s
output and LSE and the JAX reference's output on seeded numpy inputs at
whisper's cross-attention lengths (1,500 keys, no tile's multiple), both
head sizes, GQA, every mask and rows that see no key; ``tile_plan`` and
``sm90_smem_bytes`` follow the D = 64 kernel's 128-key tiles and 3-slot
ring at 128-row tiles, which the source declares, while the backward's
plan keeps 64-key tiles.  The kernels are held against the plain versions on the card
(``tests/test_torch_on_card.py``, ``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops

# float32 inputs: the plain versions differ in summation order only
OUT_ATOL = 1e-5
LSE_ATOL = 1e-5


def visible_mask(Sq, Skv, causal, window, ncol=None):
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv if ncol is None else ncol)[None, :]
    mask = (kpos < Skv) & np.ones((Sq, 1), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def check_split_plan(B, Sq, Skv, H, Hkv, D, causal, window,
                     sms=FA.H100_SMS):
    plan = FA.split_plan(B, Sq, Skv, H, Hkv, D, causal, window, sms=sms)
    rows = Sq * (H // Hkv)
    assert plan.rows == rows
    assert plan.mt == (1 if rows <= 16 else 4)
    assert plan.row_blocks == max(1, -(-rows // (16 * plan.mt)))
    assert plan.grid == (plan.n_split, Hkv, B * plan.row_blocks)
    # the ranges: contiguous, in order, covering the visible tiles; the
    # combine folds them in this order
    ranges = plan.ranges
    assert len(ranges) == plan.n_split >= 1
    assert ranges[0][0] == plan.j0
    assert ranges[-1][1] == plan.j0 + plan.n_tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(t1 > t0 for t0, t1 in ranges) or plan.n_tiles == 0
    # the most ranges whose CTAs fit SPLIT_WAVES waves, at most one a tile
    ctas = B * Hkv * plan.row_blocks
    assert plan.n_split == max(1, min(plan.n_tiles,
                                      FA.SPLIT_WAVES * sms // ctas))
    assert plan.n_split == 1 or plan.n_split * ctas <= FA.SPLIT_WAVES * sms
    # every visible (row, key) pair in exactly one range, and nothing else
    n = plan.walk()
    ncol = n.shape[-1]
    vis = visible_mask(Sq, Skv, causal, window, ncol)
    assert (n.sum(0) == vis).all()
    for s, (t0, t1) in enumerate(ranges):
        outside = np.ones(ncol, bool)
        outside[t0 * plan.bc:t1 * plan.bc] = False
        assert not n[s][:, outside].any()
    return plan


# B, Sq, Skv, H, Hkv, D, causal, window
SPLIT_GRID = [
    (8, 1, 1500, 8, 8, 64, False, None),     # whisper's cross, decode
    (8, 4, 1500, 8, 8, 64, False, None),     # its 4-token prefill
    (1, 1, 4096, 32, 8, 128, True, None),    # GQA decode over 4,096 keys
    (1, 4, 1500, 32, 8, 128, True, 700),     # 16 rows, causal and window
    (2, 16, 1500, 8, 8, 64, True, None),
    (1, 16, 1500, 32, 8, 128, False, None),  # 64 rows: 4 m16 tiles
    (1, 40, 300, 8, 2, 64, True, 100),       # 160 rows: 3 row blocks
    (1, 4, 2, 4, 1, 128, True, None),        # rows 0, 1 see no key
    (3, 2, 1500, 4, 4, 64, True, 0),         # no row sees a key
    (1, 1, 64, 8, 8, 128, False, None),      # one tile
]


@pytest.mark.parametrize("case", SPLIT_GRID)
def test_split_plan_walks_each_visible_pair_once(case):
    check_split_plan(*case)


def test_split_plan_at_whisper_decode():
    """B x Hkv = 64 KV heads: 2 ranges of the 12 tiles of 128 keys (128
    CTAs, a wave of 132 SMs), one m16 tile a CTA; only the ragged last
    tile (1,500 = 11 x 128 + 92) takes the element mask."""
    assert FA.SPLIT_BC == 128 and FA.SPLIT_WAVES == 1
    plan = check_split_plan(8, 1, 1500, 8, 8, 64, False, None)
    assert (plan.j0, plan.n_tiles, plan.n_split, plan.mt) == (0, 12, 2, 1)
    assert plan.ranges == ((0, 6), (6, 12))
    assert plan.grid == (2, 8, 8)
    assert [t for t in range(12) if plan.masked(t)] == [11]
    # GQA over 4,096 keys: 8 KV heads, 16 ranges of 2 tiles
    gqa = check_split_plan(1, 1, 4096, 32, 8, 128, True, None)
    assert (gqa.rows, gqa.n_tiles, gqa.n_split) == (4, 32, 16)


@settings(max_examples=60, deadline=None)
@given(B=st.integers(1, 3), Sq=st.integers(1, 70), Skv=st.integers(1, 3000),
       heads=st.sampled_from([(1, 1), (8, 8), (8, 2), (6, 3), (32, 8)]),
       D=st.sampled_from([64, 128]), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(-40, 3000)),
       sms=st.sampled_from([8, 132]))
def test_split_plan_sweep(B, Sq, Skv, heads, D, causal, window, sms):
    H, Hkv = heads
    check_split_plan(B, Sq, Skv, H, Hkv, D, causal, window, sms=sms)


def test_route_rule_at_the_split_cut():
    """bf16 at head sizes 64 and 128 takes the split route up to
    SPLIT_ROWS query rows per KV head over more than one 128-key tile, and
    the wgmma kernel otherwise; without a row count (the backward's route)
    the wgmma kernel; float32 and head sizes 16 and 32 never split."""
    cut, tile = FA.SPLIT_ROWS, FA.SPLIT_BC
    assert (cut, tile) == (16, 128)
    for D in (64, 128):
        for rows in (1, cut):
            assert FA.route(torch.bfloat16, D, rows, tile + 1) == FA.SPLIT
            assert FA.route(torch.bfloat16, D, rows, tile) == FA.SM90
        assert FA.route(torch.bfloat16, D, cut + 1, 4096) == FA.SM90
        assert FA.route(torch.bfloat16, D) == FA.SM90
    for dt, D in ((torch.float32, 64), (torch.float32, 128),
                  (torch.bfloat16, 16), (torch.bfloat16, 32)):
        assert FA.route(dt, D, 1, 1500) == "flash_attention"
    # rows are Sq x H / Hkv, keys Skv
    q = torch.empty(4, 32, 128, dtype=torch.bfloat16)
    k = torch.empty(1500, 8, 128, dtype=torch.bfloat16)
    assert FA.call_route(q, k) == FA.SPLIT
    assert FA.call_route(q[:1], k) == FA.SPLIT
    assert FA.call_route(q[:1], k[:128]) == FA.SM90    # one tile of keys
    assert FA.call_route(q[:1], k[:129]) == FA.SPLIT
    assert FA.call_route(torch.empty(2, 64, 8, 64, dtype=torch.bfloat16),
                         torch.empty(2, 1500, 8, 64,
                                     dtype=torch.bfloat16)) == FA.SM90


def _inputs(B, Sq, Skv, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


# B, Sq, Skv, H, Hkv, D, causal, window: Sq 1 and 4 over 1,500 keys, D 64
# and 128, rep 1 and 4, every mask, rows that see no key
PLAIN_CASES = [
    (b, sq, 1500, h, hkv, d, causal, window)
    for sq in (1, 4) for d in (64, 128) for h, hkv in ((4, 4), (8, 2))
    for causal, window in ((False, None), (True, None), (True, 300),
                           (False, 1))
    for b in (2,)] + [
    (1, 4, 2, 8, 2, 64, True, None),         # rows 0, 1 see no key
    (2, 4, 1500, 4, 4, 128, True, 0),        # no row sees a key
    (1, 3, 1500, 8, 2, 64, False, -5)]


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_split_plain_equals_plain_and_the_reference(case):
    B, Sq, Skv, H, Hkv, D, causal, window = case
    q, k, v = _inputs(B, Sq, Skv, H, Hkv, D, seed=Sq * 7 + D + H)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(causal=causal, window=window)
    got, lse = FA.flash_attention_split_plain(tq, tk, tv, with_lse=True,
                                              **kw)
    want, want_lse = FA.flash_attention_plain(tq, tk, tv, with_lse=True,
                                              **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= OUT_ATOL
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), seen)
    assert torch.equal(lse[~seen], want_lse[~seen])
    if seen.any():
        assert float((lse[seen] - want_lse[seen]).abs().max()) <= LSE_ATOL
    # a row that sees no key is exactly 0
    rows_seen = seen.permute(0, 2, 1)[..., None].expand_as(got)
    assert bool((got[~rows_seen] == 0).all())
    ref = np.stack([np.asarray(jref.flash_attention_ref(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), **kw))
        for a, b, c in zip(q, k, v)])
    assert np.abs(got.numpy() - ref).max() <= OUT_ATOL
    # without a batch dimension: a batch of one
    one = FA.flash_attention_split_plain(tq[0], tk[0], tv[0], **kw)
    assert torch.equal(one, FA.flash_attention_split_plain(
        tq[:1], tk[:1], tv[:1], **kw)[0])


def test_split_source_mirrors_the_plan():
    """split_plan's tile width is the kernel's split::BC."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert re.search(rf"constexpr int BC = {FA.SPLIT_BC};\s+// keys per "
                     rf"K/V tile", src)


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_split_plain_does_not_depend_on_the_cut(sms):
    """The ranges change with the SM count; the result stays within
    float32 rounding of the plain version."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 4, 1500, 8, 2, 64,
                                                       seed=3))
    want = FA.flash_attention_plain(q, k, v, causal=False)
    got = FA.flash_attention_split_plain(q, k, v, causal=False, sms=sms)
    assert float((got - want).abs().max()) <= OUT_ATOL


def test_cpu_split_shapes_take_the_plain_version_and_count_nothing():
    """On the CPU a call the split route would take on the card is the
    plain version, bf16 in and out, and no launch counter moves."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 8, 64, generator=g).bfloat16()
    k = torch.randn(2, 1500, 8, 64, generator=g).bfloat16()
    assert FA.call_route(q, k) == FA.SPLIT
    kops.reset_launch_counts()
    got = FA.flash_attention(q, k, k, causal=False)
    assert torch.equal(got, FA.flash_attention_plain(q, k, k, causal=False))
    o, lse = FA.flash_attention_lse(q, k, k, causal=False)
    assert torch.equal(o, got)
    assert lse.shape == (2, 8, 1)
    assert (FA.flash_attention.launches, FA.flash_attention.launches_sm90,
            FA.flash_attention.launches_split) == (0, 0, 0)
    with pytest.raises(ValueError, match="head sizes"):
        FA.split_plan(1, 1, 100, 4, 4, 32)


# ------------------------------------------------ the D = 64 sm90 tiles
def _source_tiles():
    src = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    return {(int(d), 64 * int(nc)): (int(bc), int(st))
            for d, nc, bc, st in re.findall(
                r"struct Tiles<(\d+), (\d)> \{\n  static constexpr int BC = "
                r"(\d+), STAGES = (\d+);", src)}


def test_sm90_tiles_mirror_the_source():
    """tile_plan's and sm90_smem_bytes' tile widths and ring depths are
    the source's Tiles<D, NC>: D = 64 at 128-row tiles takes 128-key tiles
    and 3 slots; D = 128, and 64-row tiles, keep 64 keys and 2 slots."""
    assert _source_tiles() == FA.SM90_TILES
    assert FA.SM90_TILES == {(64, 64): (64, 2), (64, 128): (128, 3),
                             (128, 64): (64, 2), (128, 128): (64, 2)}
    assert FA.sm90_bc(64, 128) == 128 and FA.sm90_bc(64, 64) == 64


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("br", [64, 128])
def test_sm90_smem_bytes_follow_the_tiles(D, br):
    bc, stages = FA.SM90_TILES[(D, br)]
    assert FA.sm90_smem_bytes(D, br) == 2 * (
        br * D + 2 * stages * bc * D + br * D) + 8 * (2 + 4 * stages) + 1024
    assert FA.sm90_smem_bytes(D, br) <= 232448    # a CTA's shared memory


# B, Sq, Skv, H, Hkv, causal, window: hymba's prefill, whisper's encoder
D64_SHAPES = [(1, 2750, 2750, 25, 5, True, 2048),
              (1, 2750, 2750, 25, 5, True, None),
              (8, 1500, 1500, 8, 8, False, None),
              (2, 3072, 3072, 25, 5, True, 2048)]


@pytest.mark.parametrize("case", D64_SHAPES)
def test_tile_plan_at_d64_walks_the_new_tiles(case):
    """At D = 64 and 128-row tiles the forward walks KV tiles of 128 keys,
    each q tile's visible pairs inside them; the backward's plan at the
    same shape keeps its 64-key tiles."""
    from test_torch_flash import check_plan
    B, Sq, Skv, H, Hkv, causal, window = case
    plan = check_plan(B, Sq, Skv, H, Hkv, 64, causal, window)
    assert plan.br == 128 and plan.bc == FA.sm90_bc(64, 128) == 128
    bwd = FA.bwd_plan(B, Sq, Skv, H, Hkv, 64, causal, window)
    assert bwd.tile == FA.BWD_TILE == 64
    n_fwd = max(j for t in plan.kv.values() for j, _ in t) + 1
    assert n_fwd == -(-Skv // plan.bc)
    assert max(bwd.kv_order) + 1 == -(-Skv // 64)
