"""The sm90 flash-attention kernel's schedule and routing, on the CPU.

``kernels/flash_attention.py::tile_plan`` is a pure-Python mirror of
``csrc/flash_attention_sm90.cu``'s schedule: the tile height, the
longest-first work list over (batch, head, q tile) and, per q tile, the KV
tiles it visits and which of them take the element mask.  These tests hold
it to the attention contract (end-aligned positions, causal and window
masks, ragged ``Sq``/``Skv`` in both directions, a leading batch) on a
fixed grid and a hypothesis sweep.  The ``cuda``-marked tests run both
kernels against the plain version on the card and skip without one; this
file imports no JAX, so ``python -m pytest -m cuda tests/test_torch_flash.py``
runs on the card's machine as it is.
"""

import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops

ROOT = Path(__file__).resolve().parents[1]


def visible_mask(Sq, Skv, causal, window):
    """(Sq, Skv) bool: key j visible to query row i (row i at Skv-Sq+i)."""
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def first_kernel_tiles(Sq, Skv, causal, window, r0, r1, bc):
    """KV tiles the first kernel's walk (flash_attention.cu: kv_range and
    its loop) visits for rows [r0, r1) at tile size bc."""
    has_window, win = FA._window_arg(window, Sq, Skv)
    off = Skv - Sq
    lo, hi = 0, Skv
    if causal:
        hi = min(hi, off + r1)
    if has_window:
        lo = max(lo, off + r0 - win + 1)
    return len(range((lo // bc) * bc, hi, bc))


def check_plan(B, Sq, Skv, H, Hkv, D, causal, window, sms=FA.H100_SMS):
    plan = FA.tile_plan(B, Sq, Skv, H, Hkv, D, causal, window, sms=sms)
    br, bc = plan.br, plan.bc
    nqt = -(-Sq // br)
    assert br in (64, 128) and bc == FA.sm90_bc(D, br)
    assert br == (128 if B * H * -(-Sq // 128) >= sms // 2 else 64)
    # every output tile exactly once
    assert len(plan.work) == B * H * nqt
    assert set(plan.work) == {(b, h, t) for b in range(B) for h in range(H)
                              for t in range(nqt)}
    assert sorted(plan.q_order) == list(range(nqt))
    # the kernel's index map: idx -> (order[idx // BH], h fastest)
    for idx in range(0, len(plan.work), max(1, len(plan.work) // 50)):
        rem = idx % (B * H)
        assert plan.work[idx] == (rem // H, rem % H,
                                  plan.q_order[idx // (B * H)])
    mask = visible_mask(Sq, Skv, causal, window)
    lengths = []
    for qt in plan.q_order:
        r0, r1 = qt * br, min(qt * br + br, Sq)
        tiles = [j for j, _ in plan.kv[qt]]
        assert tiles == list(range(tiles[0], tiles[-1] + 1)) if tiles \
            else True
        rows = mask[r0:r1]
        # every visible (q, k) pair lies in a visited tile
        seen = set(np.unique(np.nonzero(rows)[1] // bc).tolist())
        assert seen <= set(tiles), (qt, sorted(seen - set(tiles)))
        # a tile marked unmasked is fully visible and inside Skv
        for j, masked in plan.kv[qt]:
            if not masked:
                assert (j + 1) * bc <= Skv
                assert rows[:, j * bc:(j + 1) * bc].all()
        # never more tiles than the first kernel's walk at this tile size
        assert len(tiles) <= first_kernel_tiles(Sq, Skv, causal, window,
                                                r0, r1, bc)
        lengths.append(len(tiles))
    # longest first, over the q tiles and so over the work list
    assert lengths == sorted(lengths, reverse=True)
    work_len = [len(plan.kv[t]) for _, _, t in plan.work]
    assert all(a >= b for a, b in zip(work_len, work_len[1:]))
    return plan


# Sq, Skv, H, Hkv, D, causal, window, B
GRID = [
    (1024, 1024, 32, 8, 128, True, None, 1),   # serving buckets
    (512, 512, 32, 8, 128, True, 2048, 1),
    (256, 256, 32, 8, 128, True, None, 1),
    (128, 128, 32, 8, 128, True, None, 1),
    (4096, 4096, 8, 2, 64, True, 1000, 1),     # ring-stress shapes
    (300, 333, 8, 2, 128, True, None, 1),
    (1, 2048, 8, 2, 64, True, None, 1),
    (257, 257, 8, 2, 128, True, None, 3),
    (100, 100, 8, 2, 64, True, None, 1),       # first kernel's sweep
    (64, 192, 8, 1, 128, True, 48, 1),
    (128, 128, 4, 2, 64, False, None, 1),
    (48, 16, 4, 2, 64, True, None, 1),         # Sq > Skv: masked rows
    (200, 200, 8, 8, 128, True, 17, 1),
    (130, 70, 8, 1, 64, False, 20, 1),
    (100, 100, 4, 1, 64, True, 0, 1),          # nothing visible
    (70, 90, 8, 2, 128, True, 33, 1),
    (1024, 1024, 64, 8, 112, True, None, 1),   # kimi-k2's prefill
    (1, 2048, 64, 8, 112, True, None, 1),      # a short query at 112
]


@pytest.mark.parametrize("Sq,Skv,H,Hkv,D,causal,window,B", GRID)
def test_tile_plan_grid(Sq, Skv, H, Hkv, D, causal, window, B):
    check_plan(B, Sq, Skv, H, Hkv, D, causal, window)


def test_tile_plan_serving_shapes():
    """The serving prefill: 128-row tiles from S = 512 on (128 tiles, at
    least half of the 132 SMs), 64-row tiles below it; causal tiles are
    masked only on the diagonal, so a q tile ends on the br / bc KV tiles
    its diagonal crosses."""
    for S, br in ((128, 64), (256, 64), (512, 128), (1024, 128),
                  (2048, 128)):
        plan = check_plan(1, S, S, 32, 8, 128, True, None)
        assert plan.br == br
        for qt, tiles in plan.kv.items():
            masked = [m for _, m in tiles]
            assert masked.count(True) == br // plan.bc
            assert all(masked[-(br // plan.bc):])
    plan = FA.tile_plan(1, 1024, 1024, 32, 8, 128)
    assert plan.q_order == tuple(range(7, -1, -1))
    assert plan.work[:4] == [(0, 0, 7), (0, 1, 7), (0, 2, 7), (0, 3, 7)]
    # csrc/flash_attention_sm90.cu's Smem<128, 2>: q, 2 x (k, v) of 64
    # keys, o, 10 mbarriers, alignment slack
    assert FA.sm90_smem_bytes(128, plan.br) == 2 * (
        128 * 128 + 2 * 2 * 64 * 128 + 128 * 128) + 80 + 1024


@pytest.mark.parametrize("S,H,grid", [(1024, 32, 132), (512, 32, 132),
                                      (2048, 32, 132), (300, 8, 7)])
def test_snake_assignment_balances_the_triangle(S, H, grid):
    """Each item goes to exactly one CTA, and the snake's busiest CTA walks
    no more KV tiles than under plain striding (c, c + grid, ...); at the
    1024-token bucket 18 against 24, where the mean is 17.5."""
    plan = FA.tile_plan(1, S, S, H, H // 4 or 1, 128)
    items = plan.cta_items(grid)
    assert sorted(i for c in items for i in c) == list(range(len(plan.work)))
    cost = [len(plan.kv[t]) for _, _, t in plan.work]
    snake = max(sum(cost[i] for i in c) for c in items)
    stride = max(sum(cost[c::grid]) for c in range(grid))
    assert snake <= stride
    if (S, grid) == (1024, 132):
        assert (snake, stride) == (18, 24)


def test_tile_plan_window_order_is_not_row_order():
    """Non-causal with a window: early rows see the most keys, so the
    longest-first order ends on the last q tile, not on tile 0."""
    plan = check_plan(1, 1000, 1000, 4, 4, 64, False, 300)
    n = len(plan.q_order)
    assert plan.q_order[-1] == n - 1
    assert plan.q_order != tuple(range(n - 1, -1, -1))


@settings(max_examples=80, deadline=None)
@given(Sq=st.integers(1, 700), Skv=st.integers(1, 700),
       heads=st.sampled_from([(1, 1), (4, 1), (8, 2), (6, 3), (32, 8)]),
       D=st.sampled_from([64, 112, 128]), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(-40, 900)),
       B=st.integers(1, 3), sms=st.sampled_from([8, 132]))
def test_tile_plan_sweep(Sq, Skv, heads, D, causal, window, B, sms):
    H, Hkv = heads
    check_plan(B, Sq, Skv, H, Hkv, D, causal, window, sms=sms)


def test_route_rule():
    for dt in (torch.float32, torch.bfloat16):
        for D in FA.HEAD_DIMS:
            want = FA.SM90 if dt == torch.bfloat16 and D in (64, 112, 128) \
                else "flash_attention"
            assert FA.route(dt, D) == want
            # a KV head's query rows: the split route up to SPLIT_ROWS over
            # more than one of its key tiles, at head sizes 64 and 128 (112
            # stays on the wgmma kernel)
            for rows in (1, FA.SPLIT_ROWS, FA.SPLIT_ROWS + 1, 4096):
                for keys in (1, FA.SPLIT_BC, FA.SPLIT_BC + 1, 4096):
                    short = want == FA.SM90 and D in (64, 128) \
                        and rows <= FA.SPLIT_ROWS and keys > FA.SPLIT_BC
                    assert FA.route(dt, D, rows, keys) == \
                        (FA.SPLIT if short else want)
    assert set(FA.ROUTES) == {FA.SM90, FA.SPLIT, "flash_attention"}


def test_cpu_call_is_plain_and_counts_nothing():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(40, 4, 64, generator=g).bfloat16()
    k = torch.randn(50, 2, 64, generator=g).bfloat16()
    kops.reset_launch_counts()
    got = FA.flash_attention(q, k, k, window=9)
    assert torch.equal(got, FA.flash_attention_plain(q, k, k, window=9))
    assert FA.flash_attention.launches == 0
    assert FA.flash_attention.launches_sm90 == 0
    assert FA.flash_attention.launches_split == 0


# ----------------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on "
                    "the card")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return torch.device("cuda"), importlib.import_module("chip_smoke")


CARD_CASES = [  # B, Sq, Skv, H, Hkv, causal, window
    (1, 1024, 1024, 32, 8, True, None), (1, 300, 333, 8, 2, True, None),
    (1, 1, 2048, 8, 2, True, None), (3, 257, 257, 8, 2, True, None),
    (1, 48, 16, 4, 2, True, None), (1, 130, 70, 8, 1, False, 20),
    (1, 2048, 2048, 8, 2, True, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 64, 112, 128])
@pytest.mark.parametrize("case", CARD_CASES)
def test_cuda_flash_routes_match_plain(card, D, case):
    dev, smoke = card
    B, Sq, Skv, H, Hkv, causal, window = case
    rng = np.random.default_rng(Sq + Skv + D)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               device=dev).bfloat16()
    q, k, v = rand(B, Sq, H, D), rand(B, Skv, Hkv, D), rand(B, Skv, Hkv, D)
    before = (FA.flash_attention.launches_sm90,
              FA.flash_attention.launches_split)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    took = FA.call_route(q, k)
    assert (FA.flash_attention.launches_sm90 - before[0],
            FA.flash_attention.launches_split - before[1]) == \
        (took == FA.SM90, took == FA.SPLIT)
    smoke.flash_check(got, want, f"D{D} {case}")
    assert smoke.same_raw_bits(
        got, FA.flash_attention(q, k, v, causal=causal, window=window))
    if causal and Sq > Skv:
        assert bool((got[:, : Sq - Skv] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112, 128])
def test_cuda_flash_p_layout_one_hot(card, D):
    """Row i puts all its weight on key pi(i): a logit of 64 against 0 or
    -64 elsewhere.  The output row must be v[pi(i)], so a P fragment that
    reached the wrong row or key of the P V product shows at once."""
    dev, _ = card
    Skv = 2 * D                         # keys +e_d and -e_d, d < D
    rng = np.random.default_rng(D)
    pi = rng.integers(0, Skv, 200)
    k = np.zeros((Skv, 1, D), np.float32)
    k[np.arange(Skv), 0, np.arange(Skv) % D] = np.where(
        np.arange(Skv) < D, 8.0, -8.0)
    q = np.zeros((200, 1, D), np.float32)
    q[np.arange(200), 0, pi % D] = np.where(pi < D, 8.0, -8.0)
    v = rng.standard_normal((Skv, 1, D)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(a, device=dev).bfloat16()
                  for a in (q, k, v))
    got = FA.flash_attention(tq, tk, tv, causal=False, scale=1.0)
    want = tv.float()[pi]
    assert float((got.float() - want).abs().max()) <= \
        0.01 * float(want.abs().max())


@pytest.mark.cuda
def test_cuda_flash_sm90_faster_than_first_kernel(card):
    dev, smoke = card
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1024, 32, 128, generator=g, device=dev).bfloat16()
    k = torch.randn(1024, 8, 128, generator=g, device=dev).bfloat16()
    ms = {r: smoke.call_ms(lambda r=r: FA.launch_kernel(r, q, k, k), dev, 20)
          for r in (FA.SM90, "flash_attention")}
    assert ms[FA.SM90] < ms["flash_attention"], ms
    assert math.isfinite(ms[FA.SM90])
