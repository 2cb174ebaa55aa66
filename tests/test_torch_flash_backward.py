"""Row 8's backward on the CPU.

``flash_attention_backward_plain`` (the plain version of
``csrc/flash_attention_bwd.cu``'s two kernels) is held against ``jax.grad``
of the reference's ``ref.flash_attention_ref`` and against autograd through
``flash_attention_plain``, in float32 within 1e-5 relative, on the same
seeded inputs: causal, window and unmasked, GQA 4/2 and 4/4, Sq < Skv and
Sq = Skv at lengths that are not multiples of 64, batched and not, head
sizes 16, 64 and 112 (kimi-k2's, GQA 8:1), and rows that see no key (Sq > Skv causal), whose
gradients must be 0.  ``bwd_plan(...).walk()`` must take exactly the
visible (query, key) pairs, each once per query head, in both kernels, over
a fixed grid and a hypothesis sweep.  ``FlashAttention`` on CPU tensors
takes the plain backward and launches nothing; the backward operator's
fake and FLOP formula serve the dry run.  The kernels themselves are held
against the plain backward on the card, in ``tests/test_torch_on_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops

REL = 1e-5

CASES = [  # B, Sq, Skv, H, Hkv, D, causal, window
    (None, 70, 70, 4, 2, 16, True, None),
    (2, 45, 130, 4, 4, 64, True, None),
    (None, 90, 90, 4, 4, 64, True, 33),
    (None, 50, 77, 4, 2, 16, False, 20),
    (2, 65, 65, 4, 2, 16, False, None),
    (None, 30, 100, 4, 4, 64, False, None),
    (None, 100, 40, 4, 2, 64, True, None),      # rows 0..59 see no key
    (2, 80, 50, 4, 4, 16, True, 16),           # rows 0..29 see no key
    (None, 96, 96, 8, 1, 112, True, None),      # kimi-k2: GQA 8:1 of 112
    (2, 40, 75, 8, 1, 112, True, 30),
]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb else \
        float(np.linalg.norm(a - b))


def inputs(case, seed=0):
    B, Sq, Skv, H, Hkv, D, causal, window = case
    rng = np.random.default_rng(seed + Sq * 7 + Skv)
    lead = (B,) if B else ()
    q = rng.standard_normal(lead + (Sq, H, D)).astype(np.float32)
    k = rng.standard_normal(lead + (Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal(lead + (Skv, Hkv, D)).astype(np.float32)
    do = rng.standard_normal(lead + (Sq, H, D)).astype(np.float32)
    return q, k, v, do


def visible(Sq, Skv, causal, window, ncol=None):
    """(Sq, ncol) bool: key j visible to row i (row i at Skv - Sq + i)."""
    ncol = Skv if ncol is None else ncol
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(ncol)[None, :]
    mask = (kpos < Skv) & np.ones((Sq, 1), bool)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def jax_grads(q, k, v, do, causal, window):
    def loss(q, k, v):
        f = lambda q, k, v: jref.flash_attention_ref(  # noqa: E731
            q, k, v, causal=causal, window=window)
        out = jax.vmap(f)(q, k, v) if q.ndim == 4 else f(q, k, v)
        return jnp.sum(out * do)
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad_and_autograd(case):
    _, Sq, Skv, _, _, _, causal, window = case
    q, k, v, do = inputs(case)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(do)
    o = FA.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    auto = torch.autograd.grad(o, (tq, tk, tv), tdo)
    got = FA.flash_attention_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), o.detach(), tdo,
        causal=causal, window=window)
    want = jax_grads(q, k, v, do, causal, window)
    for name, g, a, w in zip("qkv", got, auto, want):
        assert g.shape == a.shape and g.dtype == torch.float32, name
        assert g.is_contiguous(), name
        assert bool(torch.isfinite(g).all()), name
        assert rel(g, a) <= REL, (name, rel(g, a))
        assert rel(g, w) <= REL, (name, rel(g, w))
    seen = visible(Sq, Skv, causal, window).any(axis=1)
    dq = got[0].numpy()
    assert not (dq[..., ~seen, :, :] != 0).any()
    if causal and Sq > Skv:
        assert not seen.all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_on_cpu_takes_the_plain_backward(dtype):
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in inputs(CASES[0], seed=3))
    kops.reset_launch_counts()
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    y = kops.flash_attention(tq, tk, tv, causal=True)
    assert "FlashAttention" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, (tq, tk, tv), do)
    want = FA.flash_attention_backward_plain(q, k, v, y.detach(), do)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.is_contiguous()
        assert torch.equal(g, w)
        assert g.shape == x.shape
    assert FA.flash_attention_backward.launches == 0
    assert set(kops.launch_counts().values()) == {0}


def test_function_returns_only_the_gradients_asked_for():
    q, k, v, do = (torch.from_numpy(x) for x in inputs(CASES[1], seed=4))
    tk = k.clone().requires_grad_()
    y = FA.FlashAttention.apply(q, tk, v, True, None, None)
    (gk,) = torch.autograd.grad(y, (tk,), do)
    want = FA.flash_attention_backward_plain(q, k, v, y.detach(), do)
    assert torch.equal(gk, want[1])


def test_backward_operator_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in inputs(CASES[0]))
    o = FA.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="is not like q"):
        FA.flash_attention_backward(q, k, v, o[:-1], do)
    with pytest.raises(ValueError, match="is not like q"):
        FA.flash_attention_backward(q, k, v, o, do.double())
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention_backward(q[:, :3], k, v, o[:, :3], do[:, :3])


def test_backward_operator_fake_and_flops():
    """The dry run's FakeTensorMode allocates the three gradients without
    running anything, and FlopCounterMode counts 10 B Sq Skv H D."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    B, Sq, Skv, H, Hkv, D = 2, 45, 130, 4, 4, 64
    with FakeTensorMode():
        q = torch.empty(B, Sq, H, D, dtype=torch.bfloat16)
        k = torch.empty(B, Skv, Hkv, D, dtype=torch.bfloat16)
        out = FA.flash_attention_backward(q, k, k, q, q)
        assert [tuple(t.shape) for t in out] == [(B, Sq, H, D),
                                                 (B, Skv, Hkv, D),
                                                 (B, Skv, Hkv, D)]
    q, k, v, do = (torch.from_numpy(x) for x in inputs(CASES[1]))
    o = FA.flash_attention_plain(q, k, v)
    with FlopCounterMode(display=False) as fc:
        FA.flash_attention_backward(q, k, v, o, do)
    assert fc.get_total_flops() == 10 * B * Sq * Skv * H * D \
        == FA.flash_bwd_flops(q.shape, k.shape)


# ---------------------------------------------------------------- the plan
def check_bwd_plan(B, Sq, Skv, H, Hkv, D, causal, window,
                   dtype=torch.bfloat16, tiles=None):
    """The plan of the route ``dtype`` and D take (bf16 at head sizes 64
    and 128: the sm90 route, one dkdv CTA per KV head unless it splits;
    else the mma.sync route's, one per query head)."""
    plan = FA.bwd_plan(B, Sq, Skv, H, Hkv, D, causal, window, dtype=dtype,
                       tiles=tiles)
    T = plan.tile
    assert T == 64
    if dtype == torch.bfloat16 and D in (64, 128):
        assert plan.route == "sm90"
        assert (plan.dq_rows, plan.split) == (
            tiles or FA.bwd_tiles(B, Sq, Skv, H, Hkv, D))
    else:
        assert plan.route == "mma"
        assert (plan.dq_rows, plan.split) == (T, H > Hkv)
    nqt, nkt = -(-Sq // plan.dq_rows), -(-Skv // T)
    assert plan.dq_grid == (nqt, H, B)
    assert plan.dkdv_grid == (nkt, H if plan.split else Hkv, B)
    assert plan.reduce == plan.split and (H > Hkv or not plan.split)
    assert sorted(plan.q_order) == list(range(nqt))
    assert sorted(plan.kv_order) == list(range(nkt))
    # longest first
    dq_len = [len(plan.dq_walk[t]) for t in plan.q_order]
    kv_len = [len(plan.dkdv_walk[j]) for j in plan.kv_order]
    assert dq_len == sorted(dq_len, reverse=True)
    assert kv_len == sorted(kv_len, reverse=True)
    # one fixed order: tiles ascending and contiguous
    for walk in (*plan.dq_walk.values(), *plan.dkdv_walk.values()):
        ts = [t for t, _ in walk]
        assert ts == list(range(ts[0], ts[0] + len(ts))) if ts else True
    # the walks take exactly the visible pairs, once per query head
    got = plan.walk()
    ncol = nkt * T
    want = visible(Sq, Skv, causal, window, ncol).astype(np.int32)
    for name in ("dq", "dkdv"):
        assert got[name].shape == (H, Sq, ncol)
        assert (got[name] == want[None]).all(), name
    return plan


GRID = [  # B, Sq, Skv, H, Hkv, causal, window
    (1, 1024, 1024, 8, 2, True, None), (1, 3000, 3000, 2, 1, True, 2048),
    (2, 448, 1500, 2, 2, False, None), (1, 100, 40, 4, 2, True, None),
    (1, 1, 300, 4, 2, True, None), (1, 64, 64, 2, 1, True, 1),
    (3, 130, 70, 4, 4, False, 20), (1, 200, 200, 4, 2, True, 0),
    (1, 129, 257, 6, 3, True, -5), (1, 65, 65, 1, 1, False, 500),
]


@pytest.mark.parametrize("case", GRID)
def test_bwd_plan_walks_the_visible_pairs(case):
    B, Sq, Skv, H, Hkv, causal, window = case
    check_bwd_plan(B, Sq, Skv, H, Hkv, 64, causal, window)


def test_bwd_plan_causal_goes_longest_first():
    plan = FA.bwd_plan(1, 1024, 1024, 32, 8, 128, True, None,
                       dtype=torch.float32)
    assert plan.q_order == tuple(range(15, -1, -1))
    assert plan.kv_order == tuple(range(16))
    assert [m for _, (m,) in plan.dq_walk[3]] == [False] * 3 + [True]
    assert [m for _, m in plan.dkdv_walk[12]] == [True] + [False] * 3
    # the sm90 route: 128-row dq tiles, a mask for each 64-row half
    plan = FA.bwd_plan(1, 1024, 1024, 32, 8, 128, True, None)
    assert (plan.dq_rows, plan.split) == (128, True)
    assert plan.q_order == tuple(range(7, -1, -1))
    assert plan.kv_order == tuple(range(16))
    assert [m for _, m in plan.dq_walk[1]] == [(False, False)] * 2 + [
        (True, False), (True, True)]
    assert [m for _, m in plan.dkdv_walk[12]] == [True] + [False] * 3


def test_bwd_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="head sizes"):
        FA.bwd_plan(1, 64, 64, 4, 2, 48)
    with pytest.raises(ValueError, match="multiple"):
        FA.bwd_plan(1, 64, 64, 4, 3, 64)


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 300), Skv=st.integers(1, 300),
       heads=st.sampled_from([(1, 1), (4, 1), (4, 2), (6, 3), (4, 4)]),
       D=st.sampled_from(FA.HEAD_DIMS), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(-40, 400)),
       B=st.integers(1, 2),
       dtype=st.sampled_from([torch.bfloat16, torch.float32]),
       tiles=st.one_of(st.none(), st.tuples(st.sampled_from([64, 128]),
                                            st.booleans())))
def test_bwd_plan_sweep(Sq, Skv, heads, D, causal, window, B, dtype, tiles):
    """Both routes, the sm90 route at every tile choice too."""
    H, Hkv = heads
    if tiles is not None and (dtype != torch.bfloat16 or D < 64
                              or (tiles[1] and H == Hkv)):
        tiles = None
    check_bwd_plan(B, Sq, Skv, H, Hkv, D, causal, window, dtype, tiles)


SHARED_HELPERS = ("pack_bf16", "ld32", "mma_bf16", "ldmatrix_x4_trans")


@pytest.mark.parametrize("source", ["flash_attention", "flash_attention_bwd"])
def test_flash_sources_share_one_copy_of_the_fragment_helpers(source):
    """Both mma.sync flash sources include csrc/mma_fragments.cuh and
    define none of its helpers themselves."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{source}.cu").read_text()
    head = (_build.CSRC / "mma_fragments.cuh").read_text()
    assert '#include "mma_fragments.cuh"' in src
    for name in SHARED_HELPERS:
        pat = rf"__forceinline__ [\w:]+ {name}\("
        assert re.search(pat, head), name
        assert not re.search(pat, src), name


def test_editing_the_shared_header_rebuilds_both_flash_sources(
        tmp_path, monkeypatch):
    """A library's name hashes the headers its source includes: an edit of
    mma_fragments.cuh renames the two flash libraries that include it, and
    no other."""
    import shutil
    from repro_torch.kernels import _build
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    head = tmp_path / "mma_fragments.cuh"
    head.write_text(head.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if before[n] != after[n]} == \
        {"flash_attention", "flash_attention_bwd"}
