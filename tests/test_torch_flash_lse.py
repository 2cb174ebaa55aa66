"""The forward's saved log-sum-exp and the sm90 backward's plan, on the CPU.

The training forward keeps each row's base-2 log-sum-exp (LSE) of
``scale log2(e) q k^T`` for the backward's sm90 route
(``csrc/flash_attention_bwd.cu``), which reads it in place of a second
q k^T sweep.  Here: the plain forward's LSE equals ``log2(e) logsumexp``
of the masked scores (-inf on rows that see no key) and, through the
output it implies, the JAX reference ``ref.flash_attention_ref`` on the
same seeded numpy inputs; ``FlashAttention`` asks for it only under grad
and only where the backward takes the sm90 route, and its gradients stay
the plain backward's; the forward-with-LSE operator's fake and FLOP count
serve the dry run, whose count is unchanged; ``bwd_plan``'s grid of one
dkdv CTA per KV head, walking its query heads in order, takes every
visible pair once, and so does the per-query-head grid the plan keeps
where the former would leave SMs idle.  The kernels themselves are held
against the plain versions on the card (``tests/test_torch_on_card.py``).
"""

import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops

LSE_ATOL = 1e-5  # float32 statistics, base 2
OUT_ATOL = 1e-5

CASES = [  # B, Sq, Skv, H, Hkv, D, causal, window
    (None, 70, 70, 4, 2, 16, True, None),
    (2, 45, 130, 4, 4, 64, True, None),
    (None, 90, 90, 4, 4, 64, True, 33),
    (None, 50, 77, 4, 2, 16, False, 20),
    (None, 100, 40, 4, 2, 64, True, None),      # rows 0..59 see no key
    (2, 80, 50, 4, 4, 16, True, 16),           # rows 0..29 see no key
]


def inputs(case, seed=0):
    B, Sq, Skv, H, Hkv, D, causal, window = case
    rng = np.random.default_rng(seed + 3 * Sq + Skv)
    lead = (B,) if B else ()
    q = rng.standard_normal(lead + (Sq, H, D)).astype(np.float32)
    k = rng.standard_normal(lead + (Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal(lead + (Skv, Hkv, D)).astype(np.float32)
    return q, k, v


def masked_scores(q, k, causal, window):
    """(B, H, Sq, Skv) float64 scale q k^T, -inf where not visible."""
    q, k = (x if x.ndim == 4 else x[None] for x in (q, k))
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(D)
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return np.where(mask, s, -np.inf)


@pytest.mark.parametrize("case", CASES)
def test_plain_lse_is_base2_logsumexp_of_the_masked_scores(case):
    B, Sq, Skv, H, Hkv, D, causal, window = case
    q, k, v = inputs(case)
    o, lse = FA.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, with_lse=True)
    assert lse.dtype == torch.float32
    assert tuple(lse.shape) == ((B,) if B else ()) + (H, Sq)
    assert torch.equal(o, FA.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window))
    s = masked_scores(q, k, causal, window)
    with np.errstate(divide="ignore"):
        m = s.max(-1, keepdims=True)
        want = (np.log(np.exp(s - np.where(np.isfinite(m), m, 0)).sum(-1))
                + np.where(np.isfinite(m), m, 0)[..., 0]) / np.log(2)
    want = np.where(np.isfinite(m[..., 0]), want, -np.inf)
    got = lse.numpy() if B else lse.numpy()[None]
    seen = np.isfinite(want)
    assert (np.isneginf(got) == ~seen).all()
    assert np.abs(got[seen] - want[seen]).max() <= LSE_ATOL
    if causal and Sq > Skv:
        assert not seen.all()


@pytest.mark.parametrize("case", CASES)
def test_plain_lse_gives_the_jax_reference_output(case):
    """The reference exposes no softmax statistics, so the LSE is held
    against it through the output it implies: o = exp2(scale log2(e)
    q k^T - LSE) v, with 0 on rows that see no key, against
    ``ref.flash_attention_ref`` on the same inputs."""
    B, Sq, Skv, H, Hkv, D, causal, window = case
    q, k, v = inputs(case, seed=1)
    _, lse = FA.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, with_lse=True)
    lse = lse.numpy().astype(np.float64)
    lse = lse if B else lse[None]
    s = masked_scores(q, k, causal, window)
    p = np.exp2(s / np.log(2) - np.where(np.isfinite(lse), lse, 0)[..., None])
    p = np.where(np.isfinite(lse)[..., None], p, 0.0)
    vv = v if B else v[None]
    vv = np.repeat(vv.astype(np.float64), H // Hkv, axis=2)
    got = np.einsum("bhqk,bkhd->bqhd", p, vv)

    def ref(qi, ki, vi):
        return np.asarray(jref.flash_attention_ref(
            jnp.asarray(qi), jnp.asarray(ki), jnp.asarray(vi),
            causal=causal, window=window))
    want = np.stack([ref(*x) for x in zip(q, k, v)]) if B \
        else ref(q, k, v)[None]
    assert np.abs(got - want).max() <= OUT_ATOL


def _count_lse_calls(monkeypatch):
    calls = []
    real = FA.flash_attention_lse

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(FA, "flash_attention_lse", counted)
    return calls


@pytest.mark.parametrize("dtype,D,saves", [(torch.bfloat16, 64, True),
                                           (torch.bfloat16, 128, True),
                                           (torch.bfloat16, 16, False),
                                           (torch.float32, 64, False)])
def test_function_saves_the_lse_only_under_grad(monkeypatch, dtype, D,
                                                saves):
    case = (2, 45, 130, 4, 2, D, True, None)
    q, k, v = (torch.from_numpy(x).to(dtype) for x in inputs(case, seed=2))
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        q.shape).astype(np.float32)).to(dtype)
    calls = _count_lse_calls(monkeypatch)
    y0 = kops.flash_attention(q, k, v, causal=True)
    assert not calls and y0.grad_fn is None
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    y = kops.flash_attention(tq, tk, tv, causal=True)
    assert len(calls) == saves
    assert torch.equal(y, y0)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 4 + saves
    if saves:
        want = FA.flash_attention_plain(q, k, v, with_lse=True)[1]
        assert torch.equal(saved[4], want)
    got = torch.autograd.grad(y, (tq, tk, tv), do)
    want = FA.flash_attention_backward_plain(q, k, v, y.detach(), do)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


def test_forward_lse_operator_fake_and_flops():
    """The dry run's FakeTensorMode allocates o and the LSE without running
    anything, and FlopCounterMode counts the forward-with-LSE operator as
    the forward (4 B Sq Skv H D), so a training step's count is the one it
    was: forward + backward 14 B Sq Skv H D."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    B, Sq, Skv, H, Hkv, D = 2, 45, 130, 4, 2, 64
    with FakeTensorMode():
        q = torch.empty(B, Sq, H, D, dtype=torch.bfloat16)
        k = torch.empty(B, Skv, Hkv, D, dtype=torch.bfloat16)
        o, lse = FA.flash_attention_lse(q, k, k)
        assert o.shape == q.shape and o.dtype == torch.bfloat16
        assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
        o, lse = FA.flash_attention_lse(q[0], k[0], k[0])
        assert lse.shape == (H, Sq)
        got = FA.flash_attention_backward(q, k, k, q, q, lse=lse[None]
                                          .expand(B, H, Sq))
        assert [t.shape for t in got] == [q.shape, k.shape, k.shape]
    q, k, v = (torch.from_numpy(x).bfloat16() for x in inputs(
        (B, Sq, Skv, H, Hkv, D, True, None)))
    with FlopCounterMode(display=False) as fc:
        FA.flash_attention_lse(q, k, v)
    assert fc.get_total_flops() == FA.flash_flops(q.shape, k.shape) \
        == 4 * B * Sq * Skv * H * D
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    with FlopCounterMode(display=False) as fc:
        y = kops.flash_attention(tq, tk, tv)
        torch.autograd.grad(y, (tq, tk, tv), torch.ones_like(y))
    assert fc.get_total_flops() == 14 * B * Sq * Skv * H * D


def test_backward_operator_checks_the_lse():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in inputs(CASES[1]))
    o, lse = FA.flash_attention_lse(q, k, v)
    for bad in (lse[:, :, :-1], lse.double(), lse.bfloat16()):
        with pytest.raises(ValueError, match="lse"):
            FA.flash_attention_backward(q, k, v, o, q, lse=bad)


# ---------------------------------------------------------------- the plan
PATH_SHAPES = [  # B, Sq, Skv, H, Hkv, D, causal, window: the train path's
    (4, 1024, 1024, 32, 8, 128, True, None),    # qwen3-4b's step
    (1, 1024, 1024, 32, 8, 128, True, None),    # the DDP grain
    (2, 3072, 3072, 25, 5, 64, True, 2048),     # hymba, windowed layers
    (2, 3072, 3072, 25, 5, 64, True, None),     # hymba, global layers
    (8, 1500, 1500, 8, 8, 64, False, None),     # whisper's encoder
    (8, 448, 1500, 8, 8, 64, False, None),      # its cross-attention
]


@pytest.mark.parametrize("case", PATH_SHAPES)
def test_bwd_plan_at_the_train_path_shapes(case):
    """One dkdv CTA per KV head at qwen3-4b's and hymba's step shapes (no
    float32 shares, no reduce); the per-query-head grid and the reduce
    kept at B = 1, where one CTA per KV head (8 x 16 = 128) would leave
    SMs idle."""
    from test_torch_flash_backward import check_bwd_plan
    B, Sq, Skv, H, Hkv, D, causal, window = case
    plan = check_bwd_plan(B, Sq, Skv, H, Hkv, D, causal, window)
    assert plan.route == "sm90"
    assert plan.split == (B == 1)
    assert plan.reduce == plan.split
    if not plan.split:
        assert plan.dkdv_grid[1] == Hkv
        assert np.prod(plan.dkdv_grid) >= FA.H100_SMS
    else:
        assert plan.dkdv_grid[1] == H
        assert B * Hkv * -(-Skv // plan.tile) < FA.H100_SMS


@pytest.mark.parametrize("tiles", [(64, False), (128, False), (64, True),
                                   (128, True)])
@pytest.mark.parametrize("case", [(1, 300, 300, 8, 2, True, None),
                                  (2, 100, 333, 6, 3, True, 40),
                                  (1, 200, 77, 4, 1, False, None),
                                  (1, 130, 70, 4, 2, True, 20)])
def test_bwd_plan_every_sm90_tile_choice_walks_the_visible_pairs(case,
                                                                  tiles):
    from test_torch_flash_backward import check_bwd_plan
    B, Sq, Skv, H, Hkv, causal, window = case
    for D in (64, 128):
        check_bwd_plan(B, Sq, Skv, H, Hkv, D, causal, window, tiles=tiles)


def test_bwd_plan_per_kv_head_walks_its_query_heads_in_order():
    """Without split the dkdv walk is the same q tiles for each of the
    H / Hkv query heads, taken head after head: each (KV head, KV tile)
    CTA adds every query head's pairs once."""
    plan = FA.bwd_plan(2, 256, 256, 8, 2, 64, True, None,
                       tiles=(64, False))
    assert not plan.split and plan.dkdv_grid == (4, 2, 2)
    n = plan.walk()["dkdv"]
    want = np.tril(np.ones((256, 256), np.int32))
    assert (n == want[None]).all()
    split = FA.bwd_plan(2, 256, 256, 8, 2, 64, True, None,
                        tiles=(64, True))
    assert split.dkdv_grid == (4, 8, 2)
    assert (split.walk()["dkdv"] == n).all()


# ------------------------------------------------------------- the sources
WGMMA_HELPERS = ("mbar_wait", "tma_load", "desc_b128", "wgmma_ss_n64",
                 "wgmma_rs_n128", "make_map")


@pytest.mark.parametrize("source", ["flash_attention_sm90",
                                    "flash_attention_bwd"])
def test_sm90_sources_share_one_copy_of_the_wgmma_helpers(source):
    """The forward and the backward's sm90 route include
    csrc/wgmma_tma.cuh and define none of its helpers themselves."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    head = (_build.CSRC / "wgmma_tma.cuh").read_text()
    assert '#include "wgmma_tma.cuh"' in src
    for name in WGMMA_HELPERS:
        pat = rf"\b[\w:]+ {name}\("
        assert re.search(pat, head), name
        assert not re.search(pat, src), name


def test_editing_the_wgmma_header_rebuilds_both_sm90_sources(
        tmp_path, monkeypatch):
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    head = tmp_path / "wgmma_tma.cuh"
    head.write_text(head.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if before[n] != after[n]} == \
        {"flash_attention_sm90", "flash_attention_bwd"}
