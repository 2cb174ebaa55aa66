"""Every attention config's head size has a flash kernel on the card.

Row 8's kernels take a fixed set of head sizes per route
(``flash_attention.HEAD_DIMS`` the mma.sync kernels, forward and
backward; ``SM90_HEAD_DIMS`` the wgmma forward, ``SPLIT_HEAD_DIMS`` the
split route, ``SM90_BWD_HEAD_DIMS`` the wgmma backward).  For the head
size of every config under
``repro_torch.configs`` whose blocks run attention (all but xlstm's), at
either dtype and at prefill, short-query and decode-like row counts,
``route`` and ``bwd_route`` must name a route that takes it, and the
operators' fakes (what the dry run traces) must accept the call, as the
card's kernels would.  A head size that no kernel takes (100) must make
the fakes raise, as a launch on the card does.  Head size 112 (kimi-k2's)
runs the wgmma forward on its 128-wide tiles, never the split route, and
the mma.sync backward.  No JAX and no card: this runs on the CPU.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.kernels import flash_attention as FA

# the archs whose blocks run attention through row 8 (xlstm's mLSTM and
# sLSTM cells take none)
ATTENTION_ARCHS = [a for a in ALL_ARCHS
                   if get_config(a).block_kind != "xlstm"]
DTYPES = (torch.bfloat16, torch.float32)
# (rows of a KV head, keys): no count (the backward's and tile_plan's
# call), a decode-like short query, the split cut, a prefill
ROWS_KEYS = [(None, None), (1, 4096), (FA.SPLIT_ROWS, FA.SPLIT_BC + 1),
             (4096, 4096)]
# the head sizes of each route the forward's and the backward's rules name
ROUTE_HEAD_DIMS = {FA.SM90: FA.SM90_HEAD_DIMS, FA.SPLIT: FA.SPLIT_HEAD_DIMS,
                   "flash_attention": FA.HEAD_DIMS}
BWD_ROUTE_HEAD_DIMS = {"sm90": FA.SM90_BWD_HEAD_DIMS, "mma": FA.HEAD_DIMS}


def fake_calls(Sq, Skv, H, Hkv, D, dtype):
    """The forward, LSE and backward operators on fake tensors of these
    shapes (their fakes run, as under the dry run); the LSE only where the
    forward's route writes one."""
    with FakeTensorMode():
        q = torch.empty(Sq, H, D, dtype=dtype)
        k = torch.empty(Skv, Hkv, D, dtype=dtype)
        o = FA.flash_attention(q, k, k)
        assert o.shape == q.shape and o.dtype == dtype
        if FA.call_route(q, k) in (FA.SM90, FA.SPLIT):
            o, lse = FA.flash_attention_lse(q, k, k)
            assert lse.shape == (H, Sq)
        grads = FA.flash_attention_backward(q, k, k, o, torch.empty_like(q))
        assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_every_config_head_size_has_a_kernel(arch, dtype):
    cfg = get_config(arch)
    D, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    assert D in FA.HEAD_DIMS, arch
    for rows, keys in ROWS_KEYS:
        r = FA.route(dtype, D, rows, keys)
        assert D in ROUTE_HEAD_DIMS[r], (arch, rows, keys, r)
    b = FA.bwd_route(dtype, D)
    assert D in BWD_ROUTE_HEAD_DIMS[b], (arch, b)
    FA.bwd_plan(1, 300, 300, H, Hkv, D, True, None, dtype=dtype)
    # a prefill and a one-token query over many keys (the split route
    # where the head size has it)
    fake_calls(64, 64, H, Hkv, D, dtype)
    fake_calls(1, 4096, H, Hkv, D, dtype)


@pytest.mark.parametrize("D", [100, 8, 256])
def test_untaken_head_size_raises_in_the_fakes(D):
    """No route takes these: each operator's fake raises, as the card's
    launch does, so the dry run cannot pass a cell the card cannot run."""
    assert D not in FA.HEAD_DIMS
    for dtype in DTYPES:
        with FakeTensorMode():
            q = torch.empty(16, 4, D, dtype=dtype)
            k = torch.empty(16, 2, D, dtype=dtype)
            with pytest.raises(ValueError, match="head sizes"):
                FA.flash_attention(q, k, k)
            with pytest.raises(ValueError, match="head sizes"):
                FA.flash_attention_lse(q, k, k)
            with pytest.raises(ValueError, match="head sizes"):
                FA.flash_attention_backward(q, k, k, q, q)
    # the plain version on CPU tensors takes any head size
    q = torch.randn(16, 4, D)
    k = torch.randn(16, 2, D)
    assert FA.flash_attention(q, k, k).shape == q.shape


def test_kimi_head_size_routes():
    """kimi-k2's 112: the wgmma forward at every row count (never the
    split route), on the 128-wide tiles and their shared memory; the
    mma.sync backward; float32 on the first kernel."""
    cfg = get_config("kimi-k2-1t-a32b")
    assert cfg.hd == 112 and (cfg.n_heads, cfg.n_kv_heads) == (64, 8)
    for rows, keys in ROWS_KEYS:
        assert FA.route(torch.bfloat16, 112, rows, keys) == FA.SM90
        assert FA.route(torch.float32, 112, rows, keys) == "flash_attention"
    assert FA.bwd_route(torch.bfloat16, 112) == "mma"
    assert FA.sm90_width(112) == 128
    for br in (64, 128):
        assert FA.sm90_bc(112, br) == FA.sm90_bc(128, br)
        assert FA.sm90_smem_bytes(112, br) == FA.sm90_smem_bytes(128, br) \
            <= 232448
    a = FA.tile_plan(1, 1024, 1024, 64, 8, 112)
    b = FA.tile_plan(1, 1024, 1024, 64, 8, 128)
    assert (a.br, a.bc, a.q_order, a.work, a.kv) == \
        (b.br, b.bc, b.q_order, b.work, b.kv)
    with pytest.raises(ValueError, match="head sizes"):
        FA.split_plan(1, 1, 4096, 64, 8, 112)
    plan = FA.bwd_plan(1, 1024, 1024, 64, 8, 112, True, None)
    assert plan.route == "mma" and plan.split and plan.dq_rows == 64
