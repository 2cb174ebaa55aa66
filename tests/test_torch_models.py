"""Port parity, models slice: the flash-attention plain version, the
transformer layers and the dense model's prefill / decode against the JAX
reference, with identical weights carried across by
``convert.params_from_arrays``.

Flash attention: the plain version against the Pallas kernel (interpret
mode) and ``ref.flash_attention_ref`` at the reference test's tolerances
(float32 rtol 2e-4 / atol 2e-5, bf16 5e-2).  When ``Sq > Skv`` some causal
rows see no key: ``flash_attention_ref`` and the port return 0 there, the
Pallas kernel returns the mean of the v rows (ROADMAP Queue 3), so that case
is held against the ref only.  Layers and whole-model logits in float32:
rtol 1e-4, atol 1e-5 (the two frameworks sum in different orders).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import flash_attention as ref_flash_attention  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as PR  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def smoke(arch):
    """The reference's and the port's f32 smoke config of ``arch``."""
    kw = dict(dtype="float32", remat="none")
    return (ref_get_config(arch).smoke_config().scaled(**kw),
            get_config(arch).smoke_config().scaled(**kw))


@pytest.fixture(scope="module", params=["qwen3-4b", "starcoder2-3b"])
def model(request):
    """(ref cfg, port cfg, ref params, port params) with one set of
    weights: qwen3 (qk-norm, swiglu, GQA 2:1) and starcoder2 (gelu MLP,
    untied head, GQA 2:1)."""
    rcfg, pcfg = smoke(request.param)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    pp = params_from_arrays(pcfg, jax.tree.map(np.asarray, rp),
                            device="cpu")
    return rcfg, pcfg, rp, pp


# ------------------------------------------------------------ flash attention
FLASH_CASES = [   # tests/test_kernels.py:69-76, then kimi-k2's D = 112
    (128, 128, 4, 2, 64, True, None),
    (100, 100, 2, 2, 32, True, None),
    (1, 96, 4, 1, 64, True, None),
    (64, 192, 8, 4, 64, True, 48),
    (128, 128, 2, 1, 128, False, None),
    (73, 129, 3, 3, 64, True, None),
    (96, 96, 8, 1, 112, True, None),     # kimi-k2's head size, GQA 8:1
    (80, 144, 8, 1, 112, True, 40),
]


def _qkv(rng, Sq, Skv, H, Hkv, D):
    q = (rng.standard_normal((Sq, H, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((Skv, Hkv, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((Skv, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("Sq,Skv,H,Hkv,D,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(Sq, Skv, H, Hkv, D, causal,
                                            window, rng):
    q, k, v = _qkv(rng, Sq, Skv, H, Hkv, D)
    pallas = ref_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=32, block_k=32)
    want = R.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=window)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = FA.flash_attention(tq, tk, tv, causal=causal, window=window)
    for other in (pallas, want):
        _close(got, other, rtol=2e-4, atol=2e-5)
    _close(PR.flash_attention_ref(tq, tk, tv, causal=causal, window=window),
           want, rtol=2e-4, atol=2e-5)
    _close(kops.flash_attention(tq, tk, tv, causal=causal, window=window),
           want, rtol=2e-4, atol=2e-5)


def test_flash_plain_bf16_matches_pallas(rng):
    """tests/test_kernels.py:88: bf16 inputs, tolerance 5e-2."""
    q = jnp.asarray(rng.standard_normal((64, 4, 64)), jnp.bfloat16) * 0.3
    k = jnp.asarray(rng.standard_normal((64, 2, 64)), jnp.bfloat16) * 0.3
    v = jnp.asarray(rng.standard_normal((64, 2, 64)), jnp.bfloat16)
    pallas = np.asarray(ref_flash_attention(q, k, v, block_q=32,
                                                  block_k=32), np.float32)
    want = np.asarray(R.flash_attention_ref(q, k, v), np.float32)

    def bf16(a):
        return torch.as_tensor(np.asarray(a, np.float32)).bfloat16()
    got = FA.flash_attention(bf16(q), bf16(k), bf16(v))
    assert got.dtype == torch.bfloat16
    for other in (pallas, want):
        _close(got.float(), other, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("window", [None, 8])
def test_flash_fully_masked_rows_are_zero(window, rng):
    """Sq > Skv with causal: the first Sq - Skv rows see no key and are 0,
    as in ``flash_attention_ref``.  (The Pallas kernel returns the mean of
    v there — a reference fault, ROADMAP Queue 3 — so it is not the
    oracle for this case.)"""
    q, k, v = _qkv(rng, 48, 16, 2, 1, 16)
    want = np.asarray(R.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), window=window))
    got = FA.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                             window=window)
    _close(got, want, rtol=2e-4, atol=2e-5)
    assert not got[:32].any() and got[32:].abs().sum() > 0


def test_flash_batched_and_refusals(rng):
    q, k, v = (torch.as_tensor(a) for a in _qkv(rng, 20, 20, 4, 2, 16))
    batched = FA.flash_attention(torch.stack([q, 2 * q]),
                                 torch.stack([k, k]), torch.stack([v, v]))
    _close(batched[0], FA.flash_attention(q, k, v), rtol=0, atol=0)
    _close(batched[1], FA.flash_attention(2 * q, k, v), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        FA.flash_attention(q.clone().requires_grad_(), k, v)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention(q, k[:, :1].expand(-1, 3, -1).contiguous(),
                           v[:, :1].expand(-1, 3, -1).contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.double(), k.double(), v.double())
    kops.reset_launch_counts()
    FA.flash_attention(q, k, v)
    assert kops.launch_counts()["flash_attention"] == 0   # plain on the CPU


# --------------------------------------------------------------------- layers
def test_rmsnorm_and_rope_match(rng):
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(PL.rmsnorm(torch.as_tensor(x), torch.as_tensor(scale)),
           RL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.arange(5, 14)
    for theta in (1e4, 1e6):
        _close(PL.rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
               RL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def _layer0(rcfg, pcfg, rp, pp):
    rbp = jax.tree.map(lambda a: a[0], rp["blocks"])
    return rbp, PT.layer(pp["blocks"], 0)


def test_attention_matches_chunked(model, rng):
    """The port's prefill attention (flash core) against the reference's
    ``attention`` (``_chunked_attn`` core), plain causal and windowed."""
    rcfg, pcfg, rp, pp = model
    rbp, pbp = _layer0(rcfg, pcfg, rp, pp)
    x = rng.standard_normal((2, 11, rcfg.d_model)).astype(np.float32)
    for window in (None, 4):
        rout, (rk, rv) = RL.attention(jnp.asarray(x), rbp, rcfg,
                                      window=window, chunk=4)
        pout, (pk, pv) = PL.attention(torch.as_tensor(x), pbp, pcfg,
                                      window=window)
        _close(pout, rout)
        _close(pk, rk)
        _close(pv, rv)


def test_attention_decode_and_mlp_match(model, rng):
    rcfg, pcfg, rp, pp = model
    rbp, pbp = _layer0(rcfg, pcfg, rp, pp)
    Hkv, hd = rcfg.n_kv_heads, rcfg.hd
    x = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, 12, Hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((2, 12, Hkv, hd)).astype(np.float32)
    for pos, window in ((5, None), (9, 3)):
        rout, rck, rcv = RL.attention_decode(
            jnp.asarray(x), rbp, rcfg, jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(pos), window=window)
        tck, tcv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
        pout, pck, pcv = PL.attention_decode(torch.as_tensor(x), pbp, pcfg,
                                             tck, tcv, pos, window=window)
        _close(pout, rout)
        _close(pck, rck)
        _close(pcv, rcv)
        assert pck is tck                       # written in place
    h = rng.standard_normal((2, 5, rcfg.d_model)).astype(np.float32)
    _close(PL.mlp(torch.as_tensor(h), pbp, pcfg),
           RL.mlp(jnp.asarray(h), rbp, rcfg))


# ---------------------------------------------------------------------- model
def test_param_tree_matches_reference(model):
    """init_params makes the reference's names, shapes and dtypes."""
    rcfg, pcfg, rp, _ = model
    mine = PT.init_params(pcfg, device="cpu")
    ref_leaves = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_leaves_with_path(rp)}
    my_leaves = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_leaves_with_path(mine)}
    assert sorted(ref_leaves) == sorted(my_leaves)
    for name, a in ref_leaves.items():
        assert tuple(my_leaves[name].shape) == a.shape, name
        assert str(my_leaves[name].dtype).split(".")[-1] == str(a.dtype)
    # same scale as the reference's init: embed std 0.02
    assert abs(float(mine["embed"].std()) - 0.02) < 0.002


def test_prefill_and_decode_logits_match(model, rng):
    """Prefill of a right-padded batch (per-row ``last_pos``, cache padded
    to s_max), then three greedy decode steps."""
    rcfg, pcfg, rp, pp = model
    toks = rng.integers(0, rcfg.vocab, (2, 13))
    last_pos = np.array([12, 6])
    rl, rc = RT.prefill(rp, rcfg, tokens=jnp.asarray(toks), s_max=16,
                        last_pos=jnp.asarray(last_pos))
    pl, pc = PT.prefill(pp, pcfg, tokens=toks, s_max=16, last_pos=last_pos)
    _close(pl, rl)
    _close(pc["k"], rc["k"])
    _close(pc["v"], rc["v"])
    assert pc["pos"] == int(rc["pos"])
    tok = rng.integers(0, rcfg.vocab, 2)
    for _ in range(3):
        rl, rc = RT.decode_step(rp, rcfg, jnp.asarray(tok, jnp.int32), rc)
        pl, pc = PT.decode_step(pp, pcfg, torch.as_tensor(np.array(tok)),
                                 pc)
        _close(pl, rl)
        tok = np.asarray(jnp.argmax(rl, -1))
    _close(pc["k"], rc["k"])
    assert pc["pos"] == int(rc["pos"])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_smoke_forward_one_step(arch):
    """The reference's per-arch smoke test on the port: one forward, one
    prefill and one decode of the f32 smoke config on the CPU; shapes and
    no NaNs (every family, the vlm through ``embeds``, the audio one with
    ``enc_embeds``)."""
    cfg = get_config(arch).smoke_config().scaled(dtype="float32",
                                                 remat="none")
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(cfg, generator=gen, device="cpu")
    B, S = 2, 16
    kwargs = {}
    if cfg.family == "vlm":
        kwargs["embeds"] = torch.randn(B, S, cfg.d_model, generator=gen) \
            * 0.02
    else:
        kwargs["tokens"] = torch.randint(0, cfg.vocab, (B, S),
                                         generator=gen)
    if cfg.family == "audio":
        kwargs["enc_embeds"] = torch.randn(B, 24, cfg.d_model,
                                           generator=gen) * 0.02
    logits, aux = PT.forward(params, cfg, **kwargs)
    assert logits.shape == (B, S, cfg.vocab) and aux.shape == ()
    assert not torch.isnan(logits).any()
    lg, cache = PT.prefill(params, cfg, s_max=S + 4, **kwargs)
    assert lg.shape == (B, cfg.vocab)
    lg2, cache = PT.decode_step(params, cfg, lg.argmax(-1), cache)
    assert lg2.shape == (B, cfg.vocab) and cache["pos"] == S + 1
    assert not torch.isnan(lg2).any()


def test_unknown_block_kind_raises():
    cfg = get_config("qwen3-4b").smoke_config().scaled(block_kind="rwkv")
    with pytest.raises(NotImplementedError, match="unknown block kind"):
        PT.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="unknown block kind"):
        PT.init_cache(cfg, 1, 8, device="cpu")


def test_configs_are_the_references():
    from repro.configs import ALL_ARCHS as REF_ARCHS, SHAPES as REF_SHAPES
    from repro_torch.configs import SHAPES
    assert ALL_ARCHS == REF_ARCHS and SHAPES == REF_SHAPES
    for arch in ALL_ARCHS:
        r, p = ref_get_config(arch), get_config(arch)
        import dataclasses
        assert dataclasses.asdict(r) == dataclasses.asdict(p), arch
        assert r.param_count() == p.param_count()
        assert r.smoke_config().hd == p.smoke_config().hd


def test_params_from_arrays_checks_and_bf16(model):
    rcfg, pcfg, rp, _ = model
    tree = jax.tree.map(np.asarray, rp)
    with pytest.raises(KeyError, match="final_norm"):
        params_from_arrays(pcfg, {k: v for k, v in tree.items()
                                  if k != "final_norm"}, device="cpu")
    bad = dict(tree, blocks=dict(tree["blocks"],
                                 wq=tree["blocks"]["wq"][:, :, :8]))
    with pytest.raises(ValueError, match="wq"):
        params_from_arrays(pcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        params_from_arrays(pcfg.scaled(dtype="bfloat16"), tree, device="cpu")
    # bfloat16 leaves cross as their bits
    bcfg = pcfg.scaled(dtype="bfloat16")
    btree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                         tree)
    bp = params_from_arrays(bcfg, btree, device="cpu")
    assert bp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bp["embed"].float().numpy(), np.asarray(btree["embed"], np.float32))


def test_entry_points_need_a_card_or_cpu(monkeypatch, model):
    _, pcfg, _, pp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.init_params(pcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.init_cache(pcfg, 2, 8)
    with pytest.raises(ValueError, match="move it there explicitly"):
        PT.prefill(pp, pcfg, tokens=torch.zeros(1, 4, dtype=torch.long,
                                                device="meta"))


# ----------------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the kernels on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 112, 128])
@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (70, 90, True, 33), (300, 300, True, None), (96, 40, True, None),
    (130, 257, False, None)])
def test_cuda_flash_matches_plain(cuda_device, dt, D, Sq, Skv, causal,
                                  window):
    """Both kernels (route: bf16 D 64/112/128 -> the wgmma kernel, else the
    first kernel) against the plain version on unscaled randn inputs, held
    to chip_smoke's FLASH_TOL, whose limit scales with each query row."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(Sq, 8, D, generator=g, device=cuda_device).to(dt)
    k = torch.randn(Skv, 2, D, generator=g, device=cuda_device).to(dt)
    v = torch.randn(Skv, 2, D, generator=g, device=cuda_device).to(dt)
    before = FA.flash_attention.launches, FA.flash_attention.launches_sm90
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    chip_smoke.flash_check(got, want, f"{dt} D{D} {Sq}x{Skv}")
    sm90 = FA.route(dt, D) == FA.SM90
    assert (FA.flash_attention.launches,
            FA.flash_attention.launches_sm90) == (before[0] + 1,
                                                  before[1] + sm90)
    if causal and Sq > Skv:
        assert bool((got[: Sq - Skv] == 0).all())
