"""Port parity, training of the families brought by the twelfth slice:
hymba (attention and SSM heads in parallel; the SSM scan through its
autograd Function), xlstm ((mLSTM, sLSTM) pairs in checkpointed 128-step
chunks) and whisper (encoder-decoder), against the JAX reference on the
same numpy inputs, in float32 on the smoke configs with one set of weights
carried across by ``convert.params_from_arrays``.

- loss and every gradient leaf, remat on and off, within ``GRAD_REL`` of
  each leaf's largest reference element (``tests/test_torch_training.py``
  holds dense and MoE to the same);
- ``ssm_scan``'s gradients (x, every SSM leaf, h0) across chunk
  boundaries and a partial last chunk, and the Function against autograd
  through a functional step loop;
- one xlstm pair past a 128-step chunk (S = 130): the reference's
  pad-step fault (ROADMAP Queue 3) moves only its returned state, so the
  outputs' gradients are held at any S;
- one train step per family at the dense slice's step tolerances, from
  the reference's params and from its optimizer state carried across;
  each family's params and optimizer state carried both ways (``convert``
  and the checkpoint format) bit for bit;
- the graph protocols (hymba's scan graphs, xlstm's chunk graphs) run on
  the CPU with ``graphs.Eager`` standing in for a capture, bitwise the
  eager path;
- the reference's ``test_arch_smoke_train_step`` over all 10 archs, and
  ``forward_train``'s logits equal to ``forward``'s for each family.

The graph-backed scan Function, whisper's cross shape through the flash
Function and a hymba step on the card are in ``tests/test_torch_on_card.py``.
"""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models import xlstm as RX  # noqa: E402
from repro.training import checkpoint as RC  # noqa: E402
from repro.training import data as RD  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro.training import train_loop as RL  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (opt_state_from_arrays,  # noqa: E402
                                 params_from_arrays)
from repro_torch.models import ssm as PSSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as PX  # noqa: E402
from repro_torch.training import checkpoint as C  # noqa: E402
from repro_torch.training import data as D  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as L  # noqa: E402
from repro_torch.training.pytree import tree_leaves  # noqa: E402

from test_torch_training import _close_step  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
GRAD_REL = 1e-5
FAMILIES = ["hymba-1.5b", "xlstm-350m", "whisper-base"]
# hymba's 24 tokens pass its smoke window of 16 on the sliding layer;
# whisper's encoder reads 24 frames
SEQ, FRAMES = 24, 24
_MODELS = {}


def model(arch, remat="block"):
    """(ref cfg, port cfg, ref params, port params) of ``arch``'s f32
    smoke config, one set of weights per arch."""
    key = (arch, remat)
    if key not in _MODELS:
        kw = dict(dtype="float32", remat=remat)
        rcfg = ref_get_config(arch).smoke_config().scaled(**kw)
        pcfg = get_config(arch).smoke_config().scaled(**kw)
        rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
        pp = params_from_arrays(pcfg, jax.tree.map(np.asarray, rp),
                                device="cpu")
        _MODELS[key] = (rcfg, pcfg, rp, pp)
    return _MODELS[key]


def batch(rcfg, B=2, S=SEQ, step=3):
    return RD.make_batch(rcfg, B, S, step=step, enc_len=FRAMES)


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(a):
    return torch.as_tensor(np.array(a))


def close_grads(got, want):
    """Each leaf within GRAD_REL of the reference leaf's largest element."""
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())


# ------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grads_match_reference(arch, remat):
    rcfg, cfg, rp, pp = model(arch, remat)
    b = batch(rcfg)
    (rl, rm), rg = jax.value_and_grad(RL.make_loss_fn(rcfg, RL.TrainConfig()),
                                      has_aux=True)(rp, jbatch(b))
    (pl, pm), pg = L.value_and_grad(L.make_loss_fn(cfg, L.TrainConfig()),
                                    pp, L.batch_to(b, CPU))
    np.testing.assert_allclose(float(pl), float(rl), rtol=GRAD_REL)
    np.testing.assert_allclose(float(pm["ce"]), float(rm["ce"]),
                               rtol=GRAD_REL)
    assert float(pm["aux"]) == float(rm["aux"]) == 0.0
    close_grads(tree_leaves(pg), jax.tree_util.tree_leaves(rg))


def test_remat_gives_the_same_family_gradients():
    """Remat recomputes the same operations: the gradients are bitwise
    those without it, for each family."""
    for arch in FAMILIES:
        _, cfg, _, pp = model(arch)
        b = L.batch_to(D.make_batch(cfg, 2, 12, enc_len=8), CPU)
        grads = [L.value_and_grad(L.make_loss_fn(cfg.scaled(remat=r),
                                                 L.TrainConfig()), pp, b)[1]
                 for r in ("block", "none")]
        assert all(torch.equal(a, c) for a, c in
                   zip(tree_leaves(grads[0]), tree_leaves(grads[1]))), arch


# ------------------------------------------------------------ the SSM alone
def _ssm_case(S, seed, with_h0):
    rcfg, cfg, rp, pp = model("hymba-1.5b")
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, S, cfg.d_model)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((2, cfg.ssm_heads, cfg.hd, cfg.ssm_state))
          * 0.1).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    dh = rng.standard_normal((2, cfg.ssm_heads, cfg.hd, cfg.ssm_state)
                             ).astype(np.float32)
    rbp = jax.tree.map(lambda a: a[0], rp["blocks"])
    pbp = {k: v.clone() for k, v in T.layer(pp["blocks"], 0).items()}
    return rcfg, cfg, rbp, pbp, x, h0, dy, dh


SSM_LEAVES = ("in_proj", "gate_proj", "out_proj", "w_bc", "w_dt", "b_dt",
              "a_log")


@pytest.mark.parametrize("S,chunk,with_h0", [(21, 8, True), (300, 256, True),
                                             (300, 256, False)])
def test_ssm_scan_grads_match_reference(S, chunk, with_h0):
    """The gradients of <y, dy> + <h_S, dh> in x, every SSM leaf and h0;
    at chunk 8 over 21 steps and at the default chunk over 300, each
    crossing chunk boundaries and ending mid-chunk."""
    rcfg, cfg, rbp, pbp, x, h0, dy, dh = _ssm_case(S, S + chunk, with_h0)

    def rloss(x, leaves, h0):
        y, h = RSSM.ssm_scan(x, {**rbp, **leaves}, rcfg, h0=h0,
                             time_chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(h * dh)
    rleaves = {k: rbp[k] for k in SSM_LEAVES}
    rh0 = None if h0 is None else jnp.asarray(h0)
    want = jax.grad(rloss, argnums=(0, 1, 2) if with_h0 else (0, 1))(
        jnp.asarray(x), rleaves, rh0)

    xt = _t(x).requires_grad_()
    leaves = {k: pbp[k].requires_grad_() for k in SSM_LEAVES}
    ht = None if h0 is None else _t(h0).requires_grad_()
    y, h = PSSM.ssm_scan(xt, {**pbp, **leaves}, cfg, h0=ht, time_chunk=chunk)
    assert "SelectiveScan" in type(h.grad_fn).__name__
    loss = torch.sum(y * _t(dy)) + torch.sum(h * _t(dh))
    wrt = [xt] + [leaves[k] for k in SSM_LEAVES] + ([ht] if with_h0 else [])
    got = torch.autograd.grad(loss, wrt)
    close_grads(got[:1], [want[0]])
    close_grads(got[1:1 + len(SSM_LEAVES)],
                [want[1][k] for k in SSM_LEAVES])
    if with_h0:
        close_grads(got[-1:], [want[2]])


def test_selective_scan_function_equals_eager_autograd():
    """The Function's forward bitwise the inference loop's, its gradients
    in Δ, u, B, C, A and h0 against autograd through the eager step loop
    (``chip_smoke.plain_scan``, which the card's check uses; S = 45 over
    chunks of 16)."""
    rng = np.random.default_rng(7)
    B, S, Hm, hd, N = 2, 45, 3, 4, 5
    f = lambda *s: _t(rng.standard_normal(s).astype(np.float32))  # noqa
    ins = [f(B, S, Hm, 1).abs() * 0.3, f(B, S, Hm, hd), f(B, S, Hm, N),
           f(B, S, Hm, N), -f(Hm, N).abs() - 0.1, f(B, Hm, hd, N) * 0.1]
    cot = (f(S, B, Hm, hd, 1), f(B, Hm, hd, N))
    h_inf = ins[5].clone()
    ys_inf = PSSM._scan(*ins[:5], h_inf, 16)
    a = [t.clone().requires_grad_() for t in ins]
    ys, h = PSSM._SelectiveScan.apply(*a, 16)
    assert torch.equal(ys.detach(), ys_inf) and torch.equal(h.detach(),
                                                            h_inf)
    got = torch.autograd.grad((ys, h), a, cot)
    b = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(chip_smoke.plain_scan(*b), b, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_REL * float(w.abs().max()))


def test_graph_chunk_protocol_on_the_cpu(monkeypatch):
    """The graph classes' chunk protocol (static buffers, the last chunk
    padded with decay 1, no input and no output gradient) run on the CPU
    with their steps launched one by one: the forward and the gradients
    are bitwise those of the path without graphs, at S = 45 over chunks
    of 16 and at S = 5 inside one chunk."""
    rng = np.random.default_rng(8)
    f = lambda *s: _t(rng.standard_normal(s).astype(np.float32))  # noqa
    for S in (45, 5):
        B, Hm, hd, N = 2, 3, 4, 5
        ins = [f(B, S, Hm, 1).abs() * 0.3, f(B, S, Hm, hd), f(B, S, Hm, N),
               f(B, S, Hm, N), -f(Hm, N).abs() - 0.1, f(B, Hm, hd, N)]
        cot = (f(S, B, Hm, hd, 1), f(B, Hm, hd, N))
        runs = []
        for graphs in (False, True):
            monkeypatch.setattr(PSSM, "_use_graphs",
                                lambda dev, S, on=graphs: on and S > 0)
            a = [t.clone().requires_grad_() for t in ins]
            out = PSSM._SelectiveScan.apply(*a, 16)
            runs.append(out + torch.autograd.grad(out, a, cot))
        monkeypatch.undo()
        PSSM._GRAPHS.clear()
        for x, y in zip(*runs):
            assert torch.equal(x.detach(), y.detach())


# ------------------------------------------------------- the xlstm pair alone
def test_xlstm_pair_grads_match_reference():
    """One pair at S = 130, past a 128-step chunk: the gradients of <y,
    dy> in x and every pair leaf (the reference's state after its pad
    steps is not differentiated: Queue 3)."""
    rcfg, cfg, rp, pp = model("xlstm-350m")
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 130, cfg.d_model)) * 0.5).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    rpp = jax.tree.map(lambda a: a[0], rp["pairs"])

    def rloss(x, pp_):
        y, _ = RX.xlstm_pair_scan(x, pp_, rcfg, RX.init_xlstm_state(rcfg, 2))
        return jnp.sum(y * dy)
    want = jax.grad(rloss, argnums=(0, 1))(jnp.asarray(x), rpp)
    xt = _t(x).requires_grad_()
    ppp = {k: v[0].clone().requires_grad_() for k, v in pp["pairs"].items()}
    y, _ = PX.xlstm_pair_scan(xt, ppp, cfg,
                              PX.init_xlstm_state(cfg, 2, CPU))
    names = sorted(ppp)
    got = torch.autograd.grad(torch.sum(y * _t(dy)),
                              [xt] + [ppp[k] for k in names])
    close_grads(got, [want[0]] + [want[1][k] for k in names])


def test_xlstm_chunks_keep_no_per_step_state():
    """Under grad the mLSTM time loop runs in checkpointed chunks: 300
    steps save one (B, H, hd, hd) matrix memory for the backward per
    128-step chunk (its start state), where the unchunked loop saves some
    at every step; the outputs, the final state and the gradients are the
    unchunked loop's, bit for bit."""
    _, cfg, _, _ = model("xlstm-350m")
    H, hd, S = cfg.n_heads, cfg.d_model // cfg.n_heads, 300
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randn(1, S, H, hd, generator=g) for _ in range(3)] + \
        [torch.randn(1, S, H, generator=g) for _ in range(2)]
    st = PX.init_xlstm_state(cfg, 1, CPU)
    state = (st["mC"], st["mn"], st["mm"])

    def run(loop):
        saved = []

        def pack(t):
            if tuple(t.shape[-2:]) == (hd, hd):
                saved.append(t.shape)
            return t
        ins = [a.clone().requires_grad_() for a in seqs]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = loop(PX._mlstm_cell, tuple(ins), state)
        grads = torch.autograd.grad(out[0].sum() + out[1].sum(), ins)
        return out, grads, len(saved)
    whole, gw, n_whole = run(PX._steps)
    chunked, gc, n_chunked = run(PX._time_loop)
    assert n_whole >= S and n_chunked == -(-S // PX.TIME_CHUNK) == 3
    for a, b in zip(whole + gw, chunked + gc):
        assert torch.equal(a.detach(), b.detach())


def test_xlstm_chunk_graph_protocol_on_the_cpu(monkeypatch):
    """The chunk graphs' protocol (static inputs and output gradients,
    copies out of the graphs' buffers; ``graphs.Eager`` for the capture)
    run on the CPU: one pair's outputs, state and gradients at S = 300
    (chunks of 128, 128 and 44) bitwise the eager chunks', and every
    chunk of one length and cell replays one set of graphs."""
    _, cfg, _, pp = model("xlstm-350m")
    x = torch.randn(2, 300, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4)) * 0.5
    ppp = {k: v[0].clone() for k, v in pp["pairs"].items()}
    runs = []
    for graphs in (False, True):
        monkeypatch.setattr(PX, "_use_graphs", lambda dev, on=graphs: on)
        leaves = [x.clone().requires_grad_()] + \
            [ppp[k].clone().requires_grad_() for k in sorted(ppp)]
        y, st = PX.xlstm_pair_scan(leaves[0], dict(zip(sorted(ppp),
                                                       leaves[1:])), cfg,
                                   PX.init_xlstm_state(cfg, 2, CPU))
        loss = y.square().sum() + sum(v.sum() for v in st.values())
        runs.append([y, *st.values(), *torch.autograd.grad(loss, leaves)])
    assert len(PX._GRAPHS) == 4        # (mLSTM, sLSTM) x (128, 44) steps
    monkeypatch.undo()
    PX._GRAPHS.clear()
    for a, b in zip(*runs):
        assert torch.equal(a.detach(), b.detach())


# --------------------------------------------------------------- the step
def _ocfg():
    kw = dict(lr=1e-2, warmup_steps=1, decay_steps=100)
    return RO.OptConfig(**kw), O.OptConfig(**kw)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_matches_reference(arch):
    """One train step from the reference's params, then a second from its
    params and optimizer state carried across: the parameters within
    5e-3 per element and 1e-3 of the reference step's norm per leaf."""
    rcfg, cfg, rp, _ = model(arch)
    rocfg, ocfg = _ocfg()
    rstep = jax.jit(RL.make_train_step(rcfg, rocfg, RL.TrainConfig()))
    pstep = L.make_train_step(cfg, ocfg)
    b0, b1 = (batch(rcfg, step=s) for s in (0, 1))
    ro = RO.init_opt_state(rp, rocfg)
    rp1, ro1, rm = rstep(rp, ro, jbatch(b0))
    pp = params_from_arrays(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    pp1, _, pm = pstep(pp, O.init_opt_state(pp, ocfg), b0)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-6)
    _close_step(pp1, rp1, rp)
    pp1 = params_from_arrays(cfg, jax.tree.map(np.asarray, rp1),
                             device="cpu")
    po1 = opt_state_from_arrays(pp1, jax.tree.map(np.asarray, ro1))
    rp2, _, _ = rstep(rp1, ro1, jbatch(b1))
    pp2, _, _ = pstep(pp1, po1, b1)
    _close_step(pp2, rp2, rp1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_state_carries_both_ways(arch, tmp_path):
    """A family's params and AdamW state (the SSM leaves, the pairs, the
    encoder and cross blocks) cross from the reference by
    ``convert`` and back through the reference's checkpoint format, bit
    for bit both ways."""
    rcfg, cfg, rp, _ = model(arch)
    rocfg, ocfg = _ocfg()
    ro = jax.tree.map(lambda a: a + 1 if a.dtype == jnp.float32 else a,
                      RO.init_opt_state(rp, rocfg))
    rtree = {"params": rp, "opt": ro}
    pp = params_from_arrays(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    ptree = {"params": pp,
             "opt": opt_state_from_arrays(pp, jax.tree.map(np.asarray, ro))}
    C.save_checkpoint(str(tmp_path / "port"), 1, ptree, extra={"step": 1})
    back, _ = RC.load_checkpoint(str(tmp_path / "port"), 1, rtree)
    RC.save_checkpoint(str(tmp_path / "ref"), 1, rtree, extra={"step": 1})
    got, _ = C.load_checkpoint(str(tmp_path / "ref"), 1, ptree)
    want = jax.tree_util.tree_leaves(rtree)
    assert len(tree_leaves(got)) == len(want)
    for a, b, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(back),
                       want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(w))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_smoke_train_step(arch):
    """The reference's ``test_arch_smoke_train_step`` on the port: one
    reduced train step on the CPU, loss finite, parameters moved."""
    cfg = get_config(arch).smoke_config().scaled(dtype="float32",
                                                 remat="block")
    ocfg = O.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    st = L.TrainState.create(cfg, ocfg, device="cpu")
    step = L.make_train_step(cfg, ocfg)
    p1, _, m = step(st.params, st.opt_state, D.make_batch(cfg, 4, 16))
    assert np.isfinite(float(m["loss"]))
    d = sum(float(torch.sum(torch.abs(a - b))) for a, b in
            zip(tree_leaves(st.params), tree_leaves(p1)))
    assert d > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_equals_forward(arch):
    """The differentiable forward gives the inference forward's logits bit
    for bit, remat on and off (S = 130 crosses xlstm's 128-step chunk)."""
    _, cfg, _, pp = model(arch)
    rng = np.random.default_rng(1)
    S = 130 if arch == "xlstm-350m" else SEQ
    kw = {"tokens": _t(rng.integers(0, cfg.vocab, (2, S)))}
    if cfg.enc_layers:
        kw["enc_embeds"] = _t((rng.standard_normal((2, FRAMES, cfg.d_model))
                               * 0.02).astype(np.float32))
    want, _ = T.forward(pp, cfg, **kw)
    for remat in ("block", "none"):
        leaves = {k: v for k, v in pp.items()}
        leaves["embed"] = pp["embed"].clone().requires_grad_()
        got, aux = T.forward_train(leaves, cfg.scaled(remat=remat), **kw)
        assert got.requires_grad
        assert torch.equal(got.detach(), want), remat
        assert float(aux) == 0.0


def test_batch_to_casts_only_float_inputs():
    """``batch_to``'s ``float_dtype`` (the launcher and the example feed a
    bf16 model whisper's float32 frame embeddings): floats cast, integers
    int64, device tensors as given."""
    b = D.make_batch(get_config("whisper-base").smoke_config(), 2, 5,
                     enc_len=3)
    got = L.batch_to(b, CPU, torch.bfloat16)
    assert got["enc_embeds"].dtype == torch.bfloat16
    assert torch.equal(got["enc_embeds"],
                       torch.as_tensor(b["enc_embeds"]).bfloat16())
    assert got["tokens"].dtype == got["labels"].dtype == torch.int64
    t = torch.ones(2, 3)
    assert L.batch_to({"e": t}, CPU, torch.bfloat16)["e"] is t
    assert L.batch_to(b, CPU)["enc_embeds"].dtype == torch.float32


def test_require_supported_raises_only_for_unknown_block_kinds():
    for arch in ALL_ARCHS:
        T.require_supported(get_config(arch), grad=True)
    cfg = get_config("qwen3-4b").smoke_config().scaled(block_kind="rwkv")
    for grad in (False, True):
        with pytest.raises(NotImplementedError, match="unknown block kind"):
            T.require_supported(cfg, grad=grad)


def test_xlstm_chunk_graphs_first_captured_inside_a_checkpoint(monkeypatch):
    """A pair under non-reentrant activation checkpointing whose chunk
    graphs are captured during its forward (no graph cached yet, as in a
    process's first xlstm step on the card): the capture's autograd graph
    stays out of the checkpoint's saved-tensor hooks, so the recompute
    (which replays) saves what the forward saved, and the gradients are
    the eager chunks' bits."""
    _, cfg, _, pp = model("xlstm-350m")
    x = torch.randn(2, 200, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5)) * 0.5
    ppp = {k: v[0].clone() for k, v in pp["pairs"].items()}
    runs = []
    for graphs in (False, True):
        PX._GRAPHS.clear()
        monkeypatch.setattr(PX, "_use_graphs", lambda dev, on=graphs: on)
        leaves = [x.clone().requires_grad_()] + \
            [ppp[k].clone().requires_grad_() for k in sorted(ppp)]

        def pair(xx, *ws):
            st = PX.init_xlstm_state(cfg, 2, CPU)
            return PX.xlstm_pair_scan(xx, dict(zip(sorted(ppp), ws)), cfg,
                                      st)[0]
        y = torch.utils.checkpoint.checkpoint(pair, *leaves,
                                              use_reentrant=False)
        runs.append([y, *torch.autograd.grad(y.square().sum(), leaves)])
    monkeypatch.undo()
    PX._GRAPHS.clear()
    for a, b in zip(*runs):
        assert torch.equal(a.detach(), b.detach())
