"""Port parity, the model families brought by the twelfth slice: hymba
(attention and SSM heads in parallel, per-layer windows), xlstm ((mLSTM,
sLSTM) pairs), whisper (encoder-decoder with cross-attention) and llava
(``embeds=``), against the JAX reference on float32 smoke configs with one
set of weights carried across by ``convert.params_from_arrays``.

Tolerance rtol = atol = 2e-4 throughout (the reference's
``tests/test_models.py:62-75``).  Two reference faults are pinned here and
not copied (ROADMAP Queue 3): the reference's xlstm scan returns its state
after the pad steps of its last 128-step chunk, so its decode after a
prefill of 130 tokens leaves its own forward; and the reference engine's
decode drops hymba's SSM heads and per-layer windows, so its streams leave
direct greedy decoding.  The port is held against the reference's forward
and against direct greedy decoding there.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models import xlstm as RX  # noqa: E402
from repro.serving.engine import Request as RRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RServeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import ssm as PSSM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models import xlstm as PX  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

TOL = 2e-4
FAMILIES = ["hymba-1.5b", "xlstm-350m", "whisper-base", "llava-next-34b"]
_MODELS = {}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _t(a):
    return torch.as_tensor(np.array(a))


def model(arch, **scaled):
    """(ref cfg, port cfg, ref params, port params) of ``arch``'s f32
    smoke config, one set of weights, built once per module."""
    key = (arch, tuple(sorted(scaled.items())))
    if key not in _MODELS:
        kw = dict(dtype="float32", remat="none", **scaled)
        rcfg = ref_get_config(arch).smoke_config().scaled(**kw)
        pcfg = get_config(arch).smoke_config().scaled(**kw)
        rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
        pp = params_from_arrays(pcfg, jax.tree.map(np.asarray, rp),
                                device="cpu")
        _MODELS[key] = (rcfg, pcfg, rp, pp)
    return _MODELS[key]


def _inputs(cfg, B, S, seed=0):
    """The same inputs as (reference kwargs, port kwargs): tokens, or
    ``embeds`` for the vlm, plus ``enc_embeds`` (24 frames) for audio."""
    rng = np.random.default_rng(seed)
    ref, port = {}, {}
    if cfg.family == "vlm":
        e = (rng.standard_normal((B, S, cfg.d_model)) * 0.02) \
            .astype(np.float32)
        ref["embeds"], port["embeds"] = jnp.asarray(e), _t(e)
    else:
        tok = rng.integers(0, cfg.vocab, (B, S))
        ref["tokens"] = jnp.asarray(tok, jnp.int32)
        port["tokens"] = _t(tok)
    if cfg.family == "audio":
        e = (rng.standard_normal((B, 24, cfg.d_model)) * 0.02) \
            .astype(np.float32)
        ref["enc_embeds"], port["enc_embeds"] = jnp.asarray(e), _t(e)
    return ref, port


# --------------------------------------------------------------- the params
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_tree_matches_reference(arch):
    rcfg, pcfg, rp, pp = model(arch)
    flat_r = {"/".join(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(rp)[0]}

    def walk(tree, where=""):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                yield from walk(leaf, f"{where}{name}/")
            else:
                yield f"{where}{name}", leaf
    flat_p = dict(walk(pp))
    assert set(flat_p) == set(flat_r)
    for name, leaf in flat_p.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(flat_r[name]))
    meta = PT.init_params(pcfg, device="meta")
    assert {n: (tuple(l.shape), l.dtype) for n, l in walk(meta)} == \
        {n: (tuple(l.shape), l.dtype) for n, l in flat_p.items()}


# --------------------------------------------- forward, prefill and decode
@pytest.mark.parametrize("arch,S", [("hymba-1.5b", 24), ("xlstm-350m", 9),
                                    ("xlstm-350m", 128),
                                    ("whisper-base", 12),
                                    ("llava-next-34b", 12)])
def test_forward_prefill_decode_match(arch, S):
    """forward, prefill and three decode steps.  hymba's 24 tokens pass its
    smoke window of 16 on the sliding layer."""
    rcfg, pcfg, rp, pp = model(arch)
    rin, pin = _inputs(pcfg, 2, S)
    rl, raux = RT.forward(rp, rcfg, **rin)
    pl, paux = PT.forward(pp, pcfg, **pin)
    _close(pl, rl)
    _close(paux, raux)
    s_max = S + 6
    rlg, rc = RT.prefill(rp, rcfg, s_max=s_max, **rin)
    plg, pc = PT.prefill(pp, pcfg, s_max=s_max, **pin)
    _close(plg, rlg)
    _close(plg, pl[:, -1])
    nxt = np.asarray(jnp.argmax(rlg, -1))
    for _ in range(3):
        rlg, rc = RT.decode_step(rp, rcfg, jnp.asarray(nxt, jnp.int32), rc)
        plg, pc = PT.decode_step(pp, pcfg, _t(nxt), pc)
        _close(plg, rlg)
        nxt = np.asarray(jnp.argmax(rlg, -1))
    assert pc["pos"] == int(rc["pos"])
    if arch == "hymba-1.5b":
        _close(pc["h"], rc["h"])
    if arch == "whisper-base":
        _close(pc["ck"], rc["ck"])
        _close(pc["cv"], rc["cv"])
    if arch == "xlstm-350m":
        for name in rc["pairs"]:
            _close(pc["pairs"][name], rc["pairs"][name])


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` on the port (its own
    forward), and on every family against the reference's forward."""
    for arch in ["qwen3-4b"] + FAMILIES:
        rcfg, pcfg, rp, pp = model(arch)
        rin, pin = _inputs(pcfg, 1, 9, seed=3)
        rfull, _ = RT.forward(rp, rcfg, **rin)
        full, _ = PT.forward(pp, pcfg, **pin)
        _close(full, rfull)
        head = {k: (v[:, :8] if k != "enc_embeds" else v)
                for k, v in pin.items()}
        lg, cache = PT.prefill(pp, pcfg, s_max=16, **head)
        _close(lg, full[:, 7])
        if pcfg.family == "vlm":
            continue         # the next input is an embedding, not a token
        lg2, _ = PT.decode_step(pp, pcfg, pin["tokens"][:, 8], cache)
        _close(lg2, full[:, 8])
        _close(lg2, rfull[:, 8])


def test_sliding_window_restricts_context():
    """With window w, logits at position t must not depend on tokens
    < t - w (the reference's test, on the port)."""
    _, pcfg, _, pp = model("hymba-1.5b", ssm_heads=0,
                           block_kind="transformer", attn_window=4,
                           global_layer_every=0)
    rng = np.random.default_rng(0)
    t1 = rng.integers(0, pcfg.vocab, (1, 12))
    t2 = t1.copy()
    t2[:, 0] = (t1[:, 0] + 1) % pcfg.vocab            # perturb the past
    l1, _ = PT.forward(pp, pcfg, tokens=_t(t1))
    l2, _ = PT.forward(pp, pcfg, tokens=_t(t2))
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not torch.allclose(l1[:, 1], l2[:, 1])


def test_hymba_windows_and_global_layers():
    cfg = get_config("hymba-1.5b")
    w = PT.hymba_windows(cfg, 4096)
    np.testing.assert_array_equal(w, RT.hymba_windows(
        ref_get_config("hymba-1.5b"), 4096))
    assert list(np.flatnonzero(w == 4096)) == [0, 8, 16, 24]
    assert set(w.tolist()) == {2048, 4096}
    assert PT.layer_windows(get_config("qwen3-4b"), 64) == [64] * 36


def test_hymba_global_layer_sees_past_the_window():
    """The smoke config's layer 0 is global, layer 1 slides over 16 keys:
    at 40 tokens the last logits depend on token 0 only through the global
    layer, and match the reference's."""
    rcfg, pcfg, rp, pp = model("hymba-1.5b")
    rin, pin = _inputs(pcfg, 1, 40, seed=5)
    pin2 = {"tokens": pin["tokens"].clone()}
    pin2["tokens"][0, 0] = (pin2["tokens"][0, 0] + 1) % pcfg.vocab
    l1, _ = PT.forward(pp, pcfg, **pin)
    l2, _ = PT.forward(pp, pcfg, **pin2)
    assert not torch.allclose(l1[:, -1], l2[:, -1], atol=1e-6)
    _close(l1, RT.forward(rp, rcfg, **rin)[0])


# ------------------------------------------------------------ the SSM alone
@pytest.mark.parametrize("S,chunk", [(1, 256), (21, 8), (37, 256), (64, 16)])
def test_ssm_scan_and_step_match(S, chunk, rng):
    rcfg, pcfg, rp, pp = model("hymba-1.5b")
    rbp = jax.tree.map(lambda a: a[0], rp["blocks"])
    pbp = PT.layer(pp["blocks"], 0)
    x = (rng.standard_normal((2, S, pcfg.d_model)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((2, pcfg.ssm_heads, pcfg.hd, pcfg.ssm_state))
          * 0.1).astype(np.float32)
    ry, rh = RSSM.ssm_scan(jnp.asarray(x), rbp, rcfg, h0=jnp.asarray(h0),
                           time_chunk=chunk)
    py, ph = PSSM.ssm_scan(_t(x), pbp, pcfg, h0=_t(h0), time_chunk=chunk)
    _close(py, ry)
    _close(ph, rh)
    ry1, rh1 = RSSM.ssm_step(jnp.asarray(x[:, :1]), rbp, rcfg, rh)
    py1, ph1 = PSSM.ssm_step(_t(x[:, :1]), pbp, pcfg, ph)
    _close(py1, ry1)
    _close(ph1, rh1)


def test_ssm_state_after_exactly_s_steps(rng):
    """The scan's state is the state of S single steps, whatever the
    chunk: the last chunk's missing steps leave it alone."""
    _, pcfg, _, pp = model("hymba-1.5b")
    pbp = PT.layer(pp["blocks"], 1)
    x = _t((rng.standard_normal((1, 11, pcfg.d_model))).astype(np.float32))
    _, h_scan = PSSM.ssm_scan(x, pbp, pcfg, time_chunk=4)
    h = torch.zeros_like(h_scan)
    for t in range(11):
        _, h = PSSM.ssm_step(x[:, t:t + 1], pbp, pcfg, h)
    _close(h_scan, h, 1e-5)


# ------------------------------------------------------- the xlstm pair alone
def test_xlstm_pair_step_matches(rng):
    rcfg, pcfg, rp, pp = model("xlstm-350m")
    rpp = jax.tree.map(lambda a: a[0], rp["pairs"])
    ppp = PT.layer(pp["pairs"], 0)
    x = (rng.standard_normal((2, 5, pcfg.d_model)) * 0.5).astype(np.float32)
    rst = RX.init_xlstm_state(rcfg, 2)
    pst = PX.init_xlstm_state(pcfg, 2, torch.device("cpu"))
    for name in rst:
        np.testing.assert_array_equal(pst[name].numpy(),
                                      np.asarray(rst[name]))
    ry, rst = RX.xlstm_pair_scan(jnp.asarray(x), rpp, rcfg, rst)
    py, pst = PX.xlstm_pair_scan(_t(x), ppp, pcfg, pst)
    _close(py, ry)
    for _ in range(3):
        x1 = (rng.standard_normal((2, 1, pcfg.d_model))).astype(np.float32)
        ry1, rst = RX.xlstm_pair_step(jnp.asarray(x1), rpp, rcfg, rst)
        py1, pst = PX.xlstm_pair_step(_t(x1), ppp, pcfg, pst)
        _close(py1, ry1)
        for name in rst:
            _close(pst[name], rst[name])


def _decode_after_prefill(T_, cfg, params, toks, to):
    lg, cache = T_.prefill(params, cfg, tokens=to(toks[:, :-1]))
    return T_.decode_step(params, cfg, to(toks[:, -1]), cache)[0]


def test_xlstm_reference_fault_pinned():
    """At S = 130 the reference's decode after its prefill leaves its own
    forward by more than 0.1 (its scan ran the pad steps to 256); the
    port's decode matches the reference's forward."""
    rcfg, pcfg, rp, pp = model("xlstm-350m")
    toks = np.random.default_rng(7).integers(0, pcfg.vocab, (1, 131))
    rfull, _ = RT.forward(rp, rcfg, tokens=jnp.asarray(toks, jnp.int32))
    ref_dec = _decode_after_prefill(RT, rcfg, rp, toks,
                                    lambda a: jnp.asarray(a, jnp.int32))
    assert float(jnp.max(jnp.abs(ref_dec - rfull[:, -1]))) > 0.1
    port_dec = _decode_after_prefill(PT, pcfg, pp, toks, _t)
    _close(port_dec, rfull[:, -1])


@pytest.mark.parametrize("S", [1, 64, 128, 256])
def test_xlstm_matches_reference_off_the_fault(S):
    """Where the reference pads nothing (S a multiple of 128, or one chunk)
    the port matches its prefill and decode."""
    rcfg, pcfg, rp, pp = model("xlstm-350m")
    toks = np.random.default_rng(S).integers(0, pcfg.vocab, (1, S + 1))
    rlg, rc = RT.prefill(rp, rcfg, tokens=jnp.asarray(toks[:, :S],
                                                      jnp.int32))
    plg, pc = PT.prefill(pp, pcfg, tokens=_t(toks[:, :S]))
    _close(plg, rlg)
    rlg2, _ = RT.decode_step(rp, rcfg, jnp.asarray(toks[:, S], jnp.int32),
                             rc)
    plg2, _ = PT.decode_step(pp, pcfg, _t(toks[:, S]), pc)
    _close(plg2, rlg2)


# ---------------------------------------------------------- cross-attention
def test_cross_attention_matches(rng):
    rcfg, pcfg, rp, pp = model("whisper-base")
    rcb = jax.tree.map(lambda a: a[0], rp["cross_blocks"])
    pcb = PT.layer(pp["cross_blocks"], 0)
    x = rng.standard_normal((2, 5, pcfg.d_model)).astype(np.float32)
    ek = rng.standard_normal((2, 24, pcfg.n_kv_heads, pcfg.hd)) \
        .astype(np.float32)
    ev = rng.standard_normal(ek.shape).astype(np.float32)
    want = RL.cross_attention(jnp.asarray(x), rcb, rcfg,
                              (jnp.asarray(ek), jnp.asarray(ev)))
    _close(PL.cross_attention(_t(x), pcb, pcfg, (_t(ek), _t(ev))), want)
    # at decode the queries are one row (Sq = 1 against 24 keys)
    want1 = RL.cross_attention(jnp.asarray(x[:, :1]), rcb, rcfg,
                               (jnp.asarray(ek), jnp.asarray(ev)))
    _close(PL.cross_attention(_t(x[:, :1]), pcb, pcfg, (_t(ek), _t(ev))),
           want1)


def test_encoder_decoder_needs_enc_embeds():
    _, pcfg, _, pp = model("whisper-base")
    with pytest.raises(ValueError, match="enc_embeds"):
        PT.prefill(pp, pcfg, tokens=_t(np.zeros((1, 4), np.int64)))


def test_llava_embeds_of_tokens_equal_tokens():
    """prefill from ``embeds = embed[tokens]`` equals prefill from
    ``tokens`` bit for bit."""
    _, pcfg, _, pp = model("llava-next-34b")
    toks = _t(np.random.default_rng(2).integers(0, pcfg.vocab, (1, 10)))
    a, ca = PT.prefill(pp, pcfg, tokens=toks)
    b, cb = PT.prefill(pp, pcfg, embeds=pp["embed"][toks])
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])


# ---------------------------------------------------------------- the engine
def _direct_greedy(T_, cfg, params, prompt, n, to, s_max):
    lg, cache = T_.prefill(params, cfg, tokens=to(np.asarray([prompt])),
                           s_max=s_max)
    out = [int(np.argmax(_np(lg)[0]))]
    for _ in range(n - 1):
        lg, cache = T_.decode_step(params, cfg, to(np.asarray([out[-1]])),
                                   cache)
        out.append(int(np.argmax(_np(lg)[0])))
    return out


def test_hymba_engine_streams_equal_direct_greedy():
    """Batch-4 engine streams (prompts of 5-30 tokens, past the smoke
    window of 16) equal the reference's direct greedy decoding token for
    token; the reference engine's own streams leave it (its decode drops
    the SSM heads), which this pins."""
    rcfg, pcfg, rp, pp = model("hymba-1.5b")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, pcfg.vocab, int(n)).tolist()
               for n in (5, 30, 17, 9, 22)]
    eng = ServeEngine(pcfg, pp, batch=4, s_max=64, device="cpu")
    assert not eng.bucket_prompts
    reqs = [Request(i, p, max_new=8) for i, p in enumerate(prompts)]
    eng.run(reqs)
    to_j = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    for r, p in zip(reqs, prompts):
        assert r.out == _direct_greedy(RT, rcfg, rp, p, 8, to_j, 64), r.rid
    reng = RServeEngine(rcfg, rp, batch=4, s_max=64)
    rreqs = [RRequest(i, p, max_new=8) for i, p in enumerate(prompts)]
    reng.run(rreqs)
    assert any(a.out != b.out for a, b in zip(rreqs, reqs))


def test_engine_refuses_recurrent_and_encoder_decoder():
    for arch in ("xlstm-350m", "whisper-base"):
        _, pcfg, _, pp = model(arch)
        with pytest.raises(NotImplementedError):
            ServeEngine(pcfg, pp, batch=2, s_max=32, device="cpu")
