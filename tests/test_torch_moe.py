"""Port parity, MoE slice: ``repro_torch.models.moe`` and MoE serving
against the JAX reference, with identical weights carried across by
``convert.params_from_arrays`` and inputs made with numpy.

- ``moe_layer`` against the reference's at decode (fused two-field
  ``FieldBundle`` reduce) and prefill (``leaf_rep`` gather) shapes, starved
  at cf 0.3 so that picks drop, and on the kimi smoke config with its
  shared expert: float32, rtol 1e-5 / atol 1e-6, aux rtol 1e-6 (the
  tolerances of the reference's ``tests/test_models.py:127-159``);
- the routing arrays (``slot``, ``keep``, ``leaf_root``) bitwise;
- SF = dense inside the port, plan-cache hits, the exact sflog event
  stream of a decode-shape layer (``tests/test_sflog.py:239``);
- full-model ``prefill`` / ``decode_step`` logits on the phi3.5-moe smoke
  config and on kimi-k2's at its head size 112 (rtol 1e-4 / atol 1e-5, as
  for the dense models);
- ``ServeEngine`` greedy streams identical to the reference engine's, same
  requests, same batch: capacity makes a token's output depend on its
  batch neighbours (idle slots feed token 0 at their stale positions), so
  MoE parity is with the reference *engine*, queue and buckets included.

- gradients through the SF dispatch (the DynPlan gathers and their
  transpose) against the port's dense dispatch and against the
  reference's gradients (``tests/test_models.py::
  test_moe_sf_grad_matches_dense``: rtol 2e-4 / atol 1e-6), at decode and
  prefill shapes, starved and not.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import sflog as RS  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving.engine import Request as RRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RServeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.core import sflog as PS  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

PHI, KIMI = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"
RTOL, ATOL, AUX_RTOL = 1e-5, 1e-6, 1e-6
F32 = 4


def configs(arch, **scaled):
    kw = dict(dtype="float32", remat="none", **scaled)
    return (ref_get_config(arch).smoke_config().scaled(**kw),
            get_config(arch).smoke_config().scaled(**kw))


def layer_params(rcfg, seed=0):
    """One layer's MoE leaves, the reference's draws, as numpy and as the
    port's tensors."""
    rp = jax.tree.map(lambda a: np.array(a[0]),
                      RM.init_moe(jax.random.PRNGKey(seed), rcfg, 1))
    return rp, {k: torch.as_tensor(v) for k, v in rp.items()}


def tokens(shape, d, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (d,)) * 0.3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def reference_layer(arch, shape, cf):
    """(x, the reference's y and aux) of one case: its jitted sf dispatch
    (its own tests hold sf = dense), computed once for both port modes."""
    rcfg, cfg = configs(arch, moe_capacity=cf)
    rp, _ = layer_params(rcfg)
    x = tokens(shape, cfg.d_model)
    ry, raux = jax.jit(lambda xx, pp: RM.moe_layer(xx, pp, rcfg))(
        jnp.asarray(x), rp)
    return x, np.asarray(ry), float(raux)


# ----------------------------------------------------------- the MoE layer
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6


@pytest.mark.parametrize("shape,cf", [((2, 48), 0.5), ((2, 48), 1.25),
                                      ((4, 1), 1.25), ((2, 16), 0.3)])
def test_moe_sf_grad_matches_dense(shape, cf):
    """Training parity: the gradients of sum(y**2) + 0.01 aux through the
    SF dispatch (the gathers' transpose through the sorted segment
    reduce; the fused two-field exchange at decode shapes) match the dense
    formulation's and the reference's, for every leaf and the input."""
    rcfg, cfg = configs(PHI, moe_capacity=cf)
    rp, _ = layer_params(rcfg)
    x = tokens(shape, cfg.d_model, seed=3)

    def port(mode):
        p = {k: torch.as_tensor(v).requires_grad_() for k, v in rp.items()}
        xx = torch.as_tensor(x).requires_grad_()
        y, aux = M.moe_layer(xx, p, cfg, dispatch=mode)
        loss = torch.sum(y ** 2) + 0.01 * aux
        return dict(zip(list(p) + ["x"], torch.autograd.grad(
            loss, list(p.values()) + [xx])))

    def loss(pp, xx):
        y, aux = RM.moe_layer(xx, pp, rcfg, dispatch="sf")
        return jnp.sum(y ** 2) + 0.01 * aux

    rg, rgx = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in rp.items()}, jnp.asarray(x))
    want = {**{k: np.asarray(v) for k, v in rg.items()}, "x": np.asarray(rgx)}
    g_sf, g_d = port("sf"), port("dense")
    for k in want:
        np.testing.assert_allclose(g_sf[k].numpy(), g_d[k].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(g_sf[k].numpy(), want[k],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("dispatch", ["sf", "dense"])
@pytest.mark.parametrize("arch,shape,cf", [
    (PHI, (2, 16), 1.25), (PHI, (4, 1), 1.25), (PHI, (2, 48), 1.25),
    (PHI, (2, 16), 0.3), (PHI, (2, 48), 0.3), (PHI, (4, 1), 0.3),
    (KIMI, (2, 16), 1.25), (KIMI, (4, 1), 1.25), (KIMI, (2, 48), 0.3)])
def test_moe_layer_matches_reference(arch, shape, cf, dispatch):
    rcfg, cfg = configs(arch, moe_capacity=cf)
    _, p = layer_params(rcfg)
    x, ry, raux = reference_layer(arch, shape, cf)
    y, aux = M.moe_layer(torch.as_tensor(x), p, cfg, dispatch=dispatch)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ry, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), raux, rtol=AUX_RTOL)


@pytest.mark.parametrize("G,T,k,E,cf", [(1, 16, 2, 4, 0.3), (3, 16, 2, 4, 1.0),
                                        (2, 40, 8, 16, 1.25),
                                        (1, 8, 2, 4, 4.0)])
def test_routing_arrays_bitwise(G, T, k, E, cf):
    """slot / keep / leaf_root: the same integers as the reference's."""
    rng = np.random.default_rng(G * 100 + T)
    eidx = np.stack([np.argsort(rng.random((T, E)), -1)[:, :k]
                     for _ in range(G)])
    C = max(int(np.ceil(T * k * cf / E)), 1)
    rs, rk = jax.vmap(lambda e: RM._capacity_slots(e, C, E))(
        jnp.asarray(eidx, jnp.int32))
    slot, keep = M._capacity_slots(torch.as_tensor(eidx), C, E)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rk))
    if cf < 1:
        assert not keep.all(), "the case must drop picks"
    np.testing.assert_array_equal(
        M.routing_leaf_root(slot, keep, C, E).numpy(),
        np.asarray(RM.routing_leaf_root(rs, rk, C, E)))
    # one group at a time, as the reference's unbatched call
    s1, k1 = M._capacity_slots(torch.as_tensor(eidx[0]), C, E)
    r1, q1 = RM._capacity_slots(jnp.asarray(eidx[0], jnp.int32), C, E)
    np.testing.assert_array_equal(s1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(k1.numpy(), np.asarray(q1))


@pytest.mark.parametrize("shape,cf", [((2, 16), 1.25), ((4, 1), 1.25),
                                      ((2, 48), 1.25), ((2, 16), 0.3),
                                      ((1, 40), 0.3)])
def test_sf_dispatch_matches_dense(shape, cf):
    """SF-routed dispatch is the dense algorithm rewired: outputs within
    the reference test's tolerance, aux equal."""
    rcfg, cfg = configs(PHI, moe_capacity=cf)
    _, p = layer_params(rcfg, seed=1)
    x = torch.as_tensor(tokens(shape, cfg.d_model, seed=6))
    y_sf, a_sf = M.moe_layer(x, p, cfg, dispatch="sf")
    y_d, a_d = M.moe_layer(x, p, cfg, dispatch="dense")
    np.testing.assert_allclose(y_sf.numpy(), y_d.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert float(a_sf) == float(a_d)


def test_starved_capacity_drops_picks():
    """cf 0.3 overflows the capacity (the starved cases above hold the
    outputs of such routings against the reference and the dense path)."""
    _, cfg = configs(PHI, moe_capacity=0.3)
    T, k, E = 16, cfg.moe_topk, cfg.moe_experts
    C = max(int(np.ceil(T * k * cfg.moe_capacity / E)), 1)
    eidx = torch.as_tensor(np.random.default_rng(1).integers(0, E, (T, k)))
    _, keep = M._capacity_slots(eidx, C, E)
    assert not bool(keep.all())
    assert int(keep.sum()) <= E * C


def test_plan_cache_hits_across_steps():
    rcfg, cfg = configs(PHI)
    _, p = layer_params(rcfg)
    x = torch.as_tensor(tokens((2, 16), cfg.d_model))
    M.plan_cache().clear()
    for _ in range(3):
        M.moe_layer(x, p, cfg, dispatch="sf")
    st = M.plan_cache().stats()
    assert st["entries"] == 1 and st["hits"] == 2 and st["misses"] == 1
    M.moe_layer(torch.as_tensor(tokens((4, 1), cfg.d_model)), p, cfg)
    assert M.plan_cache().stats()["entries"] == 2


# ----------------------------------------------- tests/test_sflog.py:239-266
def test_moe_decode_exact_event_stream():
    """One eager decode-shape MoE layer = one fused two-field reduce
    (slots x (d_model+1) f32, surfaced as both the DynPlan event and the
    FieldBundle event underneath) + one combine bcast (slots x d_model
    f32), as in the reference; slots = B*S*topk = 4*1*2 = 8."""
    rcfg, cfg = configs(PHI)
    rp, p = layer_params(rcfg)
    x = tokens((4, 1), cfg.d_model)
    slots = 4 * 1 * 2
    nb_red = float(slots * (cfg.d_model + 1) * F32)
    nb_bc = float(slots * cfg.d_model * F32)
    old = RS.set_mode("on"), PS.set_mode("on")
    try:
        got = {}
        for name, S, mod, layer, xx in (
                ("ref", RS, RM, rp, jnp.asarray(x)),
                ("port", PS, M, p, torch.as_tensor(x))):
            cfg_ = rcfg if name == "ref" else cfg
            mod.plan_cache().clear()
            mod.moe_layer(xx, layer, cfg_, dispatch="sf")
            S.reset()
            for _ in range(2):
                mod.moe_layer(xx, layer, cfg_, dispatch="sf")
            d = S.events_snapshot()
            got[name] = {k: d[k] for k in ("SFDynReduce", "SFReduceMulti",
                                           "SFDynBcast")}
            st = mod.plan_cache().stats()
            assert st["misses"] == 1 and st["hits"] == 2
    finally:
        RS.set_mode(old[0])
        PS.set_mode(old[1])
        RS.reset()
        PS.reset()
    assert got["port"] == got["ref"]
    d = got["port"]
    assert d["SFDynReduce"] == {"count": 2, "traced": 0, "bytes": 2 * nb_red}
    assert d["SFReduceMulti"] == {"count": 2, "traced": 0,
                                  "bytes": 2 * nb_red}
    assert d["SFDynBcast"] == {"count": 2, "traced": 0, "bytes": 2 * nb_bc}


# --------------------------------------------------------------- the model
# the model tests' configs: phi3.5-moe's smoke config, and kimi-k2's (its
# shared expert, GQA 2:1) at its own head size 112, which the flash
# kernels' routes must take
MODEL_CASES = {PHI: {}, KIMI: {"head_dim": 112}}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def model(request):
    """(ref cfg, port cfg, ref params, port params) of one of
    ``MODEL_CASES``' smoke configs, one set of float32 weights."""
    rcfg, cfg = configs(request.param, **MODEL_CASES[request.param])
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_arrays(cfg, jax.tree.map(np.asarray, rp),
                                device="cpu")
    return rcfg, cfg, rp, params


def test_param_tree_matches_reference(model):
    """init_params makes the reference's MoE leaves: names, shapes, dtypes
    (the router in float32 whatever the model dtype)."""
    rcfg, cfg, rp, _ = model
    for dtype in ("float32", "bfloat16"):
        mine = T.init_params(cfg.scaled(dtype=dtype), device="cpu")
        ref = jax.eval_shape(lambda: RT.init_params(
            jax.random.PRNGKey(0), rcfg.scaled(dtype=dtype)))
        assert sorted(mine["blocks"]) == sorted(ref["blocks"])
        for name, a in ref["blocks"].items():
            got = mine["blocks"][name]
            assert tuple(got.shape) == a.shape, name
            assert str(got.dtype).split(".")[-1] == str(a.dtype), name
        assert mine["blocks"]["router"].dtype == torch.float32
    kimi = get_config(KIMI).smoke_config()
    blocks = T.init_params(kimi, device="meta")["blocks"]
    assert {"shared_in", "shared_gate", "shared_out"} <= set(blocks)
    # scales as the reference's: router std 1/sqrt(D)
    std = float(T.init_params(cfg, device="cpu")["blocks"]["router"].std())
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)


def test_params_from_arrays_checks_moe_leaves(model):
    rcfg, cfg, rp, _ = model
    tree = jax.tree.map(np.asarray, rp)
    bad = dict(tree, blocks=dict(tree["blocks"]))
    bad["blocks"]["router"] = bad["blocks"]["router"].astype(np.float16)
    with pytest.raises(ValueError, match="router"):
        params_from_arrays(cfg, bad, device="cpu")
    bad["blocks"] = {k: v for k, v in tree["blocks"].items()
                     if k != "w_gate"}
    with pytest.raises(KeyError, match="w_gate"):
        params_from_arrays(cfg, bad, device="cpu")


def test_prefill_and_decode_logits_match(model):
    """Prefill of a right-padded batch (per-row ``last_pos``), then three
    greedy decode steps, against the reference."""
    rcfg, cfg, rp, params = model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, rcfg.vocab, (2, 13))
    last_pos = np.array([12, 6])
    rl, rc = RT.prefill(rp, rcfg, tokens=jnp.asarray(toks), s_max=16,
                        last_pos=jnp.asarray(last_pos))
    pl, pc = T.prefill(params, cfg, tokens=toks, s_max=16, last_pos=last_pos)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(rc["k"]),
                               rtol=1e-4, atol=1e-5)
    tok = rng.integers(0, rcfg.vocab, 2)
    for _ in range(3):
        rl, rc = RT.decode_step(rp, rcfg, jnp.asarray(tok, jnp.int32), rc)
        pl, pc = T.decode_step(params, cfg, torch.as_tensor(np.array(tok)),
                               pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-5)
        tok = np.asarray(jnp.argmax(rl, -1))


# ------------------------------------------------------------- the engine
ENGINE_CASES = {
    # a queue longer than the slots, bucketed prompts of several lengths
    "queue_and_buckets": dict(batch=2, prompts=[(1, 2, 3), (5, 6, 7, 8, 9),
                                                (3, 1, 4, 1, 5, 9, 2),
                                                (2, 7), (9, 8, 7, 6, 5, 4,
                                                         3, 2, 1)],
                              max_new=[6, 4, 7, 5, 3]),
    "one_slot_unbucketed": dict(batch=1, prompts=[(5, 6, 7), (4, 4)],
                                max_new=[5, 4], bucket_prompts=False),
    "more_slots_than_requests": dict(batch=4, prompts=[(7, 1), (2, 2, 2)],
                                     max_new=[6, 6]),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_streams_match_reference_engine(model, case):
    """The same requests through the reference and the port engine, same
    batch: identical greedy streams, token for token."""
    rcfg, cfg, rp, params = model
    c = ENGINE_CASES[case]
    kw = {k: c[k] for k in ("batch", "bucket_prompts") if k in c}
    reng = RServeEngine(rcfg, rp, s_max=32, **kw)
    rreqs = [RRequest(i, list(pr), max_new=m)
             for i, (pr, m) in enumerate(zip(c["prompts"], c["max_new"]))]
    reng.run(rreqs)
    eng = ServeEngine(cfg, params, s_max=32, device="cpu", **kw)
    reqs = [Request(i, list(pr), max_new=m)
            for i, (pr, m) in enumerate(zip(c["prompts"], c["max_new"]))]
    eng.run(reqs)
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in rreqs]
    assert eng.metrics()["prefill_buckets"] == \
        reng.metrics()["prefill_buckets"]


def test_engine_batch_one_equals_direct_greedy(model):
    """At batch 1 the engine's decode routes each token alone, as
    ``decode_step`` does: the stream is direct greedy prefill + decode."""
    _, cfg, _, params = model
    r0 = Request(0, [5, 6, 7, 8, 1], max_new=5)
    ServeEngine(cfg, params, batch=1, s_max=32, bucket_prompts=False,
                device="cpu").run([r0])
    lg, cache = T.prefill(params, cfg, tokens=[[5, 6, 7, 8, 1]], s_max=32)
    tok = torch.argmax(lg, -1)
    want = [int(tok[0])]
    for _ in range(4):
        lg, cache = T.decode_step(params, cfg, tok, cache)
        tok = torch.argmax(lg, -1)
        want.append(int(tok[0]))
    assert r0.out == want
