"""Port parity, training slice: ``repro_torch.training`` and the
differentiable forward against the JAX reference, on the same numpy
inputs.

- the token stream bitwise (``SyntheticLM``, ``MemmapTokens``,
  ``make_batch``'s embeddings), ``lr_at`` over a schedule;
- loss and every gradient leaf at the qwen3-4b and phi3.5-moe smoke
  configs in float32 (remat on and off), within 1e-5 relative to the
  reference's largest gradient element of the leaf, after
  ``convert.params_from_arrays``;
- one train step's parameters per moment kind (float32, bfloat16, int8)
  and a second step from the reference's optimizer state carried across
  by ``convert.opt_state_from_arrays``; microbatch equivalence below
  5e-3 (``tests/test_training.py``'s limit) and against the reference;
- ``cross_entropy`` with masked labels and the z-loss;
- checkpoints read both ways, bitwise, bf16 and int8 leaves included;
- the sharding spec rules equal to the reference's ``PartitionSpec``s;
- the port's own counterparts of ``tests/test_training.py`` (loss
  descent, restart loop, straggler detector) and the launcher on the
  CPU (``python -m repro_torch.launch.train``), resumed from a
  checkpoint.

The flash kernel's Function, the column-tiled segment reduce and a train
step on the card are in ``tests/test_torch_on_card.py``.
"""

import json
import os
import types

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import sharding as RSH  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import checkpoint as RC  # noqa: E402
from repro.training import data as RD  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro.training import train_loop as RL  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (opt_state_from_arrays,  # noqa: E402
                                 params_from_arrays)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import checkpoint as C  # noqa: E402
from repro_torch.training import data as D  # noqa: E402
from repro_torch.training import fault as F  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as L  # noqa: E402
from repro_torch.training.pytree import tree_leaves, tree_map  # noqa: E402

CPU = torch.device("cpu")
QWEN, PHI = "qwen3-4b", "phi3.5-moe-42b-a6.6b"
GRAD_REL = 1e-5


def configs(arch, **kw):
    kw = {"dtype": "float32", "remat": "block", **kw}
    return (ref_get_config(arch).smoke_config().scaled(**kw),
            get_config(arch).smoke_config().scaled(**kw))


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def ref_params(rcfg, seed=0):
    return RT.init_params(jax.random.PRNGKey(seed), rcfg)


def port_params(cfg, rp):
    return params_from_arrays(cfg, np_tree(rp), device="cpu")


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,rank", [(0, 0, 0), (3, 17, 1),
                                            (2 ** 40, 123456, 7)])
def test_synthetic_tokens_bitwise(seed, step, rank):
    a = RD.SyntheticLM(vocab=151936, seq_len=64, batch=4, seed=seed,
                       rank=rank).batch_at(step)
    b = D.SyntheticLM(vocab=151936, seq_len=64, batch=4, seed=seed,
                      rank=rank).batch_at(step)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_memmap_tokens_bitwise(tmp_path):
    data = (np.arange(20000, dtype=np.uint32) * 7919) % 50000
    f = tmp_path / "toks.bin"
    data.astype(np.uint16).tofile(f)
    kw = dict(vocab=40000, seq_len=32, batch=4, world=2, rank=1, seed=5)
    a = RD.MemmapTokens(str(f), **kw)
    b = D.MemmapTokens(str(f), **kw)
    assert a.n_windows == b.n_windows
    for s in (0, 3, 99):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a.batch_at(s)[k], b.batch_at(s)[k])


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-base", QWEN])
def test_make_batch_bitwise(arch):
    a = RD.make_batch(ref_get_config(arch).smoke_config(), 2, 8, step=4,
                      seed=1, rank=2, enc_len=6)
    b = D.make_batch(get_config(arch).smoke_config(), 2, 8, step=4,
                     seed=1, rank=2, enc_len=6)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_lr_schedule_matches_reference():
    for ocfg in (RO.OptConfig(lr=1e-3, warmup_steps=10, decay_steps=100,
                              min_lr_frac=0.1),
                 RO.OptConfig()):
        pcfg = O.OptConfig(**{f: getattr(ocfg, f) for f in
                              ocfg.__dataclass_fields__})
        steps = np.arange(0, 12000, 7)
        want = np.asarray(jax.vmap(lambda s: RO.lr_at(ocfg, s))(
            jnp.asarray(steps, jnp.int32)))
        got = O.lr_at(pcfg, torch.as_tensor(steps, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    assert float(O.lr_at(O.OptConfig(lr=1e-3, warmup_steps=10), 0)) == 0.0


# ------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", [QWEN, PHI])
def test_loss_and_grads_match_reference(arch, remat):
    rcfg, cfg = configs(arch, remat=remat)
    rp = ref_params(rcfg)
    b = RD.make_batch(rcfg, 2, 16, step=3)
    tc = RL.TrainConfig()
    (rl, rm), rg = jax.value_and_grad(RL.make_loss_fn(rcfg, tc),
                                      has_aux=True)(rp, jbatch(b))
    (pl, pm), pg = L.value_and_grad(L.make_loss_fn(cfg, L.TrainConfig()),
                                    port_params(cfg, rp),
                                    L.batch_to(b, CPU))
    np.testing.assert_allclose(float(pl), float(rl), rtol=GRAD_REL)
    np.testing.assert_allclose(float(pm["aux"]), float(rm["aux"]),
                               rtol=GRAD_REL, atol=1e-7)
    rgl, pgl = jax.tree_util.tree_leaves(rg), tree_leaves(pg)
    assert len(rgl) == len(pgl)
    for a, g in zip(rgl, pgl):
        a = np.asarray(a)
        assert g.shape == a.shape
        np.testing.assert_allclose(g.numpy(), a, rtol=0,
                                   atol=GRAD_REL * np.abs(a).max())


def test_forward_train_equals_inference_forward():
    _, cfg = configs(QWEN)
    p = T.init_params(cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    want, _ = T.forward(p, cfg, tokens=toks)
    for remat in ("block", "none"):
        got, aux = T.forward_train(p, cfg.scaled(remat=remat), tokens=toks)
        assert torch.equal(got.detach(), want)
        assert float(aux) == 0.0


def test_remat_gives_the_same_gradients():
    _, cfg = configs(PHI)
    p = T.init_params(cfg, device="cpu")
    b = L.batch_to(D.make_batch(cfg, 2, 16), CPU)
    grads = [L.value_and_grad(L.make_loss_fn(cfg.scaled(remat=r),
                                             L.TrainConfig()), p, b)[1]
             for r in ("block", "none")]
    for a, c in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        assert torch.equal(a, c)


# --------------------------------------------------------------- the step
def _ocfg(**kw):
    kw = dict(lr=1e-2, warmup_steps=1, decay_steps=100, **kw)
    return RO.OptConfig(**kw), O.OptConfig(**kw)


# An Adam step moves a parameter by about lr whatever the size of its
# gradient: where |g| is near eps (1e-8), g / (|g| + eps) amplifies the two
# packages' 1e-8-absolute gradient differences, and a few elements of a
# leaf land up to 3% of a step apart.  So a step is held twice: every
# element within the reference's 5e-3 (tests/test_training.py's microbatch
# limit), and each leaf's difference within 1e-3 of the norm of the
# reference's own step on that leaf.
# A second step from int8 moments is worse conditioned still: a v row's
# small entries quantize to 0, leaving updates that go as 1/|g|, so a few
# elements a leaf move by up to 2.4e-2 (lr 1e-2) and the step is held by
# its norm only, to 1e-2 (the reference holds 8-bit Adam to float32 Adam's
# loss within 5e-2 over five steps).
STEP_ATOL, STEP_NORM_REL, INT8_STEP_NORM_REL = 5e-3, 1e-3, 1e-2


def _close_step(got, want, before, atol=STEP_ATOL, norm_rel=STEP_NORM_REL):
    for g, w, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(before)):
        g = g.float().numpy().astype(np.float64)
        w = np.asarray(w).astype(np.float64)
        b = np.asarray(b).astype(np.float64)
        if atol is not None:
            assert np.abs(g - w).max() <= atol
        assert np.linalg.norm(g - w) <= norm_rel * np.linalg.norm(w - b)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_step_matches_reference(moments):
    """One train step, then a second from the reference's optimizer state
    carried across: the parameters as ``_close_step`` holds them (the
    int8 second step by its norm), the first moments within 1e-6 + 1e-4
    |m| (int8: one quantum)."""
    rcfg, cfg = configs(QWEN)
    rocfg, ocfg = _ocfg(moments_dtype=moments)
    rp = ref_params(rcfg, seed=1)
    rstep = jax.jit(RL.make_train_step(rcfg, rocfg, RL.TrainConfig()))
    pstep = L.make_train_step(cfg, ocfg)
    b0, b1 = (RD.make_batch(rcfg, 2, 16, step=s) for s in (0, 1))
    ro = RO.init_opt_state(rp, rocfg)
    rp1, ro1, rm = rstep(rp, ro, jbatch(b0))
    pp = port_params(cfg, rp)
    pp1, po1, pm = pstep(pp, O.init_opt_state(pp, ocfg), b0)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    _close_step(pp1, rp1, rp)
    assert int(po1["step"]) == 1 and po1["step"].dtype == torch.int32
    for g, w in zip(tree_leaves(po1["m"]),
                    jax.tree_util.tree_leaves(ro1["m"])):
        w = np.asarray(w).astype(np.float32)
        tol = 1.0 if g.dtype == torch.int8 else 1e-6 + 1e-4 * np.abs(w)
        assert np.all(np.abs(g.float().numpy() - w) <= tol)
    # the second step from the reference's state, carried across
    pp1 = port_params(cfg, rp1)
    po1 = opt_state_from_arrays(pp1, np_tree(ro1))
    rp2, _, _ = rstep(rp1, ro1, jbatch(b1))
    pp2, _, _ = pstep(pp1, po1, b1)
    if moments == "int8":
        _close_step(pp2, rp2, rp1, atol=None, norm_rel=INT8_STEP_NORM_REL)
    else:
        _close_step(pp2, rp2, rp1)


def test_opt_state_from_arrays_checks_shapes():
    rcfg, cfg = configs(QWEN)
    rp = ref_params(rcfg)
    pp = port_params(cfg, rp)
    ro = np_tree(RO.init_opt_state(rp, RO.OptConfig(moments_dtype="int8")))
    po = opt_state_from_arrays(pp, ro)
    assert po["m"]["embed"]["q"].dtype == torch.int8
    ro["v"]["embed"]["s"] = ro["v"]["embed"]["s"][:, 0]
    with pytest.raises(ValueError):
        opt_state_from_arrays(pp, ro)
    with pytest.raises(KeyError):
        opt_state_from_arrays(pp, {"m": ro["m"], "step": 0})


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_donated_step_is_the_functional_step(moments):
    _, cfg = configs(QWEN)
    ocfg = O.OptConfig(lr=1e-2, warmup_steps=1, moments_dtype=moments)
    st = L.TrainState.create(cfg, ocfg, device="cpu")
    b = D.make_batch(cfg, 2, 8)
    p1, o1, _ = L.make_train_step(cfg, ocfg)(st.params, st.opt_state, b)
    keep = [t.clone() for t in tree_leaves(st.params)]
    p2, o2, _ = L.make_train_step(cfg, ocfg, donate=True)(
        st.params, st.opt_state, b)
    assert all(torch.equal(a, c) for a, c in
               zip(tree_leaves((p1, o1)), tree_leaves((p2, o2))))
    assert tree_leaves(p2)[0] is tree_leaves(st.params)[0]
    assert not torch.equal(keep[0], tree_leaves(p2)[0])


def test_microbatch_equivalence():
    """G = 4 microbatches against one batch (the reference's 5e-3), and the
    port's G = 4 step against the reference's."""
    rcfg, cfg = configs(QWEN)
    rp = ref_params(rcfg)
    b = RD.make_batch(rcfg, 8, 16)
    ocfg = O.OptConfig()
    outs = [L.make_train_step(cfg, ocfg, L.TrainConfig(microbatches=G))(
        port_params(cfg, rp), O.init_opt_state(port_params(cfg, rp), ocfg),
        b)[0] for G in (1, 4)]
    d = max(float((a - c).abs().max()) for a, c in
            zip(tree_leaves(outs[0]), tree_leaves(outs[1])))
    assert d < 5e-3, d
    rocfg = RO.OptConfig()
    want = RL.make_train_step(rcfg, rocfg, RL.TrainConfig(microbatches=4))(
        rp, RO.init_opt_state(rp, rocfg), jbatch(b))[0]
    _close_step(outs[1], want, rp)


def test_loss_decreases():
    _, cfg = configs(QWEN)
    ocfg = O.OptConfig(lr=1e-2, warmup_steps=5, decay_steps=100)
    st = L.TrainState.create(cfg, ocfg, device="cpu")
    step = L.make_train_step(cfg, ocfg, donate=True)
    losses = []
    for i in range(30):
        st.params, st.opt_state, m = step(
            st.params, st.opt_state, D.make_batch(cfg, 8, 32, step=i % 4))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_cross_entropy_masked_zloss_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 29)) * 3).astype(np.float32)
    labels = rng.integers(0, 29, (3, 7)).astype(np.int32)
    labels[rng.random((3, 7)) < 0.3] = -1
    for z in (0.0, 1e-4, 0.5):
        want = float(RL.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), z))
        got = L.cross_entropy(torch.as_tensor(logits),
                              torch.as_tensor(labels), z)
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
        rg = jax.grad(lambda x: RL.cross_entropy(x, jnp.asarray(labels), z))(
            jnp.asarray(logits))
        x = torch.as_tensor(logits).requires_grad_()
        g, = torch.autograd.grad(L.cross_entropy(x, torch.as_tensor(labels),
                                                 z), x)
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5,
                                   atol=1e-7)
    allmasked = torch.full((1, 3), -1)
    assert float(L.cross_entropy(torch.zeros(1, 3, 5), allmasked)) == 0.0


# ------------------------------------------------------------ checkpoints
def _state_tree(seed=0):
    """A params + int8 / bf16 optimizer tree in both packages' form."""
    rcfg, cfg = configs(QWEN, dtype="bfloat16")
    rp = ref_params(rcfg, seed)
    ro = RO.init_opt_state(rp, RO.OptConfig(moments_dtype="int8"))
    ro = jax.tree.map(lambda a: a + 3 if a.dtype == jnp.int8 else a, ro)
    rtree = {"params": rp, "opt": ro}
    pp = port_params(cfg, rp)
    ptree = {"params": pp, "opt": opt_state_from_arrays(pp, np_tree(ro))}
    return rtree, ptree


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_checkpoint_reference_to_port_bitwise(tmp_path):
    rtree, ptree = _state_tree()
    RC.save_checkpoint(str(tmp_path), 7, rtree, extra={"step": 7})
    got, extra = C.load_checkpoint(str(tmp_path), 7, ptree)
    assert extra == {"step": 7}
    assert C.latest_step(str(tmp_path)) == 7
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(rtree)):
        assert g.dtype == (torch.bfloat16 if np.asarray(w).dtype.name ==
                           "bfloat16" else torch.as_tensor(
                               np.asarray(w)).dtype)
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.view(torch.int16).numpy()
                                          .view(np.uint16), _bits(w))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_checkpoint_port_to_reference_bitwise(tmp_path):
    rtree, ptree = _state_tree(seed=2)
    C.save_checkpoint(str(tmp_path), 3, ptree, extra={"step": 3, "x": [1]})
    got, extra = RC.load_checkpoint(str(tmp_path), 3, rtree)
    assert extra == {"step": 3, "x": [1]}
    for g, w in zip(jax.tree_util.tree_leaves(got), tree_leaves(ptree)):
        if w.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bits(g), w.view(torch.int16)
                                          .numpy().view(np.uint16))
        else:
            assert np.asarray(g).dtype == w.numpy().dtype
            np.testing.assert_array_equal(np.asarray(g), w.numpy())
    # the same manifest either way
    d = tmp_path / "ref"
    RC.save_checkpoint(str(d), 3, rtree, extra={"step": 3, "x": [1]})
    mine = json.loads((tmp_path / "step_00000003" / "manifest.json")
                      .read_text())
    theirs = json.loads((d / "step_00000003" / "manifest.json").read_text())
    assert mine == theirs
    for leaf in mine["leaves"].values():
        assert (tmp_path / "step_00000003" / leaf["file"]).read_bytes() == \
            (d / "step_00000003" / leaf["file"]).read_bytes()


def test_checkpoint_manager_keeps_and_resumes(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.bfloat16) * 0.5,
            "s": torch.zeros((), dtype=torch.int32)}
    mgr = C.CheckpointManager(str(tmp_path), keep=2, every=2)
    for s in range(1, 8):
        mgr.maybe_save(s, tree, extra={"step": s})
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000006"]
    s, got, extra = mgr.restore_latest(tree)
    assert s == 6 and extra == {"step": 6}
    assert torch.equal(got["w"], tree["w"]) and got["s"].shape == ()
    assert C.CheckpointManager(str(tmp_path / "empty")).restore_latest(
        tree) == (None, None, None)


# --------------------------------------------------------------- sharding
MESHES = [{"data": 1, "model": 1}, {"data": 4, "model": 2},
          {"data": 8, "model": 16}, {"pod": 2, "data": 16, "model": 8},
          {"data": 3, "model": 5}]


def _ref_mesh(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


@pytest.mark.parametrize("arch", [QWEN, PHI, "kimi-k2-1t-a32b",
                                  "hymba-1.5b", "xlstm-350m",
                                  "whisper-base"])
def test_sharding_specs_match_reference(arch):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rp = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
    pp = T.init_params(cfg, device="meta")
    for sizes in MESHES:
        mesh = _ref_mesh(sizes)
        want = RSH.param_specs(rp, rcfg, mesh)
        got = SH.param_specs(pp, cfg, sizes)
        wl = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        assert [tuple(w) for w in wl] == tree_leaves_specs(got)
        assert SH.dp_axes(sizes) == RSH.dp_axes(mesh)
        for seq in (False, True):
            assert SH.batch_spec(sizes, seq_shard=seq) == tuple(
                RSH.batch_spec(mesh, seq_shard=seq))
        for batch, s_max in ((16, 64), (3, 48)):
            rc = jax.eval_shape(lambda: RT.init_cache(rcfg, batch, s_max,
                                                      enc_len=8))
            pc = T.init_cache(cfg, batch, s_max, device="meta", enc_len=8)
            wc = RSH.cache_specs(rc, rcfg, mesh, batch, s_max)
            gc_ = SH.cache_specs(pc, cfg, sizes, batch, s_max)
            wcl = jax.tree_util.tree_leaves(wc, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))
            assert [tuple(w) for w in wcl] == tree_leaves_specs(gc_)
    x = torch.ones(2, 3)
    assert SH.constrain(x, model_dim=1) is x


def tree_leaves_specs(tree):
    """Spec leaves in the reference's (sorted-key) order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in tree_leaves_specs(tree[k])]
    return [tree]


# -------------------------------------------------------- restart loop
def test_run_with_restarts_resumes(tmp_path):
    mgr = C.CheckpointManager(str(tmp_path), every=2)
    seen = {"fail": False, "steps": []}

    def step_fn(step, state):
        seen["steps"].append(step)
        if step == 5 and not seen["fail"]:
            seen["fail"] = True
            raise F.SimulatedFailure("node died")
        state["tree"] = {"x": torch.tensor(float(step))}
        return state

    out = F.run_with_restarts(step_fn, {"tree": {"x": torch.tensor(0.0)},
                                        "step": 0}, mgr, total_steps=10,
                              max_restarts=2)
    assert out["step"] == 10 and seen["fail"]
    # resumed from the checkpoint at step 4, not from zero
    assert seen["steps"] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9]


@pytest.mark.parametrize("times,flags", [
    ([0.1 + 0.001 * i for i in range(20)] + [1.5], [False] * 20 + [True]),
    ([0.1] * 15 + [0.1001, 0.105, 0.5], [False] * 17 + [True]),
    ([0.1, 9.9, 0.1, 5.0, 0.1, 0.1, 0.1, 0.1, 0.1], [False] * 9)])
def test_straggler_detector_matches_reference(times, flags):
    """The reference's z-score detector, flag for flag."""
    from repro.training.fault import StragglerDetector as RSD
    a, b = RSD(window=20, z_threshold=3.0), F.StragglerDetector(
        window=20, z_threshold=3.0)
    got = [b.observe(t) for t in times]
    assert got == [a.observe(t) for t in times] == flags
    assert b.history == times


# --------------------------------------------------------------- launcher
def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU prints the
    reference's step lines; with ``--ckpt`` a second run resumes at the
    saved step."""
    args = ["--smoke", "--batch", "2", "--seq", "16", "--device", "cpu"]
    assert launch_train.main(args + ["--steps", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "arch=qwen3-4b-smoke params~0.1M devices=1"
    assert [ln.split(" loss=")[0] for ln in lines[1:-1]] == \
        ["step    0", "step    2"]
    assert all("lr=" in ln and ln.endswith("s/step)") for ln in lines[1:-1])
    assert lines[-1] == "done"
    ck = ["--ckpt", str(tmp_path), "--ckpt-every", "1"]
    launch_train.main(args + ck + ["--steps", "2"])
    capsys.readouterr()
    assert C.latest_step(str(tmp_path)) == 2
    launch_train.main(args + ck + ["--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "resumed at step 2"
    assert out[2].startswith("step    3 loss=") and out[-1] == "done"


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m",
                                  "whisper-base"])
def test_launch_train_families_on_cpu(arch, capsys):
    """The launcher trains every family: two smoke steps of hymba, xlstm
    and whisper (whose batches carry ``enc_embeds``), finite losses."""
    assert launch_train.main(["--arch", arch, "--smoke", "--batch", "2",
                              "--seq", "12", "--steps", "2", "--device",
                              "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke params~")
    assert [ln.split(" loss=")[0] for ln in lines[1:-1]] == \
        ["step    0", "step    1"]
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0]))
               for ln in lines[1:-1])
    assert lines[-1] == "done"


@pytest.mark.parametrize("flag", ["--dp", "--tp", "--pods", "--devices"])
def test_launch_train_refuses_multi_device(flag):
    with pytest.raises(SystemExit, match="torchrun"):
        launch_train.main(["--smoke", "--device", "cpu", flag, "2"])
