"""The sharded training step on a device mesh, multi-rank, on the CPU.

Four gloo ranks (``torch_dist_child.mesh_main``, one spawn for the module)
train the qwen3-4b smoke config in float32 through the launcher's path
(``launch.train.sharded_state`` + ``make_train_step(param_shardings=)``) on
(2, 2) and (4, 1) meshes; this process trains the same parameters on the
same batches at world 1 (``make_train_step`` without a mesh) and saves a
checkpoint the ranks restore into each mesh's layout, and restores the
ranks' (2, 2) checkpoint at world 1.  The same ranks then serve and train
the other families' smoke configs (phi3.5-moe with its 4 experts over
``model``, hymba, xlstm, whisper) on (2, 2) and (1, 4), held against
world 1.  The launcher's CLI under ``torchrun`` resumes a world-1
checkpoint on a 2 x 2 mesh.  The reference has no multi-rank step to
compare with (its GSPMD step is one program), so world 1 is the oracle;
the MoE layer alone on each mesh is also held against the reference's
``moe_layer(dispatch="dense")`` (JAX, imported by that test only).
"""

import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
ROOT = os.path.abspath(os.path.join(HERE, ".."))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, HERE)

import torch_dist_child as child  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training.checkpoint import (load_checkpoint,  # noqa: E402
                                             save_checkpoint)
from repro_torch.training.optimizer import OptConfig, init_opt_state  # noqa
from repro_torch.training.train_loop import make_train_step  # noqa: E402

WORLD = 4
JOIN_TIMEOUT_S = 240
MESH_TAGS = ["2x2", "4x1", "1x4"]
# the ranks' step against world 1's, float32: the matrix products and the
# norms sum their shards' partial sums in another order.  AdamW's early
# steps move a parameter by about lr x sign(g) (the bias-corrected moments
# of a lone gradient), so a gradient element within rounding of 0 may step
# the other way: every element is held within PARAM_RTOL relative plus
# FLIP_ATOL, twice the sum of the steps' learning rates (warmup 2: 1.5e-4
# then 3e-4), and all but FLIP_SHARE of them within PARAM_RTOL / ATOL.
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
FLIP_ATOL = 2 * (1.5e-4 + 3e-4)
FLIP_SHARE = 1e-3
# the other families against world 1: MoE at the reference's MoE
# tolerance (tests/test_torch_moe.py), the rest at the dense one above
# (tests/test_torch_family_training.py holds their gradients to 1e-5)
FAMILY_TOL = {"phi3.5-moe-42b-a6.6b": (2e-4, 1e-6)}
FAMILY_TAGS = ["x".join(map(str, s)) for s in child.FAMILY_MESHES]


def _named(tree):
    out = {}
    child._named(tree, "", out)
    return out


def _family_world_1(arch: str) -> dict:
    """``arch``'s smoke config at world 1: prefill and greedy decode from
    the seed-0 parameters, then ``MESH_STEPS`` plain steps."""
    cfg = child.family_config(arch)
    ocfg = OptConfig(warmup_steps=2, decay_steps=10)
    params = T.init_params(cfg, device="cpu")
    serve, _ = child.family_serve(cfg, params, child.serve_tokens(cfg),
                                  child.family_enc(cfg))
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    losses = []
    for b in child.family_batches(cfg):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return {"serve": serve, "losses": losses,
            "params": {k: v.numpy() for k, v in _named(params).items()}}


def _params_close(got: dict, want: dict, key, rtol: float, atol: float):
    """Every parameter within ``rtol`` relative plus ``FLIP_ATOL`` (a
    gradient element within rounding of 0 may step the other way), all but
    ``FLIP_SHARE`` of the elements within ``rtol`` / ``atol``."""
    flips, total = 0, 0
    for n, b in want.items():
        a = got[key(n)]
        assert a.shape == b.shape and a.dtype == b.dtype, n
        d = np.abs(a - b)
        np.testing.assert_array_less(
            d, rtol * np.abs(b) + FLIP_ATOL + 1e-30, err_msg=n)
        flips += int(np.sum(d > rtol * np.abs(b) + atol))
        total += d.size
    assert flips <= FLIP_SHARE * total, (flips, total)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = child.mesh_config()
    ocfg = OptConfig(warmup_steps=2, decay_steps=10)
    params = T.init_params(cfg, device="cpu")
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    losses = []
    for b in child.mesh_batches(cfg):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    # prefill and greedy decode at world 1 from the trained parameters
    toks = child.serve_tokens(cfg)
    logits, cache = T.prefill(params, cfg, tokens=toks,
                              s_max=child.SERVE[2])
    serve = [logits.numpy()]
    for _ in range(1, child.SERVE[3]):
        logits, cache = T.decode_step(params, cfg, logits.argmax(-1), cache)
        serve.append(logits.numpy())
    families = {arch: _family_world_1(arch) for arch in child.FAMILIES}
    ckpt_in = str(tmp / "ckpt_w1")
    save_checkpoint(ckpt_in, 5, {"params": params, "opt": opt},
                    extra={"step": 5})
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=child.mesh_main,
                         args=(r, WORLD, str(tmp / "store"), ckpt_in,
                               str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(5)
    errs = "\n".join((tmp / f"mesh_rank{r}.err").read_text()
                     for r in range(WORLD)
                     if (tmp / f"mesh_rank{r}.err").exists())
    assert not hung and not errs, errs
    with np.load(tmp / "mesh_rank0.npz") as f:
        got = dict(f)
    return {"tmp": tmp, "cfg": cfg, "ocfg": ocfg, "losses": losses,
            "serve": serve, "families": families,
            "params": {k: v.numpy() for k, v in _named(params).items()},
            "opt": opt, "got": got}


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sharded_step_loss_matches_world_1(runs, tag):
    got = [float(runs["got"][child.key(tag, "loss", i)])
           for i in range(child.MESH_STEPS)]
    np.testing.assert_allclose(got, runs["losses"], rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sharded_step_params_match_world_1(runs, tag):
    names = list(runs["got"]["names"])
    assert sorted(names) == sorted(runs["params"])
    _params_close(runs["got"], runs["params"],
                  lambda n: child.key(tag, "param", n), PARAM_RTOL,
                  PARAM_ATOL)


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_sharded_prefill_and_decode_match_world_1(runs, tag):
    """Prefill and greedy decode steps from the world-1 parameters on each
    mesh: the logits within 1e-5 of world 1's, float32 (the ranks' sums
    in another order).  Both runs start from the parameters after the
    sharded steps, which differ from world 1's by rounding, so the decode
    feeds the world-1 tokens of each step to both."""
    got = runs["got"]
    for i, want in enumerate(runs["serve"]):
        np.testing.assert_allclose(got[child.key(tag, "serve", i)], want,
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


def test_sequence_sharded_cache_where_kv_heads_do_not_divide(runs):
    # the cache (L, B, S, Hkv, hd): batch over data; 2 KV heads over
    # model = 2, the sequence over model = 4 (cache_specs)
    assert str(runs["got"][child.key("2x2", "cache_placements")]) == \
        "(Shard(dim=1), Shard(dim=3))"
    assert str(runs["got"][child.key("1x4", "cache_placements")]) == \
        "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("tag", MESH_TAGS)
def test_world_1_checkpoint_restores_under_mesh(runs, tag):
    got = runs["got"]
    assert bool(got[child.key(tag, "restored_placements_equal")])
    saved = load_checkpoint(str(runs["tmp"] / "ckpt_w1"), 5,
                            {"params": T.init_params(runs["cfg"],
                                                     device="meta")},
                            device="cpu")[0]["params"]
    for n, v in _named(saved).items():
        r = got[child.key(tag, "restored", n)]
        assert r.tobytes() == v.numpy().tobytes(), n


def test_mesh_checkpoint_restores_at_world_1(runs):
    cfg = runs["cfg"]
    template = {"params": T.init_params(cfg, device="cpu"),
                "opt": init_opt_state(T.init_params(cfg, device="cpu"),
                                      runs["ocfg"])}
    tree, extra = load_checkpoint(str(runs["tmp"] / "ckpt_mesh"), 7,
                                  template)
    assert extra == {"step": 7}
    for n, v in _named(tree["params"]).items():
        want = runs["got"][child.key("2x2", "param", n)]
        assert v.numpy().tobytes() == want.tobytes(), n


def test_placements_follow_the_spec_rules(runs):
    # wq (L, D, H*hd): (None, "data", "model") -> Shard(1) on data,
    # Shard(2) on model
    assert str(runs["got"][child.key("2x2", "placements", "wq")]) == \
        "(Shard(dim=1), Shard(dim=2))"
    assert str(runs["got"][child.key("4x1", "placements", "wq")]) == \
        "(Shard(dim=1), Shard(dim=2))"
    assert str(runs["got"][child.key("1x4", "placements", "wq")]) == \
        "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("tag", FAMILY_TAGS)
@pytest.mark.parametrize("arch", child.FAMILIES)
def test_family_step_loss_matches_world_1(runs, arch, tag):
    rtol = FAMILY_TOL.get(arch, (LOSS_RTOL,))[0]
    got = [float(runs["got"][child.key(tag, arch, "loss", i)])
           for i in range(child.MESH_STEPS)]
    np.testing.assert_allclose(got, runs["families"][arch]["losses"],
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("tag", FAMILY_TAGS)
@pytest.mark.parametrize("arch", child.FAMILIES)
def test_family_step_params_match_world_1(runs, arch, tag):
    rtol, atol = FAMILY_TOL.get(arch, (PARAM_RTOL, PARAM_ATOL))
    want = runs["families"][arch]["params"]
    assert sorted(want) == sorted(
        k.split("|")[3] for k in runs["got"]
        if k.startswith(child.key(tag, arch, "param", "")))
    _params_close(runs["got"], want,
                  lambda n: child.key(tag, arch, "param", n), rtol, atol)


@pytest.mark.parametrize("tag", FAMILY_TAGS)
@pytest.mark.parametrize("arch", child.FAMILIES)
def test_family_prefill_and_decode_match_world_1(runs, arch, tag):
    """Prefill and greedy decode steps on each mesh from the seed-0
    parameters: the logits within 1e-5 of world 1's, float32."""
    for i, want in enumerate(runs["families"][arch]["serve"]):
        np.testing.assert_allclose(
            runs["got"][child.key(tag, arch, "serve", i)], want,
            rtol=1e-5, atol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("tag", FAMILY_TAGS)
def test_family_caches_follow_cache_specs(runs, tag):
    """The prefill's mesh cache holds hymba's SSM state (batch over data,
    whole over model) and whisper's encoder K/V (heads over model) in the
    layouts ``cache_specs`` names."""
    got = runs["got"]
    assert str(got[child.key(tag, "hymba-1.5b", "cache", "h")]) == \
        "(Shard(dim=1), Replicate())"
    for n in ("ck", "cv"):
        assert str(got[child.key(tag, "whisper-base", "cache", n)]) == \
            "(Shard(dim=1), Shard(dim=3))"


@pytest.mark.parametrize("mode", ["sf", "dense"])
@pytest.mark.parametrize("tag", FAMILY_TAGS)
def test_moe_layer_on_mesh_matches_the_reference(runs, tag, mode):
    """The MoE layer alone on each mesh (experts over ``model``, each
    rank's dispatch local, the output all-reduced), both dispatch modes,
    from numpy inputs: within rtol 1e-5 / atol 1e-6 of the reference's
    ``moe_layer(dispatch="dense")`` on the same inputs, and its aux loss
    likewise."""
    import jax  # noqa: F401  (before the reference package)
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import moe as RM
    arch = child.FAMILIES[0]
    rcfg = ref_config(arch).smoke_config().scaled(dtype="float32")
    a = child.moe_layer_inputs(child.family_config(arch))
    rp = {n: jnp.asarray(v[0]) for n, v in a.items() if n != "x"}
    ry, raux = RM.moe_layer(jnp.asarray(a["x"]), rp, rcfg,
                            dispatch="dense")
    got = runs["got"]
    np.testing.assert_allclose(got[child.key(tag, arch, "moe_layer", mode)],
                               np.asarray(ry), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[child.key(tag, arch, "moe_aux", mode)],
                               float(raux), rtol=1e-5, atol=1e-6)


def test_launcher_cli_resumes_on_a_2x2_mesh(tmp_path):
    """``python -m repro_torch.launch.train`` saves a checkpoint at world 1;
    under ``torchrun --nproc_per_node 4 ... --dp 2 --tp 2`` it resumes from
    that step on the mesh and trains on."""
    from repro_torch.launch import train as launch_train
    ck = ["--ckpt", str(tmp_path), "--ckpt-every", "2"]
    base = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16"]
    assert launch_train.main(base + ck + ["--steps", "2"]) == 0
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "repro_torch.launch.train",
         "--dp", "2", "--tp", "2", "--steps", "3"] + base + ck,
        capture_output=True, text=True, env=env, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert any(ln.startswith("arch=qwen3-4b-smoke") and
               ln.endswith("devices=4 mesh=2x2") for ln in lines), lines
    assert "resumed at step 2" in lines
    assert any(ln.startswith("step    2 loss=") for ln in lines), lines
    assert lines[-1] == "done"


@pytest.mark.parametrize("moments", ["int8", "bfloat16"])
def test_unit_mesh_step_bitwise_the_plain_step(moments, tmp_path):
    """On a (1, 1) mesh (a gloo group of one rank in this process) the
    sharded step with int8 or bfloat16 moments and two microbatches gives
    the plain step's bits: parameters and every moment (int8: ``q`` and
    the scales ``s``, replicated along the last axis)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import sharded_state
    from repro_torch.training.train_loop import TrainConfig
    from repro_torch.training.pytree import tree_leaves
    cfg = child.mesh_config()
    ocfg = OptConfig(moments_dtype=moments, warmup_steps=2, decay_steps=10)
    tcfg = TrainConfig(microbatches=2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        p, o, psh, _ = sharded_state(cfg, ocfg, mesh, torch.device("cpu"))
        step = make_train_step(cfg, ocfg, tcfg, donate=True,
                               param_shardings=psh)
        pp = T.init_params(cfg, device="cpu")
        po = init_opt_state(pp, ocfg)
        plain = make_train_step(cfg, ocfg, tcfg)
        for b in child.mesh_batches(cfg):
            p, o, m = step(p, o, b)
            pp, po, pm = plain(pp, po, b)
        assert float(m["loss"]) == float(pm["loss"])
        if moments == "int8":
            assert str(o["m"]["blocks"]["wq"]["s"].placements) == \
                "(Shard(dim=1), Replicate())"
        for a, b in zip(tree_leaves({"p": p, "m": o["m"], "v": o["v"]}),
                        tree_leaves({"p": pp, "m": po["m"], "v": po["v"]})):
            a = a.full_tensor()
            assert a.dtype == b.dtype and torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", child.FAMILIES)
def test_unit_mesh_family_step_bitwise_the_plain_step(arch, tmp_path):
    """Each other family on a (1, 1) mesh in bf16 with remat per block
    (the card's settings): two sharded steps give the plain steps' bits
    in the loss, every parameter and both moments (the MoE layer's
    expert range is every expert, its exchange the plain one)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import sharded_state
    from repro_torch.models.config import torch_dtype
    from repro_torch.training.pytree import tree_leaves
    from repro_torch.training.train_loop import batch_to
    cfg = child.family_config(arch).scaled(dtype="bfloat16", remat="block")
    ocfg = OptConfig(warmup_steps=2, decay_steps=10)
    dt = torch_dtype(cfg.dtype)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        p, o, psh, _ = sharded_state(cfg, ocfg, mesh, torch.device("cpu"))
        step = make_train_step(cfg, ocfg, donate=True, param_shardings=psh)
        pp = T.init_params(cfg, device="cpu")
        po = init_opt_state(pp, ocfg)
        plain = make_train_step(cfg, ocfg)
        for b in child.family_batches(cfg):
            b = batch_to(b, torch.device("cpu"), dt)
            p, o, m = step(p, o, b)
            pp, po, pm = plain(pp, po, b)
        assert float(m["loss"]) == float(pm["loss"])
        for a, b in zip(tree_leaves({"p": p, "m": o["m"], "v": o["v"]}),
                        tree_leaves({"p": pp, "m": po["m"], "v": po["v"]})):
            a = a.full_tensor()
            assert a.dtype == b.dtype and torch.equal(a, b)
    finally:
        dist.destroy_process_group()
