"""Port parity, DDP slice: ``repro_torch.training.ddp`` and the DDP train
step against the reference's ``tests/test_ddp.py`` and
``tests/test_fault_elastic.py``, counterpart by counterpart, on the CPU.

- the allreduce SF: its edges equal the reference's at every world;
- the bucket planner: the reference's edge cases, and the same buckets as
  the reference's plan of the same tree;
- the reducer: numerics against numpy and bitwise against the reference
  (float32, every budget), bucketed = per-tensor bitwise, split-phase =
  one-shot, world-invariance bitwise, the ``"cuda"`` backend (the kernels'
  plain versions here) bitwise the ``"global"`` one, the plan cache's
  misses then hits;
- AdamW bucketed bit-identical to the whole-tree update per moment kind;
- ``tests/test_sf_property.py``'s two DDP properties under hypothesis:
  bucketed = per-tensor bitwise (and = the reference's reducer) for random
  trees, dtype mixes and budgets, and the planner's invariants (= the
  reference's plan);
- the DDP train step: world-invariance bitwise, grains = 1 against the
  plain step within the reference's 1e-6, against the reference's DDP
  step within 1e-6;
- the elastic 2 -> 4 -> 1 resume bit-exact to the port's uninterrupted
  run and within 1e-6 of the reference's trajectory, the plan cache's
  miss-then-hit across restarts, comm metrics, exhausted restarts.

The card twins are in ``tests/test_torch_on_card.py`` and
``chip_smoke.py``'s ``train`` phase.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.dynplan import PlanCache as RPlanCache  # noqa: E402
from repro.training import ddp as RDDP  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro.training import train_loop as RL  # noqa: E402

from repro_torch.core import FieldBundle, SFComm  # noqa: E402
from repro_torch.core.dynplan import PlanCache  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.ddp import (BucketPlan, DDPGradReducer,  # noqa
                                      allreduce_sf, ddp_plan_cache,
                                      reset_ddp_plan_cache)
from repro_torch.training.fault import (SimulatedFailure,  # noqa: E402
                                        run_with_restarts)
from repro_torch.training.optimizer import (OptConfig,  # noqa: E402
                                            adamw_update,
                                            adamw_update_bucketed,
                                            init_opt_state)
from repro_torch.training.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    make_ddp_train_step, value_and_grad)

CPU = "cpu"


def small_tree(rng=None, dtype=np.float32):
    rng = rng or np.random.default_rng(0)
    return {
        "emb": rng.standard_normal((6, 4)).astype(dtype),
        "blocks": [
            {"w": rng.standard_normal((4, 4)).astype(dtype),
             "b": rng.standard_normal((4,)).astype(dtype)},
            {"w": rng.standard_normal((4, 4)).astype(dtype),
             "b": rng.standard_normal((4,)).astype(dtype)},
        ],
        "head": rng.standard_normal((4, 6)).astype(dtype),
    }


def grain_grads_for(tree, grains, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal((grains,) + np.shape(x)) * 2
                   ).astype(np.asarray(x).dtype), tree)


def tt(tree):
    """numpy tree -> the same tree of CPU tensors."""
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)),
                                  tree)


def reducer(tree, budget, world, grains, **kw):
    return DDPGradReducer(BucketPlan.for_tree(tree, budget), world,
                          grains=grains, cache=PlanCache("t"), device=CPU,
                          **kw)


def _bits(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return np.asarray(x)


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(_bits(x), _bits(y))


# --------------------------------------------------------------------------
# the allreduce SF
# --------------------------------------------------------------------------
@pytest.mark.parametrize("world,grains", [(1, 1), (1, 8), (2, 8), (4, 8),
                                          (8, 8), (3, 6)])
def test_allreduce_sf_matches_reference(world, grains):
    sf, ref = allreduce_sf(world, grains), RDDP.allreduce_sf(world, grains)
    assert (sf.nranks, sf.nroots_total, sf.nleafspace_total) == \
        (ref.nranks, ref.nroots_total, ref.nleafspace_total)
    np.testing.assert_array_equal(sf.edges_global(), ref.edges_global())
    np.testing.assert_array_equal(sf.edges_global(),
                                  allreduce_sf(1, grains).edges_global())


def test_allreduce_sf_validation():
    with pytest.raises(ValueError):
        allreduce_sf(3, grains=4)
    with pytest.raises(ValueError):
        allreduce_sf(0)


# --------------------------------------------------------------------------
# bucket planner
# --------------------------------------------------------------------------
@pytest.mark.parametrize("budget", [None, 0, 1, 48, 64, 200, 4096])
def test_plan_matches_reference(budget):
    tree = small_tree()
    got, want = BucketPlan.for_tree(tt(tree), budget), \
        RDDP.BucketPlan.for_tree(tree, budget)
    assert got.nleaves == want.nleaves and got.byte_budget == \
        want.byte_budget
    assert [(b.index, b.leaves, b.shapes, b.nbytes) for b in got.buckets] \
        == [(b.index, b.leaves, b.shapes, b.nbytes) for b in want.buckets]
    assert got.total_bytes == want.total_bytes


def test_plan_edges():
    tree = [np.zeros(100, np.float32), np.zeros(4, np.float32),
            np.zeros(4, np.float32)]
    plan = BucketPlan.for_tree(tree, 64)
    assert [b.leaves for b in plan.buckets] == [(2, 1), (0,)]
    assert plan.buckets[1].nbytes == 400
    ragged = BucketPlan.for_tree([np.zeros(8, np.float32)] * 5, 64)
    assert [b.leaves for b in ragged.buckets] == [(4, 3), (2, 1), (0,)]
    assert BucketPlan.for_tree([np.float32(1.0), np.zeros((), np.float32)],
                               None).buckets[0].nbytes == 8
    with pytest.raises(ValueError):
        BucketPlan.for_tree([], 64)
    a = BucketPlan.for_tree([torch.zeros(4)], None)
    b = BucketPlan.for_tree([torch.zeros(4, dtype=torch.int32)], None)
    c = BucketPlan.for_tree([torch.zeros(5, dtype=torch.bfloat16)], None)
    assert len({a.signature(), b.signature(), c.signature()}) == 3
    meta = BucketPlan.for_tree({"w": torch.empty(4, 4, device="meta")}, None)
    assert meta.total_bytes == 64


# --------------------------------------------------------------------------
# reducer numerics
# --------------------------------------------------------------------------
@pytest.mark.parametrize("budget", [None, 1, 48, 4096])
def test_allreduce_matches_numpy_and_reference(budget):
    tree = small_tree()
    gg = grain_grads_for(tree, 4)
    out = reducer(tt(tree), budget, 2, 4).allreduce(tt(gg), average=True)
    want = jax.tree_util.tree_map(lambda g: np.mean(np.asarray(g), axis=0,
                                                    dtype=np.float32), gg)
    ref = RDDP.DDPGradReducer(RDDP.BucketPlan.for_tree(tree, budget), 2,
                              grains=4, cache=RPlanCache("t")).allreduce(gg)
    for a, b, r in zip(tree_leaves(out), jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_allreduce_sum_vs_average_and_ints():
    red = reducer({"w": torch.ones(3, 3)}, None, 1, 4)
    gg = {"w": torch.ones(4, 3, 3)}
    assert torch.equal(red.allreduce(gg, average=False)["w"],
                       torch.full((3, 3), 4.0))
    assert torch.equal(red.allreduce(gg, average=True)["w"],
                       torch.ones(3, 3))
    ired = reducer({"n": torch.zeros(5, dtype=torch.int32)}, None, 2, 4)
    got = ired.allreduce({"n": torch.arange(20, dtype=torch.int32)
                          .reshape(4, 5)})["n"]
    assert got.dtype == torch.int32
    assert got.tolist() == [7, 8, 9, 10, 11]     # column sums // 4


@pytest.mark.parametrize("budget", [None, 1, 48, 200])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_bucketed_bitmatches_per_tensor(budget, dtype):
    tree = small_tree(dtype=dtype)
    red = reducer(tt(tree), budget, 2, 4)
    gg = tt(grain_grads_for(tree, 4))
    assert_trees_equal(red.allreduce(gg), red.reduce_per_tensor(gg))


def test_bf16_buckets_bitmatch_per_tensor():
    tree = tree_map(lambda a: a.bfloat16(), tt(small_tree()))
    red = reducer(tree, 48, 2, 4)
    gg = tree_map(lambda a: a.bfloat16(), tt(grain_grads_for(small_tree(),
                                                             4)))
    for a, b in zip(tree_leaves(red.allreduce(gg)),
                    tree_leaves(red.reduce_per_tensor(gg))):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_split_phase_equals_one_shot():
    tree = small_tree()
    red = reducer(tt(tree), 48, 2, 4)
    gg = tt(grain_grads_for(tree, 4))
    pendings = red.bucket_reduce_begin(gg)
    assert len(pendings) == red.plan.nbuckets
    assert_trees_equal(red.bucket_reduce_end(pendings, gg, average=True),
                       red.allreduce(gg, average=True))


@pytest.mark.parametrize("backend", ["cuda", "global"])
def test_reduce_world_invariant_bitwise(backend):
    """grains fixed -> reduced grads are BIT-identical across any world
    dividing grains, on both backends (the elastic-resume guarantee)."""
    tree = small_tree()
    gg = tt(grain_grads_for(tree, 4))
    outs = [reducer(tt(tree), 64, w, 4, backend=b).allreduce(gg)
            for w in (1, 2, 4) for b in (backend, "global")]
    for o in outs[1:]:
        assert_trees_equal(outs[0], o)


def test_bcast_grads_roundtrip():
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    out = reducer(tree, None, 2, 4).bcast_grads(tree)
    assert out["w"].shape == (4, 2, 3)
    for g in range(4):
        assert torch.equal(out["w"][g], tree["w"])


def test_reducer_rejects_bad_grain_shapes():
    red = reducer({"w": torch.zeros(2, 3)}, None, 1, 4)
    with pytest.raises(ValueError):
        red.bucket_reduce_begin({"w": torch.zeros(2, 2, 3)})
    with pytest.raises(ValueError):
        red.bucket_reduce_begin({"w": torch.zeros(4, 9),
                                 "extra": torch.zeros(4, 1)})


def test_sfcomm_reduce_multi_begin_end_parity():
    comm = SFComm(allreduce_sf(2, grains=4), backend="cuda", device=CPU)
    rng = np.random.default_rng(0)
    leaves = [torch.as_tensor(rng.standard_normal((4, n)).astype(np.float32))
              for n in (3, 5)]
    roots = [torch.zeros(1, 3), torch.zeros(1, 5)]
    got = comm.reduce_multi_end(comm.reduce_multi_begin(leaves, "sum"), roots)
    want = FieldBundle.for_data(comm, leaves).reduce_multi(leaves, roots,
                                                           "sum")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# tests/test_sf_property.py's DDP properties
# --------------------------------------------------------------------------
_GRAD_DTYPES = [np.float32, np.float16, np.int32]


@st.composite
def grad_trees(draw, max_tensors=6, max_dim=5):
    """Random gradient trees: 1..max_tensors arrays of rank 0-3 and a
    random dtype, flat or nested."""
    leaves = []
    for _ in range(draw(st.integers(1, max_tensors))):
        shape = tuple(draw(st.integers(1, max_dim))
                      for _ in range(draw(st.integers(0, 3))))
        dt = np.dtype(draw(st.sampled_from(_GRAD_DTYPES)))
        rng = np.random.default_rng(draw(st.integers(0, 2 ** 31 - 1)))
        leaves.append((rng.standard_normal(shape) * 3).astype(dt)
                      if dt.kind == "f"
                      else rng.integers(-50, 50, shape).astype(dt))
    if draw(st.booleans()):
        return {"layers": leaves[: len(leaves) // 2 + 1],
                "head": leaves[len(leaves) // 2 + 1:]}
    return leaves


@settings(max_examples=15, deadline=None)
@given(grad_trees(), st.one_of(st.none(), st.integers(1, 4096)),
       st.sampled_from([(1, 2), (2, 2), (2, 4), (4, 4)]), st.booleans())
def test_ddp_bucketed_reduce_bitmatches_per_tensor_property(tree, budget, wg,
                                                            average):
    world, grains = wg
    red = reducer(tt(tree), budget, world, grains)
    rng = np.random.default_rng(0)
    gg = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal((grains,) + np.shape(x)) * 3
                   ).astype(np.asarray(x).dtype), tree)
    fused = red.allreduce(tt(gg), average=average)
    assert_trees_equal(fused, red.reduce_per_tensor(tt(gg), average=average))
    ref = RDDP.DDPGradReducer(RDDP.BucketPlan.for_tree(tree, budget), world,
                              grains=grains, cache=RPlanCache("t"))
    want = ref.allreduce(gg, average=average)
    for a, w in zip(tree_leaves(fused), jax.tree_util.tree_leaves(want)):
        assert a.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@settings(max_examples=15, deadline=None)
@given(grad_trees(), st.integers(1, 512))
def test_ddp_bucket_plan_invariants_property(tree, budget):
    plan = BucketPlan.for_tree(tree, budget)
    want = RDDP.BucketPlan.for_tree(tree, budget)
    assert [(b.leaves, b.nbytes) for b in plan.buckets] == \
        [(b.leaves, b.nbytes) for b in want.buckets]
    nb = [a.size * a.dtype.itemsize for a in
          (np.asarray(x) for x in jax.tree_util.tree_leaves(tree))]
    seen = []
    for b in plan.buckets:
        assert b.nbytes == sum(nb[i] for i in b.leaves)
        if len(b.leaves) > 1:
            assert b.nbytes <= budget or b.nbytes - nb[b.leaves[-1]] < budget
        seen.extend(b.leaves)
    assert seen == list(reversed(range(len(nb))))


# --------------------------------------------------------------------------
# bucketed optimizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_bucketed_bit_identical(moments):
    params = tt(small_tree())
    grads = tt(small_tree(np.random.default_rng(7)))
    cfg = OptConfig(lr=1e-2, moments_dtype=moments)
    for budget in (None, 1, 48):
        plan = BucketPlan.for_tree(params, budget)
        p1, s1, m1 = adamw_update(params, grads,
                                  init_opt_state(params, cfg), cfg)
        p2, s2, m2 = adamw_update_bucketed(
            params, grads, init_opt_state(params, cfg), cfg, plan)
        assert_trees_equal((p1, s1), (p2, s2))
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])


def test_adamw_bucketed_rejects_partial_plan():
    params = {"a": torch.zeros(4), "b": torch.zeros(4)}
    cfg = OptConfig()
    plan = BucketPlan.for_tree({"a": torch.zeros(4)}, None)
    with pytest.raises(ValueError):
        adamw_update_bucketed(params, params, init_opt_state(params, cfg),
                              cfg, plan)


# --------------------------------------------------------------------------
# plan cache lifecycle
# --------------------------------------------------------------------------
def test_plan_cache_miss_then_hit():
    cache = PlanCache("t")
    tree = tt(small_tree())
    plan = BucketPlan.for_tree(tree, 64)
    build = lambda w: DDPGradReducer(plan, world=w, grains=4, cache=cache,
                                     device=CPU)
    build(2)
    uniq = len(set(b.signature() for b in plan.buckets))
    s0 = cache.stats()
    assert s0["misses"] == 1 + uniq
    assert s0["hits"] == plan.nbuckets - uniq
    build(2)
    s1 = cache.stats()
    assert s1["misses"] == s0["misses"]
    assert s1["hits"] == s0["hits"] + 1 + plan.nbuckets
    build(4)
    s2 = cache.stats()
    assert s2["misses"] == 2 * (1 + uniq)
    build(2)
    assert cache.stats()["misses"] == s2["misses"]


def test_module_plan_cache_reset():
    reset_ddp_plan_cache()
    red = DDPGradReducer(BucketPlan.for_tree({"w": torch.zeros(4)}, None),
                         world=1, grains=1, device=CPU)
    m = red.metrics()
    assert m["ddp_plan_cache_misses"] >= 2
    assert m["ddp_world"] == 1 and m["ddp_nbuckets"] == 1
    assert ddp_plan_cache().stats()["entries"] >= 2
    reset_ddp_plan_cache()
    assert ddp_plan_cache().stats()["entries"] == 0


# --------------------------------------------------------------------------
# the DDP train step
# --------------------------------------------------------------------------
def quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean(torch.square(pred - batch["y"]))
    return loss, {"mse": loss}


def r_quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean(jnp.square(pred - batch["y"]))
    return loss, {"mse": loss}


def quad_problem(batch=8, din=6, dout=3, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((din, dout)) * 0.1).astype(
        np.float32), "b": np.zeros((dout,), np.float32)}
    wt = rng.standard_normal((din, dout)).astype(np.float32)
    x = rng.standard_normal((batch, din)).astype(np.float32)
    y = x @ wt + 0.01 * rng.standard_normal((batch, dout)).astype(np.float32)
    return params, {"x": x, "y": y}


def test_ddp_train_step_loss_decreases():
    params, batch = quad_problem()
    ocfg = OptConfig(lr=5e-2, warmup_steps=1, decay_steps=1000,
                     weight_decay=0.0)
    step, red = make_ddp_train_step(None, ocfg, world=2, byte_budget=64,
                                    grains=4, loss_fn=quad_loss, device=CPU)
    p = tt(params)
    opt = init_opt_state(p, ocfg)
    losses = []
    for _ in range(40):
        p, opt, m = step(p, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.2 * losses[0]
    assert red() is not None and red().plan.nbuckets >= 1


def test_ddp_train_step_matches_plain_gradient():
    """One DDP step (grain-averaged grads) == one whole-batch AdamW step."""
    params, batch = quad_problem()
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, decay_steps=100,
                     weight_decay=0.0, grad_clip=0.0)
    p = tt(params)
    step, _ = make_ddp_train_step(None, ocfg, world=1, byte_budget=None,
                                  grains=1, loss_fn=quad_loss,
                                  params_template=p)
    p1, _, _ = step(p, init_opt_state(p, ocfg), batch)
    _, grads = value_and_grad(quad_loss, p, tt(batch))
    p2, _, _ = adamw_update(p, grads, init_opt_state(p, ocfg), ocfg)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_ddp_train_step_world_invariant_and_matches_reference():
    """Same grains, different world -> bit-identical params after a step;
    and the reference's DDP step within 1e-6."""
    params, batch = quad_problem()
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, decay_steps=100)
    rocfg = RO.OptConfig(lr=1e-2, warmup_steps=1, decay_steps=100)
    p = tt(params)
    outs = []
    for world in (1, 2, 4):
        step, _ = make_ddp_train_step(None, ocfg, world=world,
                                      byte_budget=48, grains=4,
                                      loss_fn=quad_loss, params_template=p)
        outs.append(step(p, init_opt_state(p, ocfg), batch)[0])
    for o in outs[1:]:
        assert_trees_equal(outs[0], o)
    rstep, _ = RL.make_ddp_train_step(None, rocfg, world=2, byte_budget=48,
                                      grains=4, loss_fn=r_quad_loss,
                                      params_template=params)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    want, _, _ = rstep(rp, RO.init_opt_state(rp, rocfg),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    for a, b in zip(tree_leaves(outs[0]), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_ddp_train_step_rejects_indivisible_batch():
    params, batch = quad_problem(batch=6)
    ocfg = OptConfig()
    p = tt(params)
    step, _ = make_ddp_train_step(None, ocfg, world=2, byte_budget=None,
                                  grains=4, loss_fn=quad_loss,
                                  params_template=p)
    with pytest.raises(ValueError):
        step(p, init_opt_state(p, ocfg), batch)


def test_ddp_train_step_metrics():
    params, batch = quad_problem()
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, decay_steps=100)
    p = tt(params)
    step, red = make_ddp_train_step(None, ocfg, world=2, byte_budget=64,
                                    grains=4, loss_fn=quad_loss,
                                    params_template=p)
    _, _, m = step(p, init_opt_state(p, ocfg), batch)
    assert set(m) >= {"loss", "mse", "grad_norm", "lr"}
    assert set(red().metrics()) >= {
        "ddp_world", "ddp_grains", "ddp_nbuckets", "ddp_bucket_bytes",
        "ddp_plan_cache_hits", "ddp_plan_cache_misses"}


# --------------------------------------------------------------------------
# elastic restarts (tests/test_fault_elastic.py)
# --------------------------------------------------------------------------
GRAINS, DIN, DOUT, BATCH = 4, 6, 3, 8


def init_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((DIN, DOUT)) * 0.1).astype(np.float32),
            "b": np.zeros((DOUT,), np.float32)}


def batch_at(step):
    rng = np.random.default_rng(1000 + step)
    wt = np.random.default_rng(99).standard_normal((DIN, DOUT))
    x = rng.standard_normal((BATCH, DIN)).astype(np.float32)
    return {"x": x, "y": (x @ wt).astype(np.float32)}


def _ocfg():
    return dict(lr=3e-2, warmup_steps=1, decay_steps=500, weight_decay=0.0)


def build_step(world):
    ocfg = OptConfig(**_ocfg())
    step, red = make_ddp_train_step(
        None, ocfg, world=world, byte_budget=48, grains=GRAINS,
        loss_fn=quad_loss, params_template=tt(init_params()))
    return ocfg, step, red


def golden_run(total_steps):
    ocfg, step, _ = build_step(world=2)
    params = tt(init_params())
    opt = init_opt_state(params, ocfg)
    losses = []
    for s in range(total_steps):
        params, opt, m = step(params, opt, batch_at(s))
        losses.append(np.float32(m["loss"]))
    return losses, params


def elastic_run(total_steps, fail_steps, elastic_worlds, ckpt_dir,
                max_restarts=None, persistent=False):
    ocfg, step0, red0 = build_step(world=2)
    params = tt(init_params())
    holder = {"step_fn": step0, "reducer": red0, "worlds": [2]}
    pending = set(fail_steps)
    losses = {}

    def step_fn(s, state):
        if s in pending:
            if not persistent:
                pending.discard(s)
            raise SimulatedFailure(f"node died at step {s}")
        p, o, m = holder["step_fn"](state["tree"]["params"],
                                    state["tree"]["opt"], batch_at(s))
        state["tree"] = {"params": p, "opt": o}
        losses[s] = np.float32(m["loss"])
        return state

    def on_restore(state):
        w = int(state["world"])
        holder["worlds"].append(w)
        _, holder["step_fn"], holder["reducer"] = build_step(world=w)
        return state

    state = {"tree": {"params": params, "opt": init_opt_state(params, ocfg)},
             "step": 0, "world": 2}
    out = run_with_restarts(
        step_fn, state, CheckpointManager(ckpt_dir, every=1),
        total_steps=total_steps,
        max_restarts=(len(fail_steps) + 1 if max_restarts is None
                      else max_restarts), on_restore=on_restore,
        elastic_worlds=elastic_worlds,
        comm_metrics=lambda: holder["reducer"]().metrics())
    return [losses[s] for s in range(total_steps)], out, holder


def reference_trajectory(total_steps):
    """The reference's uninterrupted DDP run on the same data."""
    ocfg = RO.OptConfig(**_ocfg())
    p0 = {k: jnp.asarray(v) for k, v in init_params().items()}
    step, _ = RL.make_ddp_train_step(None, ocfg, world=2, byte_budget=48,
                                     grains=GRAINS, loss_fn=r_quad_loss,
                                     params_template=p0)
    params, opt, losses = p0, RO.init_opt_state(p0, ocfg), []
    for s in range(total_steps):
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v
                                            in batch_at(s).items()})
        losses.append(np.float32(m["loss"]))
    return losses, params


def test_elastic_resume_bit_exact_trajectory(tmp_path):
    """Failures at seeded-random steps + shrink/grow 2 -> 4 -> 1: the
    trajectory and final params bit-equal to the uninterrupted run, and
    within 1e-6 of the reference's."""
    reset_ddp_plan_cache()
    total = 12
    fail_steps = sorted(np.random.default_rng(7).choice(
        np.arange(2, total), size=2, replace=False).tolist())
    gold_losses, gold_params = golden_run(total)
    traj, out, holder = elastic_run(total, fail_steps, elastic_worlds=[4, 1],
                                    ckpt_dir=str(tmp_path))
    assert out["step"] == total
    assert holder["worlds"] == [2, 4, 1]
    np.testing.assert_array_equal(np.asarray(traj), np.asarray(gold_losses))
    assert_trees_equal(gold_params, out["tree"]["params"])
    ref_losses, ref_params = reference_trajectory(total)
    np.testing.assert_allclose(np.asarray(traj), np.asarray(ref_losses),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(out["tree"]["params"]),
                    jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_elastic_plan_cache_miss_then_hit(tmp_path):
    reset_ddp_plan_cache()
    _, out, holder = elastic_run(10, fail_steps=[3, 6],
                                 elastic_worlds=[4, 2],
                                 ckpt_dir=str(tmp_path))
    assert holder["worlds"] == [2, 4, 2]
    cm = out["comm_metrics"]
    assert cm["ddp_world"] == 2 and cm["ddp_grains"] == GRAINS
    stats = ddp_plan_cache().stats()
    assert stats["misses"] > 0 and stats["hits"] > 0
    build_step(world=4)
    build_step(world=2)
    after = ddp_plan_cache().stats()
    assert after["misses"] == stats["misses"]
    assert after["hits"] > stats["hits"]
    assert cm["ddp_plan_cache_misses"] > 0


def test_comm_metrics_snapshot_every_step(tmp_path):
    reset_ddp_plan_cache()
    _, out, _ = elastic_run(4, fail_steps=[], elastic_worlds=None,
                            ckpt_dir=str(tmp_path))
    cm = out["comm_metrics"]
    assert set(cm) >= {"ddp_world", "ddp_nbuckets", "ddp_plan_cache_hits",
                       "ddp_plan_cache_misses"}
    assert cm["ddp_nbuckets"] >= 1


def test_exhausted_restarts_reraises(tmp_path):
    reset_ddp_plan_cache()
    with pytest.raises(SimulatedFailure):
        elastic_run(8, fail_steps=[2], elastic_worlds=[4],
                    ckpt_dir=str(tmp_path), max_restarts=2, persistent=True)
