"""Port parity, runtime-routed SFs: ``repro_torch.core.DynPlan`` against
``repro.core.DynPlan`` on the value contracts of ``tests/test_dynplan.py``
(oracle reduce and bcast, drop semantics, unique = general, ``leaf_rep`` =
repeat, plan-cache counters, edge validation, ``FieldBundle`` over a bound
plan), each case on the same numpy inputs through both packages at the
reference test's tolerance, and the port's general reduce bitwise against
its own ``SFComm`` oracle on the routing's star forest.

On the CPU the gathers run their plain versions; the card twins are in
``tests/test_torch_on_card.py`` and ``chip_smoke.py``'s ``moe`` phase.
The training half of the reference's contracts: gradients through the
bcast and the general reduce against the reference's ``custom_vjp``
(``tests/test_dynplan.py::test_grad_through_bcast_and_reduce``), the
unique and ``leaf_rep`` reduces against torch's own index gradients, and
the transpose's bits the same from run to run.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import DynPlan as RDynPlan  # noqa: E402
from repro.core import PlanCache as RPlanCache  # noqa: E402
from repro.core import star_forest_from_assignment as r_sf_assign  # noqa
from repro.core.backend import SFComm as RSFComm  # noqa: E402
from repro.core.fields import FieldBundle as RFieldBundle  # noqa: E402

from repro_torch.core import (DynPlan, FieldBundle, PlanCache, SFComm,  # noqa
                              sflog, star_forest_from_assignment)
from repro_torch.kernels import ops as kops  # noqa: E402

from torch_parity import n, t  # noqa: E402

NROOTS, NLEAVES = 7, 12
# the reference fixture: duplicates (roots 0 and 3 have two writers),
# unrouted roots (5, 6) and two dropped leaves (== NROOTS)
LR = np.array([0, 3, 1, 4, 0, 2, 3, NROOTS, 1, 2, NROOTS, 4])
# a one-writer-per-root assignment
LR_UNIQUE = np.array([4, 0, NROOTS, 2, 6, NROOTS, 1, 5, NROOTS, 3, NROOTS,
                      NROOTS])
OPS = ["sum", "prod", "max", "min"]


@pytest.fixture(scope="module")
def routing():
    rng = np.random.default_rng(7)
    data = rng.standard_normal((NLEAVES, 3)).astype(np.float32)
    root0 = rng.standard_normal((NROOTS, 3)).astype(np.float32)
    return LR, data, root0


def _port_oracle(lr, nroots=NROOTS):
    return SFComm(star_forest_from_assignment(lr, nroots), backend="cuda",
                  device="cpu")


def _random_routing(seed, nroots, nleaves, unit=(), dtype=np.float32):
    """A random routing with duplicate writers, unrouted roots and ~10%
    drops, and payloads of ``unit``."""
    rng = np.random.default_rng(seed)
    lr = rng.integers(0, nroots, nleaves)
    lr[rng.random(nleaves) < 0.1] = nroots
    data = rng.standard_normal((nleaves,) + unit).astype(dtype)
    root0 = rng.standard_normal((nroots,) + unit).astype(dtype)
    return lr, data, root0


# ---------------------------------------------- tests/test_dynplan.py:30-41
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_reduce_matches_sfcomm_oracle(routing, op):
    lr, data, root0 = routing
    want = RSFComm(r_sf_assign(lr, NROOTS), backend="global").reduce(
        jnp.asarray(data), jnp.asarray(root0), op=op)
    ref = RDynPlan(NROOTS, NLEAVES).reduce(jnp.asarray(data), jnp.asarray(lr),
                                          jnp.asarray(root0), op=op)
    got = DynPlan(NROOTS, NLEAVES).reduce(t(data), t(lr), t(root0), op=op)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("unit,dtype", [((), np.float32), ((3,), np.float32),
                                        ((2,), np.float64), ((), np.int32),
                                        ((4,), np.int64)])
def test_general_reduce_is_the_port_sfcomm_fold(op, unit, dtype, seed):
    """The general reduce sorts the edges by root in leaf order and folds
    through the segment-reduce kernels: bitwise the port's SFComm reduce
    of the routing's SF (its one-leaf-per-root shortcut included, seed 2
    has at most one leaf per root)."""
    nroots, nleaves = (40, 30) if seed == 2 else (11, 60)
    lr, data, root0 = _random_routing(seed, nroots, nleaves, unit, dtype)
    if seed == 2:
        lr = np.random.default_rng(9).permutation(nroots + 10)[:nleaves]
        lr = np.minimum(lr, nroots)
        assert np.bincount(lr[lr < nroots]).max() == 1
    if op == "prod" and dtype in (np.int32, np.int64):
        data, root0 = data % 3 - 1, root0 % 3 - 1
    got = DynPlan(nroots, nleaves).reduce(t(data), t(lr), t(root0), op=op)
    want = _port_oracle(lr, nroots).reduce(t(data), t(root0), op=op)
    assert got.dtype == want.dtype and torch.equal(got, want)
    ref = RDynPlan(nroots, nleaves).reduce(
        jnp.asarray(data), jnp.asarray(lr), jnp.asarray(root0), op=op)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------- tests/test_dynplan.py:44-51
def test_bcast_matches_sfcomm_oracle(routing):
    lr, data, root0 = routing
    got = DynPlan(NROOTS, NLEAVES).bcast(t(root0), t(lr), t(data))
    want = RSFComm(r_sf_assign(lr, NROOTS), backend="global").bcast(
        jnp.asarray(root0), jnp.asarray(data))
    ref = RDynPlan(NROOTS, NLEAVES).bcast(jnp.asarray(root0), jnp.asarray(lr),
                                         jnp.asarray(data))
    np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(n(got), n(ref))
    assert torch.equal(got, _port_oracle(lr).bcast(t(root0), t(data)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16])
def test_fresh_bcast_matches_reference(dtype):
    lr, _, root0 = _random_routing(3, 9, 50, (5,), dtype)
    got = DynPlan(9, 50).bcast(t(root0), t(lr))
    ref = RDynPlan(9, 50).bcast(jnp.asarray(root0), jnp.asarray(lr))
    np.testing.assert_array_equal(n(got), n(ref))


# ---------------------------------------------- tests/test_dynplan.py:54-66
def test_drop_semantics(routing):
    """Dropped leaves never touch a root; a fresh-buffer bcast reads
    zeros there."""
    lr, data, _ = routing
    plan = DynPlan(NROOTS, NLEAVES)
    base = plan.reduce(t(data), t(lr), op="sum")
    poisoned = data.copy()
    poisoned[lr == NROOTS] = 1e6
    assert torch.equal(base, plan.reduce(t(poisoned), t(lr), op="sum"))
    out = plan.bcast(torch.zeros(NROOTS, 3) + 5.0, t(lr))
    assert (out[torch.as_tensor(lr == NROOTS)] == 0).all()
    assert int(plan.valid(t(lr)).sum()) == NLEAVES - 2
    np.testing.assert_array_equal(
        n(plan.valid(t(lr))), np.asarray(RDynPlan(NROOTS, NLEAVES).valid(
            jnp.asarray(lr))))
    ref = RDynPlan(NROOTS, NLEAVES).reduce(jnp.asarray(poisoned),
                                           jnp.asarray(lr), op="sum")
    np.testing.assert_allclose(n(base), n(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------- tests/test_dynplan.py:69-83
@pytest.mark.parametrize("with_root", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_unique_lowering_matches_general(routing, op, with_root):
    """One writer per root: the writer inversion + gather equals the
    general reduce bit for bit, with and without rootdata, and the
    reference's unique lowering."""
    _, data, root0 = routing
    plan = DynPlan(NROOTS, NLEAVES)
    rd = t(root0) if with_root else None
    a = plan.reduce(t(data), t(LR_UNIQUE), rd, op=op)
    b = plan.reduce(t(data), t(LR_UNIQUE), rd, op=op, unique=True)
    assert torch.equal(a, b)
    ref = RDynPlan(NROOTS, NLEAVES).reduce(
        jnp.asarray(data), jnp.asarray(LR_UNIQUE),
        jnp.asarray(root0) if with_root else None, op=op, unique=True)
    np.testing.assert_array_equal(n(b), n(ref))


# ---------------------------------------------- tests/test_dynplan.py:86-118
@pytest.mark.parametrize("rep", [2, 3])
def test_leaf_rep_composed_matches_repeat(rep):
    """Gathering from compact token rows equals reducing the materialized
    k-way repeat (bitwise), and the reference's composed gather."""
    rng = np.random.default_rng(3)
    ntok = 12 // rep
    nleaves = ntok * rep
    lr = np.array([4, 0, NROOTS, 2, 6, NROOTS, 1, 5, NROOTS, 3, NROOTS,
                   NROOTS])
    plan = DynPlan(NROOTS, nleaves)
    tok = rng.standard_normal((ntok, 3)).astype(np.float32)
    full = np.repeat(tok, rep, axis=0)
    a = plan.reduce(t(full), t(lr), op="sum", unique=True)
    b = plan.reduce(t(tok), t(lr), op="sum", unique=True, leaf_rep=rep)
    assert torch.equal(a, b)
    ref = RDynPlan(NROOTS, nleaves).reduce(jnp.asarray(tok), jnp.asarray(lr),
                                           op="sum", unique=True,
                                           leaf_rep=rep)
    np.testing.assert_array_equal(n(b), n(ref))
    with pytest.raises(NotImplementedError):
        plan.reduce(t(tok), t(lr), op="sum", leaf_rep=rep)
    with pytest.raises(ValueError):
        plan.reduce(t(tok[:-1]), t(lr), op="sum", unique=True, leaf_rep=rep)


# --------------------------------------------- tests/test_dynplan.py:150-160
def test_plan_cache_counters():
    for cls in (PlanCache, RPlanCache):
        cache = cls("t")
        built = []
        for sig in [(1, 2), (3, 4), (1, 2), (1, 2)]:
            cache.get_or_build(sig, lambda s=sig: built.append(s) or s)
        assert built == [(1, 2), (3, 4)]
        assert (cache.hits, cache.misses, len(cache)) == (2, 2, 2)
        assert cache.stats()["hit_rate"] == 0.5
        assert (1, 2) in cache and (9, 9) not in cache
        cache.clear()
        assert (cache.hits, cache.misses, len(cache)) == (0, 0, 0)


# --------------------------------------------- tests/test_dynplan.py:163-171
def test_edge_validation():
    plan = DynPlan(NROOTS, NLEAVES)
    with pytest.raises(ValueError):
        plan.reduce(torch.zeros(NLEAVES, 3), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        plan.reduce(torch.zeros(NLEAVES, 3),
                    torch.zeros(NLEAVES, dtype=torch.int32), op="replace")
    with pytest.raises(ValueError):
        star_forest_from_assignment(np.array([0, NROOTS + 1]), NROOTS)
    with pytest.raises(TypeError):
        plan.bcast(torch.zeros(NROOTS, 3), torch.zeros(NLEAVES))


@pytest.mark.parametrize("bad", [NROOTS + 1, -1, 2 ** 40])
@pytest.mark.parametrize("call", ["bcast", "reduce", "unique", "leaf_rep"])
def test_out_of_range_leaf_root_raises(call, bad):
    """The CPU-only case of the device-side guard: an entry outside
    ``[0, nroots]`` raises before any row moves (on the card the gather
    kernels trap on it; chip_smoke.py runs that in a child process)."""
    lr = LR_UNIQUE.copy()
    lr[5] = bad
    plan = DynPlan(NROOTS, NLEAVES)
    data = torch.ones(NLEAVES, 3)
    with pytest.raises(ValueError, match="must lie in"):
        if call == "bcast":
            plan.bcast(torch.ones(NROOTS, 3), t(lr))
        elif call == "reduce":
            plan.reduce(data, t(lr))
        elif call == "unique":
            plan.reduce(data, t(lr), unique=True)
        else:
            plan.reduce(data[:6], t(lr), unique=True, leaf_rep=2)


@pytest.mark.parametrize("dynamic", [False, True])
def test_gather_raises_on_out_of_range_index(dynamic):
    """The gathers' plain versions raise on an index outside the source
    rows, on the runtime-index route as on the prepared one."""
    data = torch.arange(12.0).reshape(6, 2)
    for bad in (6, -1):
        idx = torch.tensor([0, 5, bad])
        with pytest.raises(IndexError, match="outside"):
            kops.pack_rows(data, idx, dynamic=dynamic)
    got = kops.pack_rows(data, torch.tensor([5, 0, 5]), dynamic=dynamic)
    assert torch.equal(got, data[[5, 0, 5]])


def test_dynamic_route_leaves_the_index_cache_alone():
    """A runtime index takes no entry of the prepared-index cache."""
    from repro_torch.kernels import _index
    data = torch.arange(12.0).reshape(6, 2)
    before = len(_index._CACHE)
    idx = torch.tensor([3, 1])
    kops.pack_rows(data, idx, dynamic=True)
    assert len(_index._CACHE) == before
    kops.pack_rows(data, idx)
    assert len(_index._CACHE) == before + 1


# --------------------------------------------- tests/test_dynplan.py:174-199
@pytest.mark.parametrize("unique", [False, True])
def test_fieldbundle_fuses_over_bound_plan(routing, unique):
    """FieldBundle over a bound DynPlan: the fused two-field reduce equals
    two separate reduces (bitwise) and the reference's fused reduce."""
    lr, data, _ = routing
    if unique:
        lr = LR_UNIQUE
    plan = DynPlan(NROOTS, NLEAVES)
    w = np.abs(data[:, :1]) + 0.5
    bound = plan.bind(t(lr), unique=unique)
    assert bound.sf.nroots_total == NROOTS and bound.name == "dyn"
    fb = FieldBundle.for_data(bound, [t(data), t(w)])
    assert fb.ngroups("sum") == 1
    got_x, got_w = fb.reduce_multi(
        [t(data), t(w)], [torch.zeros(NROOTS, 3), torch.zeros(NROOTS, 1)],
        op="sum")
    assert torch.equal(got_x, plan.reduce(t(data), t(lr),
                                          torch.zeros(NROOTS, 3),
                                          unique=unique))
    assert torch.equal(got_w, plan.reduce(t(w), t(lr),
                                          torch.zeros(NROOTS, 1),
                                          unique=unique))
    rplan = RDynPlan(NROOTS, NLEAVES)
    rfb = RFieldBundle.for_data(rplan.bind(jnp.asarray(lr), unique=unique),
                                [jnp.asarray(data), jnp.asarray(w)])
    rx, rw = rfb.reduce_multi([jnp.asarray(data), jnp.asarray(w)],
                              [jnp.zeros((NROOTS, 3)),
                               jnp.zeros((NROOTS, 1))], op="sum")
    np.testing.assert_allclose(n(got_x), n(rx), rtol=1e-6)
    np.testing.assert_allclose(n(got_w), n(rw), rtol=1e-6)
    # and the fused bcast: one exchange for both fields
    leaves = fb.bcast_multi([t(n(got_x)), t(n(got_w))],
                            [t(data), t(w)])
    assert torch.equal(leaves[0], plan.bcast(got_x, t(lr), t(data)))


# ------------------------------------------------------------- sflog view
def test_sf_view_and_events_match_reference(routing):
    """The DynPlan SFView and the SFDynReduce / SFDynBcast events (bytes =
    nleaves x row bytes) are the reference's."""
    from repro.core import sflog as rsflog
    lr, data, root0 = routing
    label = ("moe", 1, 2)
    plan, rplan = DynPlan(NROOTS, NLEAVES, label=label), \
        RDynPlan(NROOTS, NLEAVES, label=label)
    v, rv = sflog.sf_view(plan), rsflog.sf_view(rplan)
    assert {k: v[k] for k in ("type", "nroots", "nleaves", "label",
                              "tune_key")} == \
        {k: rv[k] for k in ("type", "nroots", "nleaves", "label",
                            "tune_key")}
    assert sflog.format_sf_view(plan).startswith(
        f"SFView: DynPlan {label!r}: {NROOTS} roots, {NLEAVES} leaves")
    old = sflog.set_mode("on"), rsflog.set_mode("on")
    try:
        for mod, p, args in ((sflog, plan, (t(data), t(lr), t(root0))),
                             (rsflog, rplan, (jnp.asarray(data),
                                              jnp.asarray(lr),
                                              jnp.asarray(root0)))):
            mod.reset()
            p.reduce(*args, op="max")
            p.bcast(args[2], args[1])
        d, rd = sflog.events_snapshot(), rsflog.events_snapshot()
    finally:
        sflog.set_mode(old[0])
        rsflog.set_mode(old[1])
        sflog.reset()
        rsflog.reset()
    for ev in ("SFDynReduce", "SFDynBcast"):
        assert d[ev] == rd[ev]
        assert d[ev]["bytes"] == NLEAVES * 3 * 4


# ------------------------------------------ tests/test_dynplan.py:116-140
def test_grad_through_bcast_and_reduce(routing):
    """The gather's gradient is the SF transpose (bcast grad = reduce,
    reduce grad = bcast): the port's against its own transpose and the
    reference's custom-VJP gradients."""
    import jax
    lr, data, root0 = routing
    plan, rplan = DynPlan(NROOTS, NLEAVES), RDynPlan(NROOTS, NLEAVES)
    lrj = jnp.asarray(lr)
    r = t(root0).requires_grad_()
    g, = torch.autograd.grad(torch.sum(plan.bcast(r, t(lr)) ** 2), r)
    want = plan.reduce(2.0 * plan.bcast(t(root0), t(lr)), t(lr), op="sum")
    np.testing.assert_allclose(n(g), n(want), rtol=1e-6, atol=1e-6)
    rg = jax.grad(lambda x: jnp.sum(rplan.bcast(x, lrj) ** 2))(
        jnp.asarray(root0))
    np.testing.assert_allclose(n(g), np.asarray(rg), rtol=1e-6, atol=1e-6)

    d = t(data).requires_grad_()
    g2, = torch.autograd.grad(
        torch.sum(plan.reduce(d, t(lr), op="sum", unique=False)), d)
    # d(sum of roots)/d(leaf) = 1 for connected leaves, 0 for dropped
    np.testing.assert_array_equal(
        n(g2), (lr < NROOTS)[:, None] * np.ones_like(data))
    rg2 = jax.grad(lambda x: jnp.sum(rplan.reduce(x, lrj, op="sum")))(
        jnp.asarray(data))
    np.testing.assert_array_equal(n(g2), np.asarray(rg2))


@pytest.mark.parametrize("with_root", [False, True])
def test_grad_of_general_reduce_with_rootdata(routing, with_root):
    """A weighted loss through the general sum reduce: the leaves get the
    cotangent of their root (0 when dropped), rootdata the cotangent
    itself, as torch's index_add gives them."""
    lr, data, root0 = routing
    w = torch.arange(NROOTS * 3, dtype=torch.float32).reshape(NROOTS, 3)
    d = t(data).requires_grad_()
    r = t(root0).requires_grad_() if with_root else None
    out = DynPlan(NROOTS, NLEAVES).reduce(d, t(lr), r, op="sum")
    got = torch.autograd.grad(torch.sum(out * w), [d] + ([r] if r is not None
                                                          else []))
    d2 = t(data).requires_grad_()
    r2 = t(root0).requires_grad_() if with_root else torch.zeros(NROOTS, 3)
    keep = torch.as_tensor(lr < NROOTS)
    ref = r2.index_add(0, t(lr)[keep], d2[keep])
    want = torch.autograd.grad(torch.sum(ref * w), [d2] + (
        [r2] if with_root else []))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("rep", [1, 2])
def test_grad_of_unique_reduce_is_the_gather_transpose(rep):
    """The one-writer reduce (and its ``leaf_rep`` composition) is a
    gather: its gradient sums each leaf row's readers, bitwise torch's
    own indexing gradient here (two readers at most, one order)."""
    lr = LR_UNIQUE
    rng = np.random.default_rng(3)
    data = rng.standard_normal((NLEAVES // rep, 4)).astype(np.float32)
    w = rng.standard_normal((NROOTS, 4)).astype(np.float32)
    d = t(data).requires_grad_()
    out = DynPlan(NROOTS, NLEAVES).reduce(d, t(lr), op="sum", unique=True,
                                          leaf_rep=rep)
    g, = torch.autograd.grad(torch.sum(out * t(w)), d)
    writer = np.full(NROOTS, -1)
    writer[lr[lr < NROOTS]] = np.flatnonzero(lr < NROOTS)
    want = np.zeros_like(data)
    for root, leaf in enumerate(writer):
        if leaf >= 0:
            want[leaf // rep] += w[root]
    np.testing.assert_allclose(n(g), want, rtol=1e-6, atol=1e-6)


def test_transpose_is_deterministic():
    """The gather's transpose folds each source row's readers in leaf
    order through the segment reduce: the same bits on every run, and the
    same as folding them in that order by hand."""
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 50, 4000)
    g = torch.as_tensor(rng.standard_normal((4000, 8)).astype(np.float32))
    src = torch.zeros(50, 8, requires_grad=True)
    plan = DynPlan(50, 4000)

    def grad():
        out = plan.bcast(src, t(idx))
        return torch.autograd.grad(out, src, g)[0]

    a, b = grad(), grad()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = torch.zeros(50, 8)
    for i in np.argsort(idx, kind="stable"):
        want[idx[i]] += g[i]
    assert torch.equal(a, want)
