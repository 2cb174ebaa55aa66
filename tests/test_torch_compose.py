"""Port parity, derived SFs: ``repro_torch.core.compose`` returns the
reference's graphs edge for edge (the port works on whole edge arrays where
the reference walks edges in Python), composed SFs communicate as their
two-hop chains on both port backends, the ``compose_inverse`` reduce lands
every multi-root value on its root, and the port's ``simulate`` oracle
equals the reference's.  Graph arrays and integer payloads: bitwise;
float32 sums: rtol 1e-5, atol 1e-5, the reference test's tolerance."""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from conftest import random_star_forest  # noqa: E402
from sf_fixtures import FIXTURES, bridge_sf  # noqa: E402
from torch_parity import CPU, n, port_sf, t  # noqa: E402

from repro.core import SFComm as RSFComm  # noqa: E402
RC = importlib.import_module("repro.core.compose")
from repro.core import simulate as RSim  # noqa: E402

from repro_torch.core import (SFComm, compose, compose_inverse,  # noqa: E402
                              embed_leaves, embed_roots, identity_sf,
                              make_multi_sf, simulate)

PORT_BACKENDS = ["global", "cuda"]
SEEDS = [0, 3, 7, 21]


def assert_same_graphs(got, want):
    """Every rank graph of the port's SF equals the reference's, array for
    array and dtype for dtype."""
    assert got.nranks == want.nranks
    for r in range(want.nranks):
        a, b = got.graph(r), want.graph(r)
        assert (a.nroots, a.nleafspace) == (b.nroots, b.nleafspace), r
        for f in ("local", "remote_rank", "remote_offset"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, (r, f)
            np.testing.assert_array_equal(x, y, err_msg=f"rank {r} {f}")


def _forests():
    out = [(name, FIXTURES[name]()) for name in sorted(FIXTURES)]
    out += [(f"random{s}", random_star_forest(seed=s)) for s in SEEDS]
    return out


FORESTS = dict(_forests())


def _bridge(A, seed):
    """``sf_fixtures.bridge_sf`` for forests that may have ranks without a
    leaf space: B's leaves pick roots on ranks that have one."""
    from repro.core import StarForest
    rng = np.random.default_rng(seed)
    ranks = [m for m in range(A.nranks) if A.graph(m).nleafspace]
    B = StarForest(A.nranks)
    for q in range(A.nranks):
        m = rng.choice(ranks, 4)
        remote = [(int(p), int(rng.integers(0, A.graph(int(p)).nleafspace)))
                  for p in m]
        B.set_graph(q, A.graph(q).nleafspace, None, np.asarray(remote),
                    nleafspace=4)
    return B.setup()


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_unary_derivations_match_reference(name):
    ref = FORESTS[name]
    sf = port_sf(ref)
    assert_same_graphs(make_multi_sf(sf), RC.make_multi_sf(ref))
    nls = [ref.graph(r).nleafspace for r in range(ref.nranks)]
    assert_same_graphs(identity_sf(nls), RC.identity_sf(nls))
    rng = np.random.default_rng(len(name))
    roots = [np.flatnonzero(rng.random(ref.graph(r).nroots) < 0.5)
             for r in range(ref.nranks)]
    leaves = [np.flatnonzero(rng.random(ref.graph(r).nleafspace) < 0.5)
              for r in range(ref.nranks)]
    assert_same_graphs(embed_roots(sf, roots), RC.embed_roots(ref, roots))
    assert_same_graphs(embed_leaves(sf, leaves), RC.embed_leaves(ref, leaves))
    every = [np.arange(0, g, 2) for g in nls]
    assert_same_graphs(embed_leaves(sf, every), RC.embed_leaves(ref, every))


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_compose_and_inverse_match_reference(name):
    ref = FORESTS[name]
    sf = port_sf(ref)
    for seed in (5, 50):
        B = _bridge(ref, seed)
        assert_same_graphs(compose(sf, port_sf(B)), RC.compose(ref, B))
    I = RC.identity_sf([ref.graph(r).nleafspace for r in range(ref.nranks)])
    assert_same_graphs(compose(sf, port_sf(I)), RC.compose(ref, I))
    multi = RC.make_multi_sf(ref)
    assert_same_graphs(compose_inverse(sf, port_sf(multi)),
                       RC.compose_inverse(ref, multi))
    # an inverse whose B leaves reach past A's leaf space and into A-holes
    emb = RC.embed_leaves(ref, [np.arange(0, ref.graph(r).nleafspace, 2)
                                for r in range(ref.nranks)])
    assert_same_graphs(compose_inverse(port_sf(emb), port_sf(multi)),
                       RC.compose_inverse(emb, multi))


def test_compose_errors_match_reference():
    A = random_star_forest(seed=1)
    with pytest.raises(ValueError, match="degree <= 1"):
        compose_inverse(port_sf(A), port_sf(A))
    B = bridge_sf(A, seed=2)
    g = B.graph(0)
    bad = port_sf(B)
    bad._graphs[0] = type(bad.graph(0))(
        g.nroots, g.nleafspace, g.local, g.remote_rank,
        g.remote_offset + 1000)
    with pytest.raises(ValueError, match="outside A leaf space"):
        compose(port_sf(A), bad)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("unit", [(), (3,), (2, 2)])
@pytest.mark.parametrize("seed", [3, 9])
def test_compose_bcast_one_hop_equals_two_hop(backend, unit, seed):
    """Bitwise: a replace bcast moves bits."""
    A = random_star_forest(seed=seed)
    B = bridge_sf(A, seed=seed + 50)
    pA, pB = port_sf(A), port_sf(B)
    AB = compose(pA, pB)
    rng = np.random.default_rng(seed)
    root = t(rng.standard_normal((A.nroots_total,) + unit).astype(np.float32))
    kw = {"unit": unit} if unit else {}
    cA, cB, cAB = (SFComm(s, backend=backend, device=CPU, **kw)
                   for s in (pA, pB, AB))
    zA = torch.zeros((A.nleafspace_total,) + unit)
    zB = torch.zeros((B.nleafspace_total,) + unit)
    two_hop = cB.bcast(cA.bcast(root, zA), zB)
    one_hop = cAB.bcast(root, zB)
    gl = torch.as_tensor(AB.edges_global()[:, 1])
    assert torch.equal(one_hop[gl], two_hop[gl])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_compose_inverse_reduce_routes_to_roots(backend):
    """Against the reference's ``global`` backend and the oracle: the
    reference's ``pallas`` case fails on this tree (ROADMAP Queue 3)."""
    A = random_star_forest(seed=21)
    ref_ab = RC.compose_inverse(A, RC.make_multi_sf(A))
    AB = compose_inverse(port_sf(A), make_multi_sf(port_sf(A)))
    rng = np.random.default_rng(21)
    leaf = rng.standard_normal(AB.nleafspace_total).astype(np.float32)
    got = n(SFComm(AB, backend=backend, device=CPU).reduce(
        t(leaf), torch.zeros(AB.nroots_total)))
    want = np.asarray(RSFComm(ref_ab, backend="global").reduce(
        jnp.asarray(leaf), jnp.zeros(ref_ab.nroots_total, jnp.float32)))
    oracle = simulate.reduce_ref(AB, leaf,
                                 np.zeros(AB.nroots_total, np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("seed", [17, 4])
def test_multi_sf_layout_matches_oracle(backend, seed):
    ref = random_star_forest(seed=seed)
    sf = port_sf(ref)
    multi = make_multi_sf(sf)
    assert multi.nroots_total == sf.nedges_total
    for r in range(multi.nranks):
        assert (multi.degrees(r) == 1).all()
    rng = np.random.default_rng(seed)
    leaf = rng.standard_normal((sf.nleafspace_total, 2)).astype(np.float32)
    got = SFComm(sf, backend=backend, device=CPU).gather(t(leaf))
    np.testing.assert_array_equal(n(got), simulate.gather_ref(sf, leaf))
    # the multi-SF's reduce is the gather: one leaf per slot
    red = SFComm(multi, backend=backend, device=CPU).reduce(
        t(leaf), torch.zeros((multi.nroots_total, 2)))
    np.testing.assert_array_equal(n(red), n(got))


@pytest.mark.parametrize("name", ["general0", "general1", "composed",
                                  "embedded", "local_only", "random7"])
def test_simulate_matches_reference(name):
    ref = FORESTS[name]
    sf = port_sf(ref)
    rng = np.random.default_rng(len(name))
    root = rng.integers(-50, 50, (ref.nroots_total, 2)).astype(np.int64)
    leaf = rng.integers(-50, 50, (ref.nleafspace_total, 2)).astype(np.int64)
    for op in ("replace", "sum", "max", "min", "prod"):
        np.testing.assert_array_equal(
            simulate.bcast_ref(sf, root, leaf, op),
            RSim.bcast_ref(ref, root, leaf, op))
        np.testing.assert_array_equal(
            simulate.reduce_ref(sf, leaf, root, op),
            RSim.reduce_ref(ref, leaf, root, op))
    for a, b in zip(simulate.fetch_and_op_ref(sf, root, leaf),
                    RSim.fetch_and_op_ref(ref, root, leaf)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(simulate.multi_root_layout(sf),
                    RSim.multi_root_layout(ref)):
        np.testing.assert_array_equal(a, b)
    multi = simulate.gather_ref(sf, leaf)
    np.testing.assert_array_equal(multi, RSim.gather_ref(ref, leaf))
    np.testing.assert_array_equal(simulate.scatter_ref(sf, multi),
                                  RSim.scatter_ref(ref, multi))
    np.testing.assert_array_equal(simulate.scatter_ref(sf, multi, leaf),
                                  RSim.scatter_ref(ref, multi, leaf))
