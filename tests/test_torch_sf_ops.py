"""Port parity, SF operations: ``SFComm`` on the port's ``"global"`` and
``"cuda"`` backends (CPU tensors, so the kernels' plain versions) against
the reference ``SFComm`` on ``"global"`` and ``"pallas"``, over every
``sf_fixtures.FIXTURES`` graph.

Replace and integer payloads are bitwise; float sums use the reference
``test_backends.py`` tolerances (bcast 1e-5, reduce 1e-4).  The reference
``"pallas"`` backend cannot run its strided pack on this jax
(``pl.unblocked`` is gone, ROADMAP Queue 3), so wherever that backend would
take its strided pack (the strided and composed-inverse fixtures) the
port's ``"cuda"`` backend is held against the reference ``"global"``
backend.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from sf_fixtures import FIXTURES  # noqa: E402
from torch_parity import n, port_sf, t  # noqa: E402

from repro.core import SFComm as RefComm  # noqa: E402
from repro_torch.core import SFComm, UnitSpec  # noqa: E402

BACKENDS = ["global", "cuda"]
_CACHE = {}


def _comms(name, backend):
    """(reference comm, port comm) for a fixture, built once per module."""
    key = (name, backend)
    if key not in _CACHE:
        ref_sf = FIXTURES[name]()
        ref = RefComm(ref_sf, backend={"global": "global",
                                       "cuda": "pallas"}[backend])
        if getattr(ref.backend, "_bcast_strided", None) is not None \
                or getattr(ref.backend, "_reduce_strided", None) is not None:
            ref = RefComm(ref_sf, backend="global")   # pallas strided pack
        _CACHE[key] = (ref, SFComm(port_sf(ref_sf), backend=backend,
                                   device="cpu"))
    return _CACHE[key]


def _payload(rng, shape, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(1, 50, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _same(got, want, exact, tol):
    got, want = n(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["replace", "sum", "max"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_bcast_matches_reference(name, op, backend, rng):
    ref, comm = _comms(name, backend)
    sf = comm.sf
    root = _payload(rng, (sf.nroots_total, 3), np.float32)
    leaf = _payload(rng, (sf.nleafspace_total, 3), np.float32)
    want = ref.bcast(jnp.asarray(root), jnp.asarray(leaf), op)
    got = comm.bcast(t(root), t(leaf), op)
    _same(got, want, op != "sum", 1e-5)
    pend = comm.bcast_begin(t(root), op)
    _same(pend.end(t(leaf)), want, op != "sum", 1e-5)
    _same(comm.bcast_end(comm.bcast_begin(t(root), op), t(leaf)), want,
          op != "sum", 1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["replace", "sum", "max"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reduce_matches_reference(name, op, backend, rng):
    ref, comm = _comms(name, backend)
    sf = comm.sf
    root = _payload(rng, (sf.nroots_total, 2), np.float32)
    leaf = _payload(rng, (sf.nleafspace_total, 2), np.float32)
    want = ref.reduce(jnp.asarray(leaf), jnp.asarray(root), op)
    _same(comm.reduce(t(leaf), t(root), op), want, op != "sum", 1e-4)
    pend = comm.reduce_begin(t(leaf), op)
    _same(comm.reduce_end(pend, t(root)), want, op != "sum", 1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fetch_gather_scatter_degrees_match_reference(name, backend, rng):
    ref, comm = _comms(name, backend)
    sf = comm.sf
    ri = rng.integers(0, 100, (sf.nroots_total,)).astype(np.int32)
    li = rng.integers(0, 100, (sf.nleafspace_total,)).astype(np.int32)
    for got, want in zip(comm.fetch_and_op(t(ri), t(li)),
                         ref.fetch_and_op(jnp.asarray(ri), jnp.asarray(li))):
        _same(got, want, True, 0)
    leaf = _payload(rng, (sf.nleafspace_total, 2), np.float32)
    multi = comm.gather(t(leaf))
    want_multi = ref.gather(jnp.asarray(leaf))
    _same(multi, want_multi, True, 0)
    _same(comm.scatter(multi, t(leaf)),
          ref.scatter(want_multi, jnp.asarray(leaf)), True, 0)
    _same(comm.scatter(multi), ref.scatter(want_multi), True, 0)
    assert comm.nmulti == ref.backend.nmulti
    deg = comm.compute_degrees()
    assert deg.dtype == torch.int32
    _same(deg, ref.compute_degrees(), True, 0)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["general0", "general1", "composed",
                                  "local_only"])
@pytest.mark.parametrize("root_dtype,leaf_dtype", [
    (np.float32, np.float32), (np.float32, np.int32), (np.int32, np.float32)])
def test_fetch_and_op_dtypes_match_reference(name, root_dtype, leaf_dtype,
                                             backend, rng):
    """Leaf values are cast to the root dtype before they are added, as in
    the reference.  Float leaves into int32 roots are k + 0.75, so every
    sum is exact and truncating each value differs from truncating the
    total of any root with two edges or more.  Float roots add their segment's total, not each
    value in turn, so they match to the reduce tolerance."""
    ref, comm = _comms(name, backend)
    sf = comm.sf
    root = _payload(rng, (sf.nroots_total,), root_dtype)
    if root_dtype == np.int32 and leaf_dtype == np.float32:
        leaf = (rng.integers(0, 40, sf.nleafspace_total) + 0.75).astype(
            np.float32)
    else:
        leaf = _payload(rng, (sf.nleafspace_total,), leaf_dtype)
    exact = root_dtype == np.int32
    for got, want in zip(comm.fetch_and_op(t(root), t(leaf)),
                         ref.fetch_and_op(jnp.asarray(root),
                                          jnp.asarray(leaf))):
        assert got.dtype == getattr(torch, np.dtype(want.dtype).name)
        _same(got, want, exact, 1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["lor", "land", "min", "prod"])
@pytest.mark.parametrize("name", ["general0", "general1", "composed",
                                  "local_only"])
def test_other_reduce_ops_match_reference(name, op, backend, rng):
    ref, comm = _comms(name, backend)
    sf = comm.sf
    root = rng.integers(0, 2, (sf.nroots_total,)).astype(np.int32)
    leaf = rng.integers(0, 2, (sf.nleafspace_total,)).astype(np.int32)
    _same(comm.reduce(t(leaf), t(root), op),
          ref.reduce(jnp.asarray(leaf), jnp.asarray(root), op), True, 0)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["general0", "strided", "embedded"])
@pytest.mark.parametrize("unit,dtype", [((3,), np.int32), ((2, 2), np.int32),
                                        ((), np.int32), ((2, 2), np.float32)])
def test_unit_dtype_matches_reference(name, unit, dtype, backend, rng):
    ref, comm = _comms(name, backend)
    sf = comm.sf
    root = _payload(rng, (sf.nroots_total,) + unit, dtype)
    leaf = _payload(rng, (sf.nleafspace_total,) + unit, dtype)
    exact = np.issubdtype(np.dtype(dtype), np.integer)
    for op in ("replace", "sum"):
        _same(comm.bcast(t(root), t(leaf), op),
              ref.bcast(jnp.asarray(root), jnp.asarray(leaf), op),
              exact or op == "replace", 1e-4)
        _same(comm.reduce(t(leaf), t(root), op),
              ref.reduce(jnp.asarray(leaf), jnp.asarray(root), op),
              exact or op == "replace", 1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_operations_leave_arguments_untouched(backend, rng):
    _, comm = _comms("general0", backend)
    sf = comm.sf
    root = t(_payload(rng, (sf.nroots_total, 2), np.float32))
    leaf = t(_payload(rng, (sf.nleafspace_total, 2), np.float32))
    r0, l0 = root.clone(), leaf.clone()
    comm.bcast(root, leaf, "sum")
    comm.reduce(leaf, root, "max")
    comm.fetch_and_op(root, leaf)
    comm.scatter(comm.gather(leaf), leaf)
    assert torch.equal(root, r0) and torch.equal(leaf, l0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pinned_unit_validates(backend):
    sf = port_sf(FIXTURES["general0"]())
    comm = SFComm(sf, backend=backend, device="cpu", unit=(3,))
    assert comm.unit.shape == (3,)
    root = torch.ones(sf.nroots_total, 3)
    leaf = torch.zeros(sf.nleafspace_total, 3)
    comm.bcast(root, leaf)
    with pytest.raises(ValueError, match="unit shape"):
        comm.bcast(root[:, :2], leaf[:, :2])
    with pytest.raises(ValueError, match="unit shape"):
        comm.reduce(leaf[:, :1], root[:, :1])
    pinned = SFComm(sf, backend=backend, device="cpu",
                    unit=UnitSpec((3,), np.float32))
    pinned.bcast(root, leaf)
    with pytest.raises(ValueError, match="dtype"):
        pinned.bcast(root.int(), leaf.int())


def test_cuda_backend_routing_decisions():
    """The kernel backend keeps the reference's routing: the strided pack
    on 3D-box index lists, the fused kernel for local-only replace bcasts,
    the duplicate-free reduce shortcut."""
    strided = SFComm(port_sf(FIXTURES["strided"]()), backend="cuda",
                     device="cpu").backend
    assert strided._bcast_strided is not None
    assert strided._bcast_strided.dims == (2, 2, 2)
    local = SFComm(port_sf(FIXTURES["local_only"]()), backend="cuda",
                   device="cpu").backend
    assert local._k_src_of_leaf is not None
    assert local.plan.red.duplicate_free
    general = SFComm(port_sf(FIXTURES["general0"]()), backend="cuda",
                     device="cpu").backend
    assert general._k_src_of_leaf is None
    assert not general.plan.red.duplicate_free


def test_registry_and_hints():
    from repro_torch.core import (available_backends, make_backend,
                                  register_backend, select_backend)
    from repro_torch.core import backend as B
    sf = port_sf(FIXTURES["general0"]())
    assert {"global", "cuda"} <= set(available_backends())
    assert select_backend(sf, hint="global") == "global"
    with pytest.raises(ValueError, match="unknown SF backend hint"):
        select_backend(sf, hint="pallas")
    with pytest.raises(ValueError, match="unknown SF backend"):
        make_backend("window", sf)
    with pytest.raises(ValueError, match="unknown SF backend"):
        SFComm(sf, backend="window", device="cpu")
    register_backend("recording", lambda sf, **kw: B.GlobalBackend(sf, **kw))
    try:
        assert SFComm(sf, backend="recording",
                      device="cpu").backend_name == "global"
        with pytest.raises(ValueError, match="already registered"):
            register_backend("recording", lambda sf, **kw: None)
    finally:
        B._REGISTRY.pop("recording", None)
