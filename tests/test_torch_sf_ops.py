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


# ------------------------------------------------- the dtype matrix
_REF_GLOBAL = {}


def _ref_global(name):
    if name not in _REF_GLOBAL:
        _REF_GLOBAL[name] = RefComm(FIXTURES[name](), backend="global")
    return _REF_GLOBAL[name]


def _full_range(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
@pytest.mark.parametrize("name", ["general0", "general1", "composed",
                                  "local_only", "allgather"])
def test_unsigned_payloads_match_reference(name, dtype, backend, rng):
    """uint16 / uint32 over the whole value range, bitwise against the
    reference: replace / sum / prod (wrapping) move as signed views, max /
    min (which a signed view would get wrong above 2^15 / 2^31) widened."""
    ref, (_, comm) = _ref_global(name), _comms(name, backend)
    sf = comm.sf
    root = _full_range(rng, (sf.nroots_total, 2), dtype)
    leaf = _full_range(rng, (sf.nleafspace_total, 2), dtype)
    jr, jl = jnp.asarray(root), jnp.asarray(leaf)
    for op in ("replace", "sum", "max"):
        got = comm.bcast(t(root), t(leaf), op)
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        _same(got, ref.bcast(jr, jl, op), True, 0)
        _same(comm.bcast_begin(t(root), op).end(t(leaf)),
              ref.bcast(jr, jl, op), True, 0)
    for op in ("replace", "sum", "prod", "max", "min"):
        want = ref.reduce(jl, jr, op)
        _same(comm.reduce(t(leaf), t(root), op), want, True, 0)
        _same(comm.reduce_end(comm.reduce_begin(t(leaf), op), t(root)), want,
              True, 0)
    ri, li = root[:, 0].copy(), leaf[:, 0].copy()
    for got, want in zip(comm.fetch_and_op(t(ri), t(li)),
                         ref.fetch_and_op(jnp.asarray(ri), jnp.asarray(li))):
        _same(got, want, True, 0)
    multi = comm.gather(t(leaf))
    want_multi = ref.gather(jl)
    _same(multi, want_multi, True, 0)
    _same(comm.scatter(multi, t(leaf)), ref.scatter(want_multi, jl), True, 0)
    _same(comm.scatter(multi), ref.scatter(want_multi), True, 0)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["general0", "general1", "composed"])
def test_unsigned_mixed_dtypes_convert_by_value(name, backend, rng):
    """A uint32 payload into int32 / float32 destinations (and back) is
    converted by value, as the reference casts."""
    ref, (_, comm) = _ref_global(name), _comms(name, backend)
    sf = comm.sf
    ru = rng.integers(0, 2 ** 20, sf.nroots_total).astype(np.uint32)
    lu = rng.integers(0, 2 ** 20, sf.nleafspace_total).astype(np.uint32)
    rf = rng.integers(0, 2 ** 20, sf.nroots_total).astype(np.float32)
    li = rng.integers(0, 2 ** 20, sf.nleafspace_total).astype(np.int32)
    _same(comm.bcast(t(ru), t(li)), ref.bcast(jnp.asarray(ru),
                                              jnp.asarray(li)), True, 0)
    _same(comm.bcast_begin(t(ru)).end(t(li)),
          ref.bcast(jnp.asarray(ru), jnp.asarray(li)), True, 0)
    for op in ("sum", "max"):
        _same(comm.reduce(t(lu), t(rf), op),
              ref.reduce(jnp.asarray(lu), jnp.asarray(rf), op), True, 0)
        _same(comm.reduce_begin(t(li), op).end(t(ru)),
              ref.reduce(jnp.asarray(li), jnp.asarray(ru), op), True, 0)


_NEW_DTYPES = [np.int8, np.uint8, np.int16, np.int64, np.float16]


def _oracle_reduce(gr, gl, leaf, root, op):
    """np.<op>.at over the plan's edges in edge order (exact for integers:
    their sums and products wrap the same in any order)."""
    out = root.copy()
    fn = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
          "min": np.minimum}[op]
    with np.errstate(over="ignore"):
        fn.at(out, gr, leaf[gl].astype(out.dtype))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", _NEW_DTYPES)
@pytest.mark.parametrize("name", ["general0", "general1", "composed"])
def test_reduce_new_dtypes_match_oracle(name, dtype, backend, rng):
    """int8 / uint8 / int16 / int64 / float16 reductions over repeated roots
    on both backends: integers bitwise against an ``np.<op>.at`` oracle
    (the reference weakens int64 to int32 with x64 off, so it is not the
    oracle here), float16 within 1e-2 of it; the two backends bitwise
    equal to each other."""
    _, comm = _comms(name, backend)
    _, other = _comms(name, "global" if backend == "cuda" else "cuda")
    sf = comm.sf
    plan = comm.backend.plan
    assert plan.red.max_valid_seg_len > 1
    if dtype == np.float16:
        leaf = (1 + 0.1 * rng.standard_normal((sf.nleafspace_total, 2))
                ).astype(dtype)
        root = (1 + 0.1 * rng.standard_normal((sf.nroots_total, 2))
                ).astype(dtype)
    else:
        leaf = _full_range(rng, (sf.nleafspace_total, 2), dtype)
        root = _full_range(rng, (sf.nroots_total, 2), dtype)
    for op in ("sum", "prod", "max", "min"):
        got = comm.reduce(t(leaf), t(root), op)
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        want = _oracle_reduce(plan.gr, plan.gl, leaf, root, op)
        if dtype == np.float16:
            np.testing.assert_allclose(n(got).astype(np.float64), want,
                                       rtol=1e-2, atol=1e-2)
        else:
            np.testing.assert_array_equal(n(got), want)
        assert torch.equal(got, other.reduce(t(leaf), t(root), op))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_global_float_reduce_is_the_cuda_backends_fold(name, dtype, rng):
    """Both backends finish a float reduction with the same sorted fold, so
    their results are the same bits (on the card too: no atomics)."""
    _, gl = _comms(name, "global")
    _, cu = _comms(name, "cuda")
    sf = gl.sf
    leaf = rng.standard_normal((sf.nleafspace_total, 3)).astype(dtype)
    root = rng.standard_normal((sf.nroots_total, 3)).astype(dtype)
    for op in ("sum", "prod", "max", "min"):
        assert torch.equal(gl.reduce(t(leaf), t(root), op),
                           cu.reduce(t(leaf), t(root), op))
    for a, b in zip(gl.fetch_and_op(t(root), t(leaf)),
                    cu.fetch_and_op(t(root), t(leaf))):
        assert torch.equal(a, b)


# ------------------------------------------------- bool payloads (F1, F2)
_BOOL_ROOTS = ["int32", "int8", "uint8", "float32", "float16", "bfloat16"]


def _jax_of(a, dtype: str):
    return jnp.asarray(a).astype(dtype)


def _torch_of(a, dtype: str):
    return t(np.asarray(a)).to(getattr(torch, dtype))


def _as_np(x) -> np.ndarray:
    """A result as numpy; bfloat16 through float32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _bool_ref(name, backend, leaf_is_bool):
    """The port backend's reference counterpart for one case: ``"pallas"``
    for ``"cuda"`` (``"global"`` where it would take its strided pack).
    From bool leaves the reference ``"pallas"`` folds in bool: its sums are
    logical ors and its max / min raise (``test_reference_pallas_bool_
    folds``); there the port's ``"cuda"`` returns the ``"global"`` answer,
    the counts in the root dtype."""
    if backend == "cuda" and leaf_is_bool:
        return _ref_global(name)
    return _comms(name, backend)[0]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_bool_payloads_match_reference(name, backend, rng):
    """F1: max / min into a bool root (bool or int32 leaves); F2: sum, max
    and min from bool leaves into int32 / int8 / uint8 / float32 / float16
    / bfloat16 roots (the counts, in the root dtype); bool bcasts; sum and
    prod into bool destinations raise TypeError, as in the reference.
    Fused and split forms, bitwise."""
    _, comm = _comms(name, backend)
    sf = comm.sf
    lb = rng.integers(0, 2, (sf.nleafspace_total,)).astype(bool)
    rb = rng.integers(0, 2, (sf.nroots_total,)).astype(bool)
    li = rng.integers(0, 3, (sf.nleafspace_total,)).astype(np.int32)

    def check(leaf, root, rdt, op, leaf_is_bool):
        ref = _bool_ref(name, backend, leaf_is_bool)
        want = _as_np(ref.reduce(jnp.asarray(leaf), _jax_of(root, rdt), op))
        ldt = "bool" if leaf_is_bool else "int32"
        tl, tr = _torch_of(leaf, ldt), _torch_of(root, rdt)
        for got in (comm.reduce(tl, tr, op),
                    comm.reduce_end(comm.reduce_begin(tl, op), tr),
                    comm.reduce_begin(tl, op).end(tr)):
            assert got.dtype == getattr(torch, rdt), (op, rdt)
            np.testing.assert_array_equal(_as_np(got), want,
                                          err_msg=f"{op} into {rdt}")

    for op in ("max", "min"):                       # F1
        check(lb, rb, "bool", op, True)
        check(li, rb, "bool", op, False)
    for rdt in _BOOL_ROOTS:                         # F2
        root = rng.integers(0, 3, (sf.nroots_total,))
        for op in ("sum", "max", "min"):
            check(lb, root, rdt, op, True)
    ref = _ref_global(name)
    for op in ("replace", "max", "min"):
        want = np.asarray(ref.bcast(jnp.asarray(rb), jnp.asarray(lb), op))
        np.testing.assert_array_equal(n(comm.bcast(t(rb), t(lb), op)), want)
        np.testing.assert_array_equal(
            n(comm.bcast_begin(t(rb), op).end(t(lb))), want)
    check(lb, rb, "bool", "replace", True)
    for op in ("sum", "prod"):                      # the error surface
        for fn in (lambda: comm.bcast(t(rb), t(lb), op),
                   lambda: comm.bcast_begin(t(rb), op).end(t(lb)),
                   lambda: comm.reduce(t(lb), t(rb), op),
                   lambda: comm.reduce_begin(t(li), op).end(t(rb))):
            with pytest.raises(TypeError, match="does not accept dtype bool"):
                fn()
        with pytest.raises(TypeError, match="does not accept dtype bool"):
            ref.reduce(jnp.asarray(lb), jnp.asarray(rb), op)


def test_reference_pallas_bool_folds(rng):
    """Pins the reference difference the port's ``"cuda"`` does not mirror
    (ROADMAP Queue 3): on the allgather fixture (four leaves a root) the
    reference ``"pallas"`` sums bool leaves as a logical or and refuses
    max from them, where ``"global"`` and both port backends count."""
    sf = FIXTURES["allgather"]()
    pallas = RefComm(sf, backend="pallas")
    lb = rng.integers(0, 2, (sf.nleafspace_total,)).astype(bool)
    zero = np.zeros(sf.nroots_total, np.int32)
    counts = np.asarray(_ref_global("allgather").reduce(
        jnp.asarray(lb), jnp.asarray(zero), "sum"))
    assert counts.max() > 1
    np.testing.assert_array_equal(
        np.asarray(pallas.reduce(jnp.asarray(lb), jnp.asarray(zero), "sum")),
        np.minimum(counts, 1))
    for backend in BACKENDS:
        np.testing.assert_array_equal(
            n(_comms("allgather", backend)[1].reduce(t(lb), t(zero), "sum")),
            counts)
    with pytest.raises(ValueError):
        pallas.reduce(jnp.asarray(lb), jnp.asarray(lb), "max")
