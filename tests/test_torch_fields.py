"""Port parity, fused multi-field exchange: ``FieldBundle`` and
``SFComm.bcast_multi`` / ``reduce_multi`` of ``repro_torch`` on both port
backends (CPU tensors, so the kernels' plain versions) against the
reference ``FieldBundle`` on the same star forests and fields.

Replace is bitwise (mixed-dtype groups ride bitcast carriers, NaN payload
bits included); float sums use the reference ``test_fields.py`` tolerance
(1e-4), and the fused reduce is also held bitwise against one reduce per
field (the same sorted fold, a column at a time).  Grouping is held equal
to the reference's ``_plan_groups`` member for member.
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
from repro.core import fields as ref_fields  # noqa: E402
from repro_torch.core import (FieldBundle, FieldSpec, SFComm,  # noqa: E402
                              sflog)
from repro_torch.core import fields as port_fields  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

BACKENDS = ["global", "cuda"]


def _fields(rng, n_):
    """Mixed-spec field set: f32 vector, i32 scalar, f32 tensor, f32 scalar
    (the reference test's)."""
    return [rng.standard_normal((n_, 3)).astype(np.float32),
            rng.integers(0, 100, (n_,)).astype(np.int32),
            rng.standard_normal((n_, 2, 2)).astype(np.float32),
            rng.standard_normal((n_,)).astype(np.float32)]


def _pair(name, backend):
    ref_sf = FIXTURES[name]()
    return (RefComm(ref_sf, backend="global"),
            SFComm(port_sf(ref_sf), backend=backend, device="cpu"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fixture", ["general0", "allgather", "local_only"])
def test_bcast_multi_conformance(backend, fixture, rng):
    ref, comm = _pair(fixture, backend)
    sf = comm.sf
    roots = _fields(rng, sf.nroots_total)
    leaves = _fields(rng, sf.nleafspace_total)
    want = ref.bcast_multi([jnp.asarray(a) for a in roots],
                           [jnp.asarray(a) for a in leaves], "replace")
    outs = comm.bcast_multi([t(a) for a in roots], [t(a) for a in leaves],
                            "replace")
    for o, w, r in zip(outs, want, roots):
        np.testing.assert_array_equal(n(o), n(w))
        assert n(o).dtype == r.dtype
        assert o.is_contiguous()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["sum", "max"])
def test_reduce_multi_conformance(backend, op, rng):
    ref, comm = _pair("general1", backend)
    sf = comm.sf
    roots = _fields(rng, sf.nroots_total)
    leaves = _fields(rng, sf.nleafspace_total)
    want = ref.reduce_multi([jnp.asarray(a) for a in leaves],
                            [jnp.asarray(a) for a in roots], op)
    outs = comm.reduce_multi([t(a) for a in leaves], [t(a) for a in roots],
                             op)
    for o, w, lf, r in zip(outs, want, leaves, roots):
        np.testing.assert_allclose(n(o), n(w), rtol=1e-4, atol=1e-4)
        if op == "max" or r.dtype == np.int32:
            np.testing.assert_array_equal(n(o), n(w))
        # the fused fold is the per-field fold, column for column
        np.testing.assert_array_equal(n(o), n(comm.reduce(t(lf), t(r), op)))


_SPEC_SETS = [
    [((3,), "float32"), ((), "int32"), ((2, 2), "float32")],
    [((), "float32"), ((), "uint32"), ((2,), "int32"), ((), "float64"),
     ((), "int64"), ((3,), "float64")],
    [((), "float16"), ((2,), "bfloat16"), ((), "int16"), ((), "uint16")],
    [((), "int8"), ((), "uint8"), ((2,), "bool"), ((), "bool"),
     ((), "int8")],
    [((3,), "float32"), ((), "float32"), ((), "float32"), ((), "int32"),
     ((), "bfloat16")],
]


@pytest.mark.parametrize("specs", _SPEC_SETS)
def test_grouping_matches_reference(specs):
    """Replace groups by itemsize (bool and 8-byte dtypes by exact dtype),
    arithmetic ops by exact dtype, members in user order: the reference's
    groups, carriers and offsets."""
    ref_specs = [ref_fields.FieldSpec(s, jnp.dtype(d)) for s, d in specs]
    port_specs = [FieldSpec(s, getattr(torch, d)) for s, d in specs]
    for by_bytes in (True, False):
        want = ref_fields._plan_groups(ref_specs, by_bytes)
        got = port_fields._plan_groups(port_specs, by_bytes)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.members, g.widths, g.offsets, g.bitcast) \
                == (w.members, w.widths, w.offsets, w.bitcast)
            assert str(g.carrier)[6:] == np.dtype(w.carrier).name


def test_grouping_replace_fuses_bytes_arithmetic_splits_dtypes():
    _, comm = _pair("general0", "global")
    specs = [FieldSpec((3,), np.float32), FieldSpec((), np.int32),
             FieldSpec((2, 2), np.float32)]
    bundle = FieldBundle(comm, specs)
    assert bundle.ngroups("replace") == 1
    assert bundle.ngroups("sum") == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_k4_same_pattern_is_one_exchange(backend, rng, monkeypatch):
    """bcast_multi of k=4 same-pattern fields issues exactly ONE backend
    exchange and ONE kernel pack, and the ``fields.*`` counters say so."""
    ref, comm = _pair("general0", backend)
    sf = comm.sf
    k = 4
    roots = [rng.standard_normal((sf.nroots_total,)).astype(np.float32)
             for _ in range(k)]
    leaves = [rng.standard_normal((sf.nleafspace_total,)).astype(np.float32)
              for _ in range(k)]
    bundle = comm._bundle([t(a) for a in roots])
    assert bundle.ngroups("replace") == 1
    counts = {"exchange": 0, "pack": 0}
    real_bcast = bundle._exec.bcast
    real_pack = kops.pack_rows

    def counting_bcast(r, lf, op="replace"):
        counts["exchange"] += 1
        return real_bcast(r, lf, op)

    def counting_pack(*a, **kw):
        counts["pack"] += 1
        return real_pack(*a, **kw)

    monkeypatch.setattr(bundle._exec, "bcast", counting_bcast)
    monkeypatch.setattr(kops, "pack_rows", counting_pack)
    before = sflog.counters()
    outs = bundle.bcast_multi([t(a) for a in roots], [t(a) for a in leaves])
    after = sflog.counters()
    assert counts["exchange"] == 1
    assert counts["pack"] == (1 if backend == "cuda" else 0)
    assert after["fields.fused_exchanges"] \
        - before.get("fields.fused_exchanges", 0) == 1
    assert after["fields.fields_moved"] \
        - before.get("fields.fields_moved", 0) == k
    assert after["fields.multi_calls"] \
        - before.get("fields.multi_calls", 0) == 1
    want = ref.bcast_multi([jnp.asarray(a) for a in roots],
                           [jnp.asarray(a) for a in leaves])
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(n(o), n(w))


def _nan_payload_f32(rng, size):
    a = rng.standard_normal(size).astype(np.float32)
    bits = a.view(np.uint32).reshape(-1)
    bits[::5] = 0x7FC00000 | rng.integers(1, 1 << 22, bits[::5].size,
                                          dtype=np.uint32)
    bits[1::7] = 0xFF800000 | rng.integers(1, 1 << 22, bits[1::7].size,
                                           dtype=np.uint32)
    return a


def _mixed(rng, size):
    """f32 with NaN payloads + i32 (4-byte group), bf16 + f16 + i16 (2-byte
    group), u8 + i8 (1-byte group), f64 (alone)."""
    bf = rng.integers(0, 1 << 16, (size, 2), dtype=np.uint16)
    bf[::3, 0] = 0x7FC1                  # a bf16 NaN with payload bits
    return [_nan_payload_f32(rng, (size, 3)),
            rng.integers(-2 ** 30, 2 ** 30, (size,)).astype(np.int32),
            bf, rng.standard_normal((size,)).astype(np.float16),
            rng.integers(-2 ** 14, 2 ** 14, (size,)).astype(np.int16),
            rng.integers(0, 256, (size,)).astype(np.uint8),
            rng.integers(-128, 128, (size,)).astype(np.int8),
            rng.standard_normal((size,))]


def _as_ref(a, i):
    return jnp.asarray(a.view(jnp.bfloat16) if i == 2 else a)


def _as_port(a, i):
    x = t(a)
    return x.view(torch.bfloat16) if i == 2 else x


def _bytes(x):
    """The raw bytes of a torch tensor or a reference array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fixture", ["general0", "composed"])
def test_mixed_dtype_replace_bit_exact(backend, fixture, rng):
    """Mixed-dtype replace groups round-trip bit for bit through the
    uint8 / uint16 / uint32 carriers, NaN payload bits included, and equal
    the reference's bits."""
    ref, comm = _pair(fixture, backend)
    sf = comm.sf
    roots = _mixed(rng, sf.nroots_total)
    leaves = _mixed(rng, sf.nleafspace_total)
    troots = [_as_port(a, i) for i, a in enumerate(roots)]
    tleaves = [_as_port(a, i) for i, a in enumerate(leaves)]
    bundle = comm._bundle(troots)
    assert bundle.ngroups("replace") == 4
    assert [g.carrier for g in bundle._byte_groups] == [
        torch.uint32, torch.uint16, torch.uint8, torch.float64]
    outs = comm.bcast_multi(troots, tleaves)
    # the reference runs with x64 off (its f64 field would travel as f32):
    # it gets the first seven fields, the f64 one its own exchange below
    want = ref.bcast_multi([_as_ref(a, i) for i, a in enumerate(roots[:7])],
                           [_as_ref(a, i) for i, a in enumerate(leaves[:7])])
    for i, (o, lf) in enumerate(zip(outs, tleaves)):
        assert o.dtype == lf.dtype
        if i < 7:
            np.testing.assert_array_equal(_bytes(o), _bytes(want[i]))
        # and each field as its own exchange
        np.testing.assert_array_equal(_bytes(o),
                                      _bytes(comm.bcast(troots[i], lf)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_split_phase_equals_fused(backend, rng):
    _, comm = _pair("general1", backend)
    sf = comm.sf
    roots = [t(a) for a in _fields(rng, sf.nroots_total)]
    leaves = [t(a) for a in _fields(rng, sf.nleafspace_total)]
    pend = comm.bcast_multi_begin(roots)
    for a, b in zip(comm.bcast_multi_end(pend, leaves),
                    comm.bcast_multi(roots, leaves)):
        assert torch.equal(a, b)
    pend = comm.reduce_multi_begin(leaves, "sum")
    for a, b in zip(pend.end(roots), comm.reduce_multi(leaves, roots, "sum")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pinned_unit_runs_on_a_sibling_backend(backend, rng):
    """A comm whose unit is pinned fuses through a sibling backend with the
    unit lifted, sharing the plan's device index tensors."""
    ref_sf = FIXTURES["general0"]()
    comm = SFComm(port_sf(ref_sf), backend=backend, device="cpu", unit=(3,))
    sf = comm.sf
    roots = [t(rng.standard_normal((sf.nroots_total, 3)).astype(np.float32))
             for _ in range(2)]
    leaves = [t(rng.standard_normal((sf.nleafspace_total, 3))
                .astype(np.float32)) for _ in range(2)]
    bundle = comm._bundle(roots)
    assert bundle._exec is not comm.backend
    assert not bundle._exec.plan.unit.constrained
    assert bundle._exec._unpack is comm.backend._unpack
    for o, r, lf in zip(comm.bcast_multi(roots, leaves), roots, leaves):
        assert torch.equal(o, comm.bcast(r, lf))
    with pytest.raises(ValueError, match="unit shape"):
        FieldBundle(comm, [FieldSpec((2,), np.float32)])


def test_bundle_error_surface():
    _, comm = _pair("general0", "global")
    sf = comm.sf
    nr, nl = sf.nroots_total, sf.nleafspace_total
    roots = [torch.zeros(nr), torch.zeros(nr, 2)]
    leaves = [torch.zeros(nl), torch.zeros(nl, 2)]
    bundle = comm._bundle(roots)
    with pytest.raises(ValueError, match="got 1 rootdata"):
        bundle.bcast_multi(roots[:1], leaves)
    with pytest.raises(ValueError, match="unit shape"):
        bundle.bcast_multi([roots[0], roots[0]], leaves)
    with pytest.raises(ValueError, match="lengths"):
        bundle.bcast_multi([r[:-1] for r in roots], leaves)
    with pytest.raises(ValueError, match="at least one field"):
        FieldBundle(comm, [])
    with pytest.raises(ValueError, match="pins both"):
        FieldSpec((3,), None)


def test_comm_bundle_cache(rng):
    _, comm = _pair("general0", "global")
    sf = comm.sf
    roots = [t(a) for a in _fields(rng, sf.nroots_total)]
    leaves = [t(a) for a in _fields(rng, sf.nleafspace_total)]
    comm.bcast_multi(roots, leaves)
    b1 = comm._bundle(roots)
    comm.reduce_multi(leaves, roots, "sum")
    assert comm._bundle(leaves) is b1      # same signature, one bundle
    assert len(comm._bundles) == 1
