"""Property tests over random star forests for the port's payload dtypes:
bool, int8, uint8, uint16, int32, float16, bfloat16 and float32 under
every op, on both in-process backends (``"global"``, ``"cuda"`` on its
plain versions), against the reference's ``simulate`` oracle; per dtype on
a fixed SF against the reference ``SFComm``; and the recorded mixed-dtype
difference (ROADMAP Queue 3): int8 leaves summed into an int32 root wrap
on ``"cuda"`` and the reference ``"pallas"`` (leaf-dtype fold), not on
``"global"`` (root-dtype fold).

Float payloads hold values in {-2, ..., 2}: every sum and product of a
few of them is exact in each float dtype, so the comparisons are bitwise
whatever the fold order.  Integer payloads span their whole range (sums
and products wrap the same in any order).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from sf_fixtures import FIXTURES  # noqa: E402
from test_sf_property import star_forests  # noqa: E402
from torch_parity import port_sf  # noqa: E402

from repro.core import SFComm as RefComm  # noqa: E402
from repro.core import simulate  # noqa: E402
from repro_torch.core import SFComm  # noqa: E402

DTYPES = ["bool", "int8", "uint8", "uint16", "int32", "float16", "bfloat16",
          "float32"]
OPS = ["replace", "sum", "prod", "max", "min"]
BACKENDS = ["global", "cuda"]


def _ops(dtype):
    """A sum or product into bool raises TypeError (as in the reference)."""
    return ["replace", "max", "min"] if dtype == "bool" else OPS


def _values(rng, shape, dtype):
    """numpy payload: floats as float32 in {-2..2} (exact in bf16 / f16),
    integers over their whole range, bools 0/1."""
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype in ("float16", "bfloat16", "float32"):
        return rng.integers(-2, 3, shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=dtype)


def _torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _np(x, dtype):
    """A port result as numpy in the oracle's dtype (bf16 / f16 exactly as
    float32)."""
    if dtype in ("float16", "bfloat16"):
        return x.float().numpy()
    return x.numpy()


def _oracle_dtype(a, dtype):
    return a.astype(np.float16) if dtype == "float16" else a


@settings(max_examples=30, deadline=None)
@given(star_forests(), st.sampled_from(DTYPES), st.sampled_from([(), (2,)]),
       st.integers(0, 2 ** 31 - 1))
def test_every_dtype_and_op_matches_the_reference_oracle(sf, dtype, unit,
                                                         seed):
    rng = np.random.default_rng(seed)
    root = _oracle_dtype(_values(rng, (sf.nroots_total,) + unit, dtype),
                         dtype)
    leaf = _oracle_dtype(_values(rng, (sf.nleafspace_total,) + unit, dtype),
                         dtype)
    psf = port_sf(sf)
    tr, tl = _torch(root, dtype), _torch(leaf, dtype)
    for backend in BACKENDS:
        comm = SFComm(psf, backend=backend, device="cpu")
        for op in _ops(dtype):
            with np.errstate(over="ignore"):
                wb = simulate.bcast_ref(sf, root, leaf, op)
                wr = simulate.reduce_ref(sf, leaf, root, op)
            got_b = comm.bcast(tr, tl, op)
            got_r = comm.reduce(tl, tr, op)
            assert got_b.dtype == tr.dtype and got_r.dtype == tr.dtype
            np.testing.assert_array_equal(_np(got_b, dtype), wb,
                                          err_msg=f"{backend} bcast {op}")
            np.testing.assert_array_equal(_np(got_r, dtype), wr,
                                          err_msg=f"{backend} reduce {op}")
            np.testing.assert_array_equal(
                _np(comm.reduce_begin(tl, op).end(tr), dtype), wr,
                err_msg=f"{backend} split reduce {op}")
        if dtype == "bool":
            for op in ("sum", "prod"):
                with pytest.raises(TypeError, match="does not accept"):
                    comm.reduce(tl, tr, op)


@pytest.mark.parametrize("dtype", DTYPES)
def test_each_dtype_matches_the_reference_sfcomm(dtype, rng):
    """Per dtype on the general0 fixture, both port backends against the
    reference ``SFComm(backend="global")``, bitwise."""
    sf = FIXTURES["general0"]()
    ref = RefComm(sf, backend="global")
    root = _values(rng, (sf.nroots_total, 2), dtype)
    leaf = _values(rng, (sf.nleafspace_total, 2), dtype)
    jr, jl = jnp.asarray(root).astype(dtype), jnp.asarray(leaf).astype(dtype)
    want = {op: np.asarray(ref.reduce(jl, jr, op)).astype(
        np.float32 if dtype in ("float16", "bfloat16") else None)
        for op in _ops(dtype) if op != "prod"}
    want_b = np.asarray(ref.bcast(jr, jl, "replace")).astype(
        np.float32 if dtype in ("float16", "bfloat16") else None)
    for backend in BACKENDS:
        comm = SFComm(port_sf(sf), backend=backend, device="cpu")
        tr, tl = _torch(root, dtype), _torch(leaf, dtype)
        for op, w in want.items():
            np.testing.assert_array_equal(_np(comm.reduce(tl, tr, op), dtype),
                                          w, err_msg=f"{backend} {op}")
        np.testing.assert_array_equal(_np(comm.bcast(tr, tl), dtype), want_b)


def _fold_oracles(sf, leaf8, root32):
    """(leaf-dtype fold, root-dtype fold) of int8 leaves into int32 roots:
    each root's leaves summed in int8 (wrapping) then added, or summed in
    int32."""
    edges = sf.edges_global()
    seg8 = np.zeros(sf.nroots_total, np.int8)
    seg32 = np.zeros(sf.nroots_total, np.int32)
    with np.errstate(over="ignore"):
        np.add.at(seg8, edges[:, 0], leaf8[edges[:, 1]])
    np.add.at(seg32, edges[:, 0], leaf8[edges[:, 1]].astype(np.int32))
    return root32 + seg8.astype(np.int32), root32 + seg32


@settings(max_examples=30, deadline=None)
@given(star_forests(), st.integers(0, 2 ** 31 - 1))
def test_int8_into_int32_sums_wrap_on_cuda_not_on_global(sf, seed):
    """The recorded difference: ``"cuda"`` folds int8 leaves in int8 (so a
    root's sum past 127 wraps), ``"global"`` casts them to int32 first."""
    rng = np.random.default_rng(seed)
    leaf = rng.integers(60, 128, sf.nleafspace_total).astype(np.int8)
    root = rng.integers(-5, 5, sf.nroots_total).astype(np.int32)
    wrap, wide = _fold_oracles(sf, leaf, root)
    psf = port_sf(sf)
    tl, tr = torch.from_numpy(leaf), torch.from_numpy(root)
    got = {b: SFComm(psf, backend=b, device="cpu").reduce(tl, tr).numpy()
           for b in BACKENDS}
    np.testing.assert_array_equal(got["cuda"], wrap)
    np.testing.assert_array_equal(got["global"], wide)


def test_int8_into_int32_matches_the_reference_backends(rng):
    """The same difference in the reference: ``"pallas"`` wraps like the
    port's ``"cuda"``, ``"global"`` does not (general0)."""
    sf = FIXTURES["general0"]()
    leaf = rng.integers(60, 128, sf.nleafspace_total).astype(np.int8)
    root = np.zeros(sf.nroots_total, np.int32)
    wrap, wide = _fold_oracles(sf, leaf, root)
    assert not np.array_equal(wrap, wide)
    for ref_name, want in (("pallas", wrap), ("global", wide)):
        np.testing.assert_array_equal(np.asarray(RefComm(
            sf, backend=ref_name).reduce(jnp.asarray(leaf),
                                         jnp.asarray(root))), want)
