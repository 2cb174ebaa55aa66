"""Port parity, the distributed SF: ``PaddedPlan`` against the reference's
``build_padded_plan`` in process, then ``DistSF`` and
``SFComm(backend="dist")`` on gloo process groups of 2 and 4 ranks against
the reference's ``SFComm(backend="global")``, its ``simulate`` oracle and
the port's ``"global"`` backend.

One spawn per world size runs every case: the children
(``torch_dist_child.py``) import only ``repro_torch``, get the graphs and
payloads as numpy arrays, join the group through a ``file://`` store in
``tmp_path`` (no port to race for) and write their results to ``.npz``
files.  Integer, bool, uint16 and replace results are bitwise; so is every
float result whose path keeps the plan's order, against the port's
``"global"``.  The allgather SF's sum-reduce (``reduce_scatter_tensor``,
the collective's own order) and float results against the reference
``"global"`` and ``simulate`` hold the reference's tolerances
(``tests/test_backends.py``: bcast 1e-5, reduce 1e-4).
"""

import multiprocessing as mp
import time
from datetime import timedelta

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_dist_child as child  # noqa: E402
from conftest import random_star_forest  # noqa: E402
from sf_fixtures import (FIXTURES, allgather_sf, general_sf,  # noqa: E402
                         permute_sf)
from torch_parity import port_sf, t  # noqa: E402

from repro.core import SFComm as RefComm  # noqa: E402
from repro.core import simulate as ref_sim  # noqa: E402
from repro.core.distributed import pad_ragged as ref_pad  # noqa: E402
from repro.core.distributed import unpad_ragged as ref_unpad  # noqa: E402
from repro.core.plan import build_padded_plan as ref_build  # noqa: E402
from repro_torch.core import (DistSF, SFComm, build_padded_plan,  # noqa: E402
                              pad_ragged, patterns, select_backend,
                              unpad_ragged)
from repro_torch.core import distributed as dmod  # noqa: E402

BUILDERS = dict(FIXTURES)
BUILDERS.update({
    "general_r2s0": lambda: general_sf(nranks=2, seed=0),
    "general_r2s1": lambda: general_sf(nranks=2, seed=1),
    "allgather_r2": lambda: allgather_sf(nranks=2),
    "permute_r2": lambda: permute_sf(nranks=2)})
CASES = [(w, name) for w, names in child.WORLDS.items() for name in names]
JOIN_TIMEOUT_S = 120
_REF = {}
# the cases also held against the reference SFComm (each a compile there);
# simulate and the port's "global" hold every case
_REF_CASES = {("f32x2x2", "sum"), ("f32x2x2", "max"), ("i32x3", "replace")}


def _ref(name):
    """(reference SF, its global comm, the port SF, the port's global
    comm), built once."""
    if name not in _REF:
        sf = BUILDERS[name]()
        psf = port_sf(sf)
        _REF[name] = (sf, RefComm(sf, backend="global"), psf,
                      SFComm(psf, backend="global", device="cpu"))
    return _REF[name]


def _payload(rng, shape, dtype: str) -> np.ndarray:
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype == "uint16":
        return rng.integers(0, 2 ** 16, shape).astype(np.uint16)
    if dtype == "int32":
        return rng.integers(-50, 50, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(dtype)


def _inputs(world: int) -> dict:
    rng = np.random.default_rng(world)
    data = {}
    for name in child.WORLDS[world]:
        sf = _ref(name)[0]
        data.update({child.key(name, k): v
                     for k, v in child.graph_arrays(sf).items()})
        nr, nl = sf.nroots_total, sf.nleafspace_total
        for pl, (unit, dtype) in child.PAYLOADS.items():
            data[child.key(name, pl, "root")] = _payload(rng, (nr,) + unit,
                                                         dtype)
            data[child.key(name, pl, "leaf")] = _payload(rng, (nl,) + unit,
                                                         dtype)
        data[child.key(name, "fetch", "root")] = _payload(rng, (nr,), "int32")
        data[child.key(name, "fetch", "leaf")] = _payload(rng, (nl,), "int32")
        data[child.key(name, "mixed", "root")] = _payload(rng, (nr,), "int32")
        data[child.key(name, "mixed", "leaf")] = rng.integers(
            60, 127, nl).astype(np.int8)
    return data


def _start(world: int, tmp):
    """Start ``world`` ranks of the child on fresh inputs."""
    data = _inputs(world)
    in_path = str(tmp / "inputs.npz")
    np.savez(in_path, **data)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=child.main,
                         args=(r, world, str(tmp / "store"), in_path,
                               str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, data


def _finish(procs, tmp, deadline: float) -> list:
    """Join the ranks by ``deadline`` (killing any left); their
    ``rank<r>.npz`` as dicts."""
    world = len(procs)
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(5)
    errs = [(tmp / f"rank{r}.err") for r in range(world)]
    msg = "\n".join(e.read_text() for e in errs if e.exists())
    assert not hung, f"{len(hung)} of {world} ranks still ran after " \
                     f"{JOIN_TIMEOUT_S} s\n{msg}"
    assert all(p.exitcode == 0 for p in procs), \
        f"exit codes {[p.exitcode for p in procs]}\n{msg}"
    outs = []
    for r in range(world):
        with np.load(tmp / f"rank{r}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn per world size, both running at once."""
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in child.WORLDS}
    started = {w: _start(w, dirs[w]) for w in child.WORLDS}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    return {w: (_finish(procs, dirs[w], deadline), data)
            for w, (procs, data) in started.items()}


def _global(outs, k):
    """A facade result: every rank's must be the same bits."""
    a = outs[0][k]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[k].view(np.uint8),
                                      a.view(np.uint8), err_msg=k)
    return a


def _bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    diff = np.flatnonzero((got.view(np.uint8) != want.view(np.uint8))
                          .reshape(got.shape[0], -1).any(1)) \
        if got.size else []
    assert len(diff) == 0, f"{what}: first row that differs {diff[0]}: " \
                           f"{got[diff[0]]} != {want[diff[0]]}"


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _reduce_scattered(name, low, kind, pl, op) -> bool:
    """The one path in the collective's own float order."""
    return (_ref(name)[0].nranks > 1 and name.startswith("allgather")
            and low == "auto" and kind == "reduce" and op == "sum"
            and pl == "f32x2x2")


# ---------------------------------------------------------------- in process
@pytest.mark.parametrize("unit", [(), (3,)])
@pytest.mark.parametrize("name", sorted(FIXTURES) + [
    f"random{s}" for s in range(5)])
def test_padded_plan_matches_reference(name, unit):
    sf = BUILDERS[name]() if name in BUILDERS else \
        random_star_forest(nranks=4, seed=int(name[6:]))
    ref, got = ref_build(sf, unit=unit), build_padded_plan(port_sf(sf),
                                                           unit=unit)
    assert got.comm_signature() == ref.comm_signature()
    for f in ("nranks", "root_pad", "leaf_pad", "P", "self_pad",
              "red_nslots", "red_Lmax", "red_dup_free", "permute_dst"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("nroots", "nleafspace", "counts", "send_root_idx",
              "recv_leaf_idx", "self_root_idx", "self_leaf_idx", "red_perm",
              "red_inv_perm", "red_dst", "red_seg_id", "red_seg_dst",
              "red_seg_start", "red_is_valid", "replace_win_src",
              "replace_win_dst", "red_seg_first", "red_seg_len"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.pattern.kind == ref.pattern.kind
    assert got.unit.shape == ref.unit.shape


def test_pad_unpad_ragged_match_reference(rng):
    parts = [rng.standard_normal((n, 3)).astype(np.float32)
             for n in (2, 0, 5)]
    want = ref_pad(parts, 6)
    got = pad_ragged([t(a) for a in parts], 6)
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(unpad_ragged(got, [2, 0, 5]),
                    ref_unpad(want, [2, 0, 5])):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one rank in this process, destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_dist_sf_errors(world1, monkeypatch):
    """A group whose size is not the SF's rank count raises; so does a
    forced lowering other than the pattern's own or "general", and a group
    that does not carry the shards' device."""
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        DistSF(port_sf(FIXTURES["general0"]()), device="cpu")
    one = port_sf(random_star_forest(nranks=1, seed=0))
    assert DistSF(one, device="cpu").lowering == "local_only"
    assert DistSF(one, device="cpu", lowering="general").lowering == \
        "general"
    with pytest.raises(ValueError, match="requested lowering 'allgather'"):
        DistSF(one, device="cpu", lowering="allgather")
    assert select_backend(one, group=world1, device="cpu") == "global"
    monkeypatch.setattr(dmod.dist, "get_backend", lambda g=None: "nccl")
    with pytest.raises(ValueError, match="nccl process group does not "
                                         "carry cpu tensors"):
        DistSF(one, device="cpu")


@pytest.mark.parametrize("low", ["auto", "general"])
@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_world1_dist_is_the_global_backends_bits(world1, seed, kernels, low,
                                                 rng):
    """One rank: ``SFComm(backend="dist")`` equals ``"global"`` bit for
    bit, every op, float payloads included (both keep the plan's order)."""
    sf = port_sf(random_star_forest(nranks=1, seed=seed, max_roots=40,
                                    max_leaves=90))
    comm = SFComm(sf, backend="dist", device="cpu", lowering=low,
                  use_kernels=kernels)
    gl = SFComm(sf, backend="global", device="cpu")
    assert comm.backend_name == "dist" and comm.backend.dist.lowering == (
        "local_only" if low == "auto" else "general")
    root = t(rng.standard_normal((sf.nroots_total, 3)).astype(np.float32))
    leaf = t(rng.standard_normal((sf.nleafspace_total, 3)).astype(np.float32))
    for op in child.OPS:
        _bits(comm.bcast(root, leaf, op), gl.bcast(root, leaf, op), op)
        _bits(comm.reduce(leaf, root, op), gl.reduce(leaf, root, op), op)
        _bits(comm.reduce_begin(leaf, op).end(root),
              gl.reduce(leaf, root, op), op)
    ri = t(rng.integers(0, 9, sf.nroots_total).astype(np.int32))
    li = t(rng.integers(0, 9, sf.nleafspace_total).astype(np.int32))
    for a, b in zip(comm.fetch_and_op(ri, li), gl.fetch_and_op(ri, li)):
        _bits(a, b, "fetch")
    _bits(comm.gather(leaf), gl.gather(leaf), "gather")
    _bits(comm.compute_degrees(), gl.compute_degrees(), "degrees")


# ------------------------------------------------------------ gloo, 2 and 4
@pytest.mark.parametrize("pl", list(child.PAYLOADS))
@pytest.mark.parametrize("world,name", CASES)
def test_dist_ops_match_reference(runs, world, name, pl):
    """bcast and reduce, every op, both lowerings, three APIs: the facade on
    every rank, its split form, the per-rank DistSF (shards joined)."""
    outs, data = runs[world]
    sf, ref, psf, gl = _ref(name)
    unit, dtype = child.PAYLOADS[pl]
    root = data[child.key(name, pl, "root")]
    leaf = data[child.key(name, pl, "leaf")]
    exact_ref = dtype != "float32"
    for op in child.ops_for(dtype):
        for kind in ("bcast", "reduce"):
            port = (gl.bcast(t(root), t(leaf), op) if kind == "bcast"
                    else gl.reduce(t(leaf), t(root), op)).numpy()
            want = (ref.bcast(jnp.asarray(root), jnp.asarray(leaf), op)
                    if kind == "bcast" else
                    ref.reduce(jnp.asarray(leaf), jnp.asarray(root), op)) \
                if (pl, op) in _REF_CASES else None
            sim = (ref_sim.bcast_ref(sf, root, leaf, op) if kind == "bcast"
                   else ref_sim.reduce_ref(sf, leaf, root, op))
            tol = 1e-5 if kind == "bcast" else 1e-4
            for low in child.LOWERINGS:
                what = child.key(name, low, kind, pl, op)
                got = _global(outs, child.key(name, low, "comm", kind, pl,
                                              op))
                if _reduce_scattered(name, low, kind, pl, op):
                    _close(got, port, tol, what)
                else:
                    _bits(got, port, what)
                for api in ("comm_split", "sf"):
                    k = child.key(name, low, api, kind, pl, op)
                    alt = _global(outs, k) if api != "sf" else \
                        np.concatenate([o[k] for o in outs])
                    _bits(alt, got, child.key(what, api))
                for w in (sim, want):
                    if w is None:
                        continue
                    if exact_ref or op == "replace":
                        _bits(got, np.asarray(w), what)
                    else:
                        _close(got, w, tol, what)


@pytest.mark.parametrize("world,name", CASES)
def test_dist_fetch_and_op_and_mixed_fold(runs, world, name):
    """fetch_and_op on int32 bitwise against the reference and simulate;
    int8 leaves summed into int32 roots fold in the leaf dtype (they wrap),
    as the port's "cuda" and the reference "pallas" do."""
    outs, data = runs[world]
    sf, ref, psf, _ = _ref(name)
    ri, li = (data[child.key(name, "fetch", s)] for s in ("root", "leaf"))
    want = [np.asarray(a) for a in ref.fetch_and_op(jnp.asarray(ri),
                                                    jnp.asarray(li))]
    for w, s in zip(ref_sim.fetch_and_op_ref(sf, ri, li), want):
        _bits(w, s, "simulate")
    cuda = SFComm(psf, backend="cuda", device="cpu")
    mr, ml = (data[child.key(name, "mixed", s)] for s in ("root", "leaf"))
    mixed = cuda.reduce(t(ml), t(mr)).numpy()
    for low in child.LOWERINGS:
        for i, side in enumerate(("root", "leaf")):
            got = _global(outs, child.key(name, low, "comm", "fetch", side))
            _bits(got, want[i], child.key(name, low, side))
            _bits(np.concatenate([o[child.key(name, low, "sf", "fetch",
                                              side)] for o in outs]),
                  got, child.key(name, low, "sf", side))
        _bits(_global(outs, child.key(name, low, "comm", "mixed")), mixed,
              child.key(name, low, "mixed"))


@pytest.mark.parametrize("name", ["general0", "general_r2s0"])
def test_dist_mixed_fold_is_the_reference_pallas_fold(runs, name):
    world = _ref(name)[0].nranks
    outs, data = runs[world]
    mr, ml = (data[child.key(name, "mixed", s)] for s in ("root", "leaf"))
    want = np.asarray(RefComm(_ref(name)[0], backend="pallas").reduce(
        jnp.asarray(ml), jnp.asarray(mr)))
    # the int8 fold wraps here: the root-dtype fold ("global") differs
    assert not np.array_equal(want, np.asarray(_ref(name)[1].reduce(
        jnp.asarray(ml), jnp.asarray(mr))))
    for low in child.LOWERINGS:
        _bits(_global(outs, child.key(name, low, "comm", "mixed")), want,
              child.key(name, low))


# the collectives each pattern's lowering issues: [all_to_all_single,
# all_gather_into_tensor, reduce_scatter_tensor, batch_isend_irecv]
_CALLS = {"general": {"bcast": [1, 0, 0, 0], "reduce": [1, 0, 0, 0],
                      "reduce_sum": [1, 0, 0, 0]},
          "allgather": {"bcast": [0, 1, 0, 0], "reduce": [1, 0, 0, 0],
                        "reduce_sum": [0, 0, 1, 0]},
          "permute": {"bcast": [0, 0, 0, 1], "reduce": [1, 0, 0, 0],
                      "reduce_sum": [1, 0, 0, 0]},
          "local_only": {"bcast": [0, 0, 0, 0], "reduce": [0, 0, 0, 0],
                         "reduce_sum": [0, 0, 0, 0]}}


@pytest.mark.parametrize("world,name", CASES)
def test_dist_lowerings_issue_their_collectives(runs, world, name):
    """Allgather: all-gather (and reduce-scatter for a sum), no all-to-all;
    permute: send and receive; local-only: no collective; general: one
    all-to-all (fetch-and-op two, none on a local-only SF)."""
    outs, _ = runs[world]
    low = str(outs[0][child.key(name, "auto", "lowering")][0])
    assert low == patterns.analyze(_ref(name)[2]).kind
    want = _CALLS[low]
    for o in outs:
        assert list(o[child.key(name, "calls", "bcast", "replace")]) == \
            want["bcast"]
        assert list(o[child.key(name, "calls", "bcast", "sum")]) == \
            want["bcast"]
        assert list(o[child.key(name, "calls", "reduce", "replace")]) == \
            want["reduce"]
        assert list(o[child.key(name, "calls", "reduce", "sum")]) == \
            want["reduce_sum"]
        assert list(o[child.key(name, "calls", "fetch")]) == (
            [0, 0, 0, 0] if low == "local_only" else [2, 0, 0, 0])
        assert str(o[child.key(name, "general", "lowering")][0]) == \
            "general"


@pytest.mark.parametrize("world,name", CASES)
def test_dist_split_sync_and_plain_keep_the_bits(runs, world, name):
    """Compute placed between begin and end, ``sync_mode=True`` and
    ``use_kernels=False`` give the fused op's bits."""
    outs, _ = runs[world]
    for o in outs:
        for kind in ("bcast", "reduce"):
            fused = o[child.key(name, "variant", "fused", kind)]
            for tag in ("split", "sync", "plain"):
                _bits(o[child.key(name, "variant", tag, kind)], fused,
                      child.key(name, tag, kind))
        assert np.isfinite(o[child.key(name, "between")])


def test_grow_overlap_on_dist_equals_global(runs):
    outs, _ = runs[4]
    for o in outs:
        for q in range(4):
            for what in ("cells", "level"):
                _bits(o[child.key("overlap", "dist", what, q)],
                      o[child.key("overlap", "global", what, q)],
                      f"{what} of rank {q}")
        assert max(o[child.key("overlap", "dist", "level", q)].max()
                   for q in range(4)) >= 1     # a halo was grown


def test_multi_field_ops_on_dist_equal_per_field_ops(runs):
    """``bcast_multi`` / ``reduce_multi`` on a pinned-unit "dist" comm (the
    fused group runs on the sibling backend) against per-field ops."""
    outs, _ = runs[4]
    for o in outs:
        for kind in ("bcast", "reduce"):
            for i in range(3):
                fused, single = o[child.key("multi", kind, i)]
                _bits(fused, single, child.key(kind, i))


def test_dist_events_name_their_backend(world1):
    """The facade's sflog events and ``sf_view`` name ``"dist"`` and the
    padded plan's signature; the split pair records its End once."""
    from repro_torch.core import sflog
    sf = port_sf(random_star_forest(nranks=1, seed=2))
    comm = SFComm(sf, backend="dist", device="cpu")
    root = torch.ones(sf.nroots_total)
    leaf = torch.zeros(sf.nleafspace_total)
    old = sflog.set_mode("on")
    try:
        sflog.reset()
        comm.bcast_begin(root).end(leaf)
        comm.reduce(leaf, root)
        ev = sflog.events()
        assert ev["SFBcastBegin"].tags["backend"] == {"dist": 1}
        assert ev["SFBcastEnd"].count == 1
        assert ev["SFReduce"].tags["backend"] == {"dist": 1}
        view = sflog.sf_view(comm)
        assert view["backend"] == "dist"
        assert repr(comm.backend.plan.comm_signature()) in str(view)
    finally:
        sflog.set_mode(old)
        sflog.reset()
