"""Port parity, setup layer: the star-forest setup, plans, reduction plans
and pattern reports of ``repro_torch`` equal the reference's bit for bit;
``to_ell`` returns the reference's arrays; the port imports neither jax nor
``repro`` and never runs on the CPU unless asked to."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import random_star_forest  # noqa: E402
from sf_fixtures import FIXTURES  # noqa: E402
from torch_parity import port_sf  # noqa: E402

from repro.core import patterns as ref_pat  # noqa: E402
from repro.core.plan import build_global_plan as ref_build_plan  # noqa: E402
from repro.core.redplan import build_reduction_plan as ref_red  # noqa: E402
from repro.sparse import csr as ref_csr  # noqa: E402

from repro_torch.core import SFComm, patterns, select_backend  # noqa: E402
from repro_torch.core.plan import build_global_plan  # noqa: E402
from repro_torch.core.redplan import build_reduction_plan  # noqa: E402
from repro_torch.sparse import csr  # noqa: E402
from repro_torch.sparse.parmat import ParCSR  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _eq(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


def _strided(s):
    return None if s is None else (s.start, s.dims, s.strides)


def _check_report(got, want):
    assert got.kind == want.kind
    assert got.permute_dst == want.permute_dst
    assert got.pair_contiguous == want.pair_contiguous
    assert {k: tuple(_strided(s) for s in v)
            for k, v in got.pair_strided.items()} == \
        {k: tuple(_strided(s) for s in v)
         for k, v in want.pair_strided.items()}
    assert (got.n_local_edges, got.n_remote_edges) == \
        (want.n_local_edges, want.n_remote_edges)


def _check_red(got, want, what):
    for f in dataclasses.fields(want):
        _eq(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")
    assert got.max_valid_seg_len == want.max_valid_seg_len
    assert got.duplicate_free == want.duplicate_free


def _check_sf(ref):
    sf = port_sf(ref)
    assert sf.root_ranks == ref.root_ranks
    assert sf.leaf_ranks == ref.leaf_ranks
    assert len(sf.pairs) == len(ref.pairs)
    for a, b in zip(sf.pairs, ref.pairs):
        for f in ("root_rank", "leaf_rank", "root_idx", "leaf_idx",
                  "edge_idx"):
            _eq(getattr(a, f), getattr(b, f), f"pair.{f}")
    for r in range(ref.nranks):
        _eq(sf.degrees(r), ref.degrees(r), f"degrees({r})")
    _eq(sf.edges_global(), ref.edges_global(), "edges_global")
    got, want = build_global_plan(sf), ref_build_plan(ref)
    for f in ("nroots", "nleafspace", "gr", "gl", "nmulti", "multi_slot",
              "degrees"):
        _eq(getattr(got, f), getattr(want, f), f"plan.{f}")
    _check_red(got.red, want.red, "plan.red")
    _check_report(got.pattern, want.pattern)
    _check_report(patterns.analyze(sf), ref_pat.analyze(ref))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_setup_and_plan_match_reference(name):
    _check_sf(FIXTURES[name]())


@pytest.mark.parametrize("seed", range(8))
def test_random_sf_setup_and_plan_match_reference(seed):
    _check_sf(random_star_forest(nranks=5, max_roots=9, max_leaves=12,
                                 seed=seed))


@pytest.mark.parametrize("seed", range(4))
def test_padded_reduction_plan_matches_reference(seed):
    """The garbage-slot form of the sort-segment machinery."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, 9, 40)
    dst[rng.random(40) < 0.3] = 9            # garbage slots
    order = rng.permutation(40) * 7
    _check_red(build_reduction_plan(dst, order, garbage=9),
               ref_red(dst, order, garbage=9), "red")


@pytest.mark.parametrize("seed", range(6))
def test_detect_strided_matches_reference(seed):
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(1, 5, 3))
    sy = dims[0] + int(rng.integers(0, 3))
    sz = sy * dims[1] + int(rng.integers(0, 3))
    idx = (int(rng.integers(0, 5)) + np.arange(dims[0])[None, None, :]
           + np.arange(dims[1])[None, :, None] * sy
           + np.arange(dims[2])[:, None, None] * sz).reshape(-1)
    for cand in (idx, idx[::-1].copy(), np.sort(rng.integers(0, 50, 12))):
        assert _strided(patterns.detect_strided(cand)) == \
            _strided(ref_pat.detect_strided(cand))


@pytest.mark.parametrize("seed", range(3))
def test_csr_and_to_ell_match_reference(seed):
    """The vectorized ``to_ell`` returns the reference loop's arrays."""
    rng = np.random.default_rng(seed)
    m, n = 23, 17
    rows, cols = rng.integers(0, m, 90), rng.integers(0, n, 90)
    vals = rng.standard_normal(90)
    rows[:5] = 3                              # one long row
    a = csr.csr_from_coo(m, n, rows, cols, vals)
    b = ref_csr.csr_from_coo(m, n, rows, cols, vals)
    for f in ("indptr", "indices", "data"):
        _eq(getattr(a, f), getattr(b, f), f"csr.{f}")
    for dt in (np.float32, np.float64):
        for x, y in zip(a.to_ell(dt), b.to_ell(dt)):
            _eq(x, y, "to_ell")
    at, bt = csr.csr_transpose(a), ref_csr.csr_transpose(b)
    for f in ("indptr", "indices", "data"):
        _eq(getattr(at, f), getattr(bt, f), f"transpose.{f}")
    np.testing.assert_array_equal(a.toarray(), b.toarray())


# ---------------------------------------------------------------- rules
def test_import_hygiene_no_jax_no_reference():
    """Every repro_torch module imports without jax or the JAX package:
    the serving slice's subpackages by name, then every module found."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.serving, repro_torch.core.sflog\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.strip()) >= 20


def test_no_silent_cpu(monkeypatch):
    """Without a card, the entry points raise unless device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sf = port_sf(FIXTURES["general0"]())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SFComm(sf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SFComm(sf, backend="cuda")
    rows = np.array([0, 1, 2, 3]); vals = np.ones(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParCSR.from_global_coo(2, 4, 4, rows, rows, vals)
    comm = SFComm(sf, device="cpu")
    assert comm.device.type == "cpu"
    # the static heuristic: the kernel backend for the general pattern on
    # the card, "global" on the CPU and for other patterns
    assert select_backend(sf) == "cuda"
    assert select_backend(sf, device="cpu") == "global"
    assert select_backend(port_sf(FIXTURES["local_only"]())) == "global"


def test_payload_device_and_type_checked():
    """A payload on another device, or not a tensor, raises: nothing is
    moved or converted silently."""
    sf = port_sf(FIXTURES["general0"]())
    for backend in ("global", "cuda"):
        comm = SFComm(sf, backend=backend, device="cpu")
        root = torch.zeros(sf.nroots_total)
        leaf = torch.zeros(sf.nleafspace_total)
        with pytest.raises(ValueError, match="move it there explicitly"):
            comm.bcast(root.to("meta"), leaf)
        with pytest.raises(TypeError, match="torch.Tensor"):
            comm.reduce(leaf.numpy(), root)
