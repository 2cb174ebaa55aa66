"""Port parity, measured backend selection: ``repro_torch.core.priors`` and
``select_backend(unit=, priors=)`` against ``repro.core.priors`` and the
reference's ``select_backend``.

The reference's priors cases (``tests/test_backends.py``) are ported one to
one with ``"pallas"`` -> ``"cuda"``; then the same record lists and artifact
payloads, made from a seeded numpy generator, go through both packages'
tables (``predict_us`` bitwise, ``best_backend`` and ``select_backend``
equal under the name map).  Artifacts are written to ``tmp_path`` only.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from sf_fixtures import FIXTURES  # noqa: E402
from torch_parity import port_sf  # noqa: E402

from repro.core import priors as ref_priors  # noqa: E402
from repro.core.backend import select_backend as ref_select  # noqa: E402
from repro_torch.core import SFComm, select_backend  # noqa: E402
from repro_torch.core import priors as priors_mod  # noqa: E402
from repro_torch.core.backend import estimate_message_bytes  # noqa: E402
from repro_torch.core.priors import (PRIOR_ARTIFACTS, PriorsTable,  # noqa
                                     current_env, invalidate_priors_cache,
                                     stamp_compatible)

TO_REF = {"global": "global", "cuda": "pallas"}
TO_PORT = {v: k for k, v in TO_REF.items()}


@pytest.fixture(autouse=True)
def _fresh_priors(monkeypatch):
    """Every test starts and ends with no ``REPRO_SF_PRIORS`` and no
    memoized table."""
    monkeypatch.delenv("REPRO_SF_PRIORS", raising=False)
    invalidate_priors_cache()
    yield
    invalidate_priors_cache()


def _table(records, cls=PriorsTable):
    t = cls()
    for bk, nbytes, us in records:
        t.record(bk, nbytes, us)
    return t


def _pingpong(backends, meta):
    return {"bench": "pingpong", "unit": "us_per_call",
            "backends": backends, "meta": meta}


# ------------------------------------------ the reference's cases, ported
def test_select_backend_follows_priors():
    sf = port_sf(FIXTURES["general0"]())
    nbytes = estimate_message_bytes(sf)
    # cuda measured faster at every size -> priors must pick it
    fast_cuda = _table([("global", nbytes / 2, 100), ("global", nbytes * 2, 200),
                        ("cuda", nbytes / 2, 10), ("cuda", nbytes * 2, 20)])
    assert select_backend(sf, priors=fast_cuda) == "cuda"
    fast_global = _table([("global", nbytes / 2, 10), ("global", nbytes * 2, 20),
                          ("cuda", nbytes / 2, 100), ("cuda", nbytes * 2, 200)])
    assert select_backend(sf, priors=fast_global) == "global"


def test_select_backend_priors_crossover_uses_message_bytes():
    """The table can favour different backends at different message sizes:
    the unit argument moves the lookup point across the crossover."""
    sf = port_sf(FIXTURES["general0"]())
    small = estimate_message_bytes(sf)            # scalar f32 rows
    big = estimate_message_bytes(sf, unit=(64,))  # 64-lane rows
    t = _table([("global", small, 10), ("global", big, 300),
                ("cuda", small, 100), ("cuda", big, 30)])
    assert select_backend(sf, priors=t) == "global"
    assert select_backend(sf, priors=t, unit=(64,)) == "cuda"


def test_select_backend_single_backend_priors_fall_back():
    """A table with measurements for only one candidate is no basis for a
    choice: selection falls back to the static rule."""
    sf = port_sf(FIXTURES["general0"]())
    one = _table([("cuda", 100, 1), ("cuda", 1000, 2)])
    assert one.best_backend(500, candidates=("global", "cuda")) is None
    for device in (None, "cpu"):
        assert select_backend(sf, priors=one, device=device) == \
            select_backend(sf, priors=PriorsTable(), device=device)


def test_select_backend_hint_beats_priors():
    sf = port_sf(FIXTURES["general0"]())
    t = _table([("global", 10, 1), ("global", 1000, 1),
                ("cuda", 10, 99), ("cuda", 1000, 99)])
    assert select_backend(sf, hint="cuda", priors=t) == "cuda"


def _synthetic_gpu_env():
    return {"torch_version": "2.6.0+cu124", "cuda_version": "12.4",
            "platform": "gpu", "device_name": "NVIDIA H100 80GB HBM3",
            "device_count": 1}


@pytest.mark.parametrize("which", ["current", "gpu"])
def test_stamp_compatibility(which):
    env = current_env() if which == "current" else _synthetic_gpu_env()
    assert stamp_compatible(dict(env), env)
    assert not stamp_compatible(None, env)                  # unstamped
    assert not stamp_compatible({}, env)
    bad = dict(env); bad["platform"] = "not-a-platform"
    assert not stamp_compatible(bad, env)
    bad = dict(env); bad["torch_version"] = "0.1.99"
    assert not stamp_compatible(bad, env)
    bad = dict(env); bad["cuda_version"] = "0.1"
    assert not stamp_compatible(bad, env)
    bad = dict(env); bad["device_name"] = "another card"
    assert not stamp_compatible(bad, env)
    bad = dict(env); bad["device_count"] = int(env["device_count"]) + 7
    assert not stamp_compatible(bad, env)
    bad = dict(env); bad["device_count"] = "many"
    assert not stamp_compatible(bad, env)
    # patch-level torch / CUDA differences are fine (same major.minor)
    ok = dict(env)
    ok["torch_version"] = ".".join(
        str(env["torch_version"]).split(".")[:2]) + ".999"
    if env["cuda_version"] is not None:
        ok["cuda_version"] = ".".join(
            str(env["cuda_version"]).split(".")[:2]) + ".9"
    assert stamp_compatible(ok, env)


def test_current_env_fields():
    env = current_env()
    assert set(env) == {"torch_version", "cuda_version", "platform",
                        "device_name", "device_count"}
    assert env["torch_version"] == torch.__version__
    assert env["cuda_version"] == torch.version.cuda
    gpu = torch.cuda.is_available()
    assert env["platform"] == ("gpu" if gpu else "cpu")
    if not gpu:
        assert env["device_name"] == "cpu"


def test_priors_load_refuses_incompatible_stamp(tmp_path):
    """Artifacts from another platform / torch / card are not trusted."""
    good = _pingpong({"global": {"1024": 50.0}, "cuda": {"1024": 5.0}},
                     current_env())
    stale = json.loads(json.dumps(good))
    stale["meta"]["platform"] = "not-a-platform"
    (tmp_path / "BENCH_torch_pingpong.json").write_text(json.dumps(stale))
    assert PriorsTable.load(root=str(tmp_path)) is None
    (tmp_path / "BENCH_torch_pingpong.json").write_text(json.dumps(good))
    t = PriorsTable.load(root=str(tmp_path))
    assert t is not None and t.backends() == {"global", "cuda"}
    assert t.best_backend(1024, candidates=("global", "cuda")) == "cuda"
    assert t.meta == current_env()


@pytest.mark.parametrize("off", ["0", "false", "no"])
def test_priors_env_disable(tmp_path, monkeypatch, off):
    good = _pingpong({"global": {"512": 5.0}, "cuda": {"512": 50.0}},
                     current_env())
    (tmp_path / "BENCH_torch_pingpong.json").write_text(json.dumps(good))
    monkeypatch.setenv("REPRO_SF_PRIORS", off)
    invalidate_priors_cache()
    assert priors_mod.default_priors() is None
    # a directory path loads from there instead of the repository root
    monkeypatch.setenv("REPRO_SF_PRIORS", str(tmp_path))
    invalidate_priors_cache()
    t = priors_mod.default_priors()
    assert t is not None and t.backends() == {"global", "cuda"}
    assert t.sources == [str(tmp_path / "BENCH_torch_pingpong.json")]
    assert priors_mod.default_priors() is t       # memoized by root
    monkeypatch.delenv("REPRO_SF_PRIORS")
    invalidate_priors_cache()


def test_priors_parse_halo_grid_schema():
    obj = {"bench": "halo",
           "grids": {"8x8": {"halo_edges": 100,
                             "backends": {
                                 "global": {"unit_us": {"1": 30.0, "4": 60.0}},
                                 "cuda": {"unit_us": {"1": 10.0, "4": 20.0}},
                                 "auto": {"unit_us": {"1": 9.0}}}}}}
    t = PriorsTable()
    added = t.ingest_artifact(obj, source="test")
    assert added == 4                       # "auto" rows are not priors
    assert t.backends() == {"global", "cuda"}
    assert t.best_backend(400, candidates=("global", "cuda")) == "cuda"
    assert sorted(nb for _, nb, _ in t.records) == [400, 400, 1600, 1600]
    assert t.sources == ["test"]


def test_priors_parse_pre_sweep_halo_schema():
    """The single-grid halo schema (before the grid sweep) still parses."""
    obj = {"bench": "halo", "halo_edges": 10,
           "backends": {"global": {"unit_us": {"2": 7.0}},
                        "cuda": {"unit_us": {"2": 3.0}}}}
    t = PriorsTable()
    assert t.ingest_artifact(obj) == 2
    assert {nb for _, nb, _ in t.records} == {80.0}
    assert t.sources == []                  # no source given
    assert t.ingest_artifact({"bench": "kernels"}, source="x") == 0


def test_estimate_message_bytes_scales_with_unit():
    sf = port_sf(FIXTURES["general0"]())
    base = estimate_message_bytes(sf)
    assert base == sf.nedges_total * 4      # scalar f32 default
    assert estimate_message_bytes(sf, unit=(8,)) == base * 8


# ------------------------------------------------ against the reference
def _records(seed):
    """Seeded record lists over a few byte decades: duplicates of a size,
    non-positive entries the table must drop, and per seed a table with
    two backends (1-2), one backend (3) or none (4)."""
    r = np.random.default_rng(seed)
    names = ("global", "cuda") if seed < 3 else (("cuda",) if seed == 3
                                                   else ())
    out = []
    for bk in names:
        sizes = np.exp2(r.uniform(8, 26, size=6)).round()
        sizes = np.concatenate([sizes, sizes[:2]])       # duplicate sizes
        for nb in sizes:
            out.append((bk, float(nb), float(r.uniform(1.0, 5e4))))
    out.append(("global", 0.0, 5.0))                     # dropped
    out.append(("cuda", 1024.0, -1.0))                   # dropped
    return out


SEEDS = [0, 1, 2, 3, 4]
SWEEP = [1.0, 100.0, 255.0] + [float(2 ** k) for k in range(8, 28)] + \
    [3.3e5, 7.1e6, 1e9, 0.0, -4.0]


def _pair(records):
    port = _table(records)
    ref = _table([(TO_REF[b], nb, us) for b, nb, us in records],
                 ref_priors.PriorsTable)
    return port, ref


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_us_bitwise_reference(seed):
    port, ref = _pair(_records(seed))
    assert {TO_REF[b] for b in port.backends()} == ref.backends()
    for bk in ("global", "cuda"):
        for nb in SWEEP:
            got = port.predict_us(bk, nb)
            want = ref.predict_us(TO_REF[bk], nb)
            if want is None:
                assert got is None
            else:
                assert isinstance(got, float)
                assert np.float64(got).tobytes() == \
                    np.float64(want).tobytes(), (bk, nb)


@pytest.mark.parametrize("seed", SEEDS)
def test_best_backend_matches_reference(seed):
    port, ref = _pair(_records(seed))
    for nb in SWEEP:
        for cands in (None, ("global", "cuda"), ("cuda",)):
            got = port.best_backend(nb, candidates=cands)
            want = ref.best_backend(
                nb, candidates=None if cands is None
                else tuple(TO_REF[c] for c in cands))
            assert got == (None if want is None else TO_PORT[want])


def _artifacts(seed):
    """A pingpong and a halo payload (the reference's schema) with seeded
    timings, under both packages' backend names."""
    r = np.random.default_rng(100 + seed)
    sizes = [1024 * 4 ** k for k in range(9)]
    pp = {bk: {str(s): float(r.uniform(5, 5e4)) for s in sizes}
          for bk in ("global", "cuda")}
    grids = {}
    for g in (8, 16, 32, 64, 1024):
        series = {bk: {"unit_us": {str(u): float(r.uniform(5, 500))
                                   for u in (1, 2, 4, 8, 16)}}
                  for bk in ("global", "cuda")}
        series["auto"] = {"unit_us": {"1": 1.0}, "choice": {"1": "cuda"}}
        grids[f"{g}x{g}"] = {"grid": [g, g], "halo_edges": 8 * g,
                             "backends": series}

    def named(mp):
        return ({"bench": "pingpong",
                 "backends": {mp.get(b, b): v for b, v in pp.items()}},
                {"bench": "halo", "grids": {
                    k: dict(v, backends={mp.get(b, b): s for b, s in
                                         v["backends"].items()})
                    for k, v in grids.items()}})
    return named({}), named(TO_REF)


@pytest.mark.parametrize("seed", [0, 1])
def test_artifacts_parse_as_reference(seed):
    (pp, halo), (rpp, rhalo) = _artifacts(seed)
    port, ref = PriorsTable(), ref_priors.PriorsTable()
    assert port.ingest_artifact(pp, "pp") == ref.ingest_artifact(rpp, "pp")
    assert port.ingest_artifact(halo, "h") == ref.ingest_artifact(rhalo, "h")
    assert port.sources == ref.sources == ["pp", "h"]
    assert [(TO_REF[b], nb, us) for b, nb, us in port.records] == \
        ref.records
    for nb in SWEEP + [8 * g * u * 4 for g in (8, 1024) for u in (1, 16)]:
        for bk in ("global", "cuda"):
            got, want = port.predict_us(bk, nb), ref.predict_us(TO_REF[bk],
                                                                 nb)
            assert (got is None and want is None) or \
                np.float64(got).tobytes() == np.float64(want).tobytes()
        want = ref.best_backend(nb, candidates=("global", "pallas"))
        assert port.best_backend(nb, candidates=("global", "cuda")) == \
            (None if want is None else TO_PORT[want])


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_select_backend_matches_reference(name):
    """Every fixture x unit x table: the port's choice (on the CPU) is the
    reference's under the name map, whether the table decides or the
    static rule does."""
    ref_sf = FIXTURES[name]()
    sf = port_sf(ref_sf)
    tables = [_pair(_records(s)) for s in SEEDS]
    nb = estimate_message_bytes(sf)
    crossover = [("global", nb, 10), ("global", nb * 64, 300),
                 ("cuda", nb, 100), ("cuda", nb * 64, 30)]
    tables.append(_pair(crossover))
    tables.append((PriorsTable(), ref_priors.PriorsTable()))
    for unit in (None, (3,), (64,), 8):
        for port_t, ref_t in tables:
            want = ref_select(ref_sf, unit=unit, priors=ref_t)
            got = select_backend(sf, unit=unit, priors=port_t, device="cpu")
            assert got == TO_PORT[want], (unit, port_t.records[:2])


def test_reference_stamp_refused(tmp_path):
    """The JAX package's stamp (``jax_version``, no ``torch_version``) is
    never read as the port's priors, nor are its artifact names."""
    assert not stamp_compatible(ref_priors.current_env())
    ref_meta = dict(ref_priors.current_env(), device_name="cpu")
    assert not stamp_compatible(ref_meta)
    assert PRIOR_ARTIFACTS == ("BENCH_torch_pingpong.json",
                               "BENCH_torch_halo.json")
    assert not set(PRIOR_ARTIFACTS) & set(ref_priors.PRIOR_ARTIFACTS)
    body = {"global": {"1024": 50.0}, "cuda": {"1024": 5.0}}
    (tmp_path / "BENCH_torch_pingpong.json").write_text(
        json.dumps(_pingpong(body, ref_priors.current_env())))
    (tmp_path / "BENCH_pingpong.json").write_text(
        json.dumps(_pingpong(body, current_env())))
    assert PriorsTable.load(root=str(tmp_path)) is None


def test_static_rule_without_table(tmp_path, monkeypatch):
    """With no artifact for this environment (here an empty artifact
    directory, whatever the repository root holds) the default table is
    None and selection is the static rule."""
    monkeypatch.setenv("REPRO_SF_PRIORS", str(tmp_path))
    priors_mod.invalidate_priors_cache()
    assert priors_mod.default_priors() is None
    sf = port_sf(FIXTURES["general0"]())
    assert select_backend(sf, device="cpu") == "global"
    assert select_backend(sf) == "cuda"


def _write(root, backends, meta):
    (root / "BENCH_torch_pingpong.json").write_text(
        json.dumps(_pingpong(backends, meta)))


def test_gpu_table_not_consulted_for_cpu_sf(tmp_path, monkeypatch):
    """A card-stamped default table steers SFs on the card only: an SF
    built for the CPU keeps the static rule."""
    gpu = _synthetic_gpu_env()
    monkeypatch.setattr(priors_mod, "current_env", lambda: dict(gpu))
    sf = port_sf(FIXTURES["general0"]())
    nb = estimate_message_bytes(sf)
    _write(tmp_path, {"global": {str(nb): 5.0}, "cuda": {str(nb): 50.0}},
           gpu)
    monkeypatch.setenv("REPRO_SF_PRIORS", str(tmp_path))
    invalidate_priors_cache()
    table = priors_mod.default_priors()
    assert table is not None and table.meta["platform"] == "gpu"
    assert select_backend(sf) == "global"             # the table's choice
    assert select_backend(sf, device="cuda") == "global"
    assert select_backend(sf, device="cpu") == "global"   # static
    # the other way round: a table favouring cuda is not read for the CPU
    _write(tmp_path, {"global": {str(nb): 50.0}, "cuda": {str(nb): 5.0}},
           gpu)
    invalidate_priors_cache()
    table = priors_mod.default_priors()
    local = port_sf(FIXTURES["local_only"]())
    assert select_backend(local) == "cuda"            # the table's choice
    assert select_backend(local, device="cpu") == "global"
    assert SFComm(local, device="cpu").backend_name == "global"
    # an explicit table is used as given, whatever the device
    assert select_backend(local, device="cpu", priors=table) == "cuda"


def test_cpu_table_steers_cpu_sf(tmp_path, monkeypatch):
    """A table stamped by this (CPU) environment is consulted for SFs on
    the CPU."""
    local = port_sf(FIXTURES["local_only"]())
    nb = estimate_message_bytes(local)
    _write(tmp_path, {"global": {str(nb): 50.0}, "cuda": {str(nb): 5.0}},
           dict(current_env(), platform="cpu", device_name="cpu",
                cuda_version=None, device_count=1))
    monkeypatch.setattr(priors_mod, "current_env", lambda: {
        "torch_version": torch.__version__, "cuda_version": None,
        "platform": "cpu", "device_name": "cpu", "device_count": 1})
    monkeypatch.setenv("REPRO_SF_PRIORS", str(tmp_path))
    invalidate_priors_cache()
    assert SFComm(local, device="cpu").backend_name == "cuda"
    # the static rule would say global
    assert select_backend(local, device="cpu", priors=PriorsTable()) == \
        "global"


def test_sfcomm_passes_unit_to_lookup(tmp_path, monkeypatch):
    """``SFComm(unit=...)`` reads the default table at that unit's message
    size, across a crossover, and both choices compute the same bits."""
    monkeypatch.setattr(priors_mod, "current_env", lambda: {
        "torch_version": torch.__version__, "cuda_version": None,
        "platform": "cpu", "device_name": "cpu", "device_count": 1})
    ref_sf = FIXTURES["general0"]()
    sf = port_sf(ref_sf)
    small = estimate_message_bytes(sf)
    big = estimate_message_bytes(sf, unit=(64,))
    _write(tmp_path, {"global": {str(small): 10.0, str(big): 300.0},
                      "cuda": {str(small): 100.0, str(big): 30.0}},
           priors_mod.current_env())
    monkeypatch.setenv("REPRO_SF_PRIORS", str(tmp_path))
    invalidate_priors_cache()
    narrow = SFComm(sf, device="cpu")
    wide = SFComm(sf, device="cpu", unit=(64,))
    assert narrow.backend_name == "global"
    assert wide.backend_name == "cuda"
    r = np.random.default_rng(3)
    root = torch.as_tensor(r.standard_normal(
        (sf.nroots_total, 64)).astype(np.float32))
    leaf = torch.as_tensor(r.standard_normal(
        (sf.nleafspace_total, 64)).astype(np.float32))
    fixed = SFComm(sf, backend="global", device="cpu", unit=(64,))
    for a, b in ((wide.bcast(root, leaf), fixed.bcast(root, leaf)),
                 (wide.reduce(leaf, root), fixed.reduce(leaf, root))):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_chip_smoke_priors_phase_rehearsal(monkeypatch):
    """``chip_smoke.py``'s ``priors`` phase at a small size on the CPU:
    the choice is the argmin at every point, the written artifacts load
    and steer ``SFComm``, stamps for another card are refused, and no
    table is left behind."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    # chip_smoke's main() pins the static rule around the phase
    monkeypatch.setenv("REPRO_SF_PRIORS", "0")
    priors_mod.invalidate_priors_cache()
    sz = chip_smoke.Sizes(priors_pingpong=(1024, 4096, 16384),
                          priors_grids=((8, 8), (16, 16)),
                          priors_units=(1, 4), timing_iters=2)
    res = chip_smoke.phase_priors(sz, torch.device("cpu"))
    assert res["phase"] == "priors" and res["choice_equals_argmin"]
    assert set(res["pingpong"]["us_per_call"]) == {"global", "cuda"}
    assert sorted(res["halo"]) == ["16x16", "8x8"]
    assert res["refused"] == {"device_count": True, "device_name": True}
    assert len(res["checked_bytes"]) == 2
    assert all(v["bitwise"] == ["global", "cuda"]
               for v in res["auto"].values())
    assert priors_mod.default_priors() is None
