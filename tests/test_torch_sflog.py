"""Port parity, observability: the port's sflog registry against the
reference registry driven by the same calls — counters, events and their
tags, snapshots and deltas, ``dump_json`` and the ``log_view`` table's
shape (times differ, everything counted must not), ``sf_view`` of a star
forest and of an ``SFComm`` — and the serving engine's events and tallies
against the reference engine's on one workload."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import SFComm as RSFComm  # noqa: E402
from repro.core import sflog as RS  # noqa: E402
from repro.core.dynplan import PlanCache as RPlanCache  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving.engine import Request as RRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RServeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.core import PlanCache, SFComm  # noqa: E402
from repro_torch.core import sflog as PS  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

from sf_fixtures import FIXTURES  # noqa: E402
from torch_parity import port_sf  # noqa: E402


@pytest.fixture
def both_on():
    """Both registries on with no events; their modes restored and their
    events cleared afterwards.  Counter values are left alone: other
    modules' live counters share the registries."""
    old = RS.set_mode("on"), PS.set_mode("on")
    RS.reset()
    PS.reset()
    yield
    RS.set_mode(old[0])
    PS.set_mode(old[1])
    RS.reset()
    PS.reset()


def _script(S, out):
    """The same calls on registry ``S``; ``out`` is an event's result."""
    c = S.counter("test.parity.plain")
    c.add(3)
    u1 = S.counter("test.parity.uniq", unique=True)
    u2 = S.counter("test.parity.uniq", unique=True)
    u1.add(1)
    u2.add(2)
    before = S.events_snapshot()
    for i in range(3):
        t0 = S.op_begin()
        S.op_end("SFBcast", t0, out, nbytes=64.0 * (i + 1),
                 tags={"op": "replace", "step": i})
    with S.context(rid=7):
        with S.timed("ServePrefill", nbytes=8.0, tags={"bucket": 16}):
            pass
    for i in range(10):                     # more values than a tag map holds
        t0 = S.op_begin()
        S.op_end("SFReduce", t0, out, tags={"step": i})
    delta = S.events_delta(before)
    return {"names": (u1.name.split("#")[0], u2.name.split("#")[0],
                      int(u2.name.split("#")[1]) - int(u1.name.split("#")[1])),
            "delta": delta, "totals": S.exchange_totals(),
            "snapshot": S.events_snapshot(),
            "eff": S.overlap_efficiency("SFBcast", "SFReduce") is not None}


def _strip_times(dump):
    for ev in dump["events"].values():
        ev.pop("time_s")
    return dump


def test_registry_matches_reference(both_on):
    import jax.numpy as jnp
    mine = _script(PS, torch.zeros(3))
    theirs = _script(RS, jnp.zeros(3))
    assert mine == theirs
    pd, rd = _strip_times(PS.dump_json()), _strip_times(RS.dump_json())
    assert pd["mode"] == rd["mode"] == "on"
    assert pd["events"] == rd["events"]
    assert {k.split("#")[0]: v for k, v in pd["counters"].items()
            if k.startswith("test.")} == \
        {k.split("#")[0]: v for k, v in rd["counters"].items()
         if k.startswith("test.")}
    assert PS.dumps_json() and PS.dump_json()["events"]["SFReduce"][
        "tags"]["step"]["..."] == 2


def test_log_view_shape_matches_reference(both_on):
    import jax.numpy as jnp
    _script(PS, torch.zeros(3))
    _script(RS, jnp.zeros(3))
    mine, theirs = PS.log_view().splitlines(), RS.log_view().splitlines()
    # counter rows may differ (other modules' counters); the event table
    # up to the counters section must match in every counted column
    cut = lambda lines: lines[:lines.index("Counters:")] \
        if "Counters:" in lines else lines
    mine, theirs = cut(mine), cut(theirs)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        fa, fb = a.split(), b.split()
        if len(fa) == 7 and fa[0] in ("SFBcast", "SFReduce", "ServePrefill"):
            assert fa[:3] == fb[:3] and fa[4] == fb[4]   # name, counts, MB
        else:
            assert a == b


def test_off_mode_and_traced(both_on, monkeypatch):
    PS.set_mode("off")
    assert not PS.enabled()
    PS.op_end("SFBcast", 0.0)
    assert PS.events() == {}
    PS.set_mode("fence")
    t0 = PS.op_begin()
    PS.op_end("SFBcast", t0, {"a": [torch.ones(2)]})   # CPU: nothing to wait
    assert PS.event("SFBcast").count == 1
    # under a trace or a capture: the traced counter only
    monkeypatch.setattr(PS, "_tracing", lambda: True)
    assert PS.op_begin() == -1.0
    PS.op_end("SFBcast", -1.0)
    assert PS.event("SFBcast").traced == 1 and PS.event("SFBcast").count == 1
    with pytest.raises(ValueError, match="REPRO_SF_LOG"):
        PS.set_mode("sometimes")


def test_plan_cache_counters_match_reference():
    mine, theirs = PlanCache("t"), RPlanCache("t")
    for c in (mine, theirs):
        for key in ("a", "b", "a", "a", "c"):
            c.get_or_build(key, lambda: object())
    assert mine.stats() == theirs.stats()
    assert mine.keys() == theirs.keys() and len(mine) == 3 and "a" in mine
    assert PS.counters()[mine._c_hits.name] == 2
    mine.clear()
    assert mine.stats()["hits"] == mine.stats()["misses"] == 0


@pytest.mark.parametrize("name", ["general0", "local_only", "strided"])
def test_sf_view_matches_reference(name):
    ref_sf = FIXTURES[name]()
    sf = port_sf(ref_sf)
    assert PS.sf_view(sf) == RS.sf_view(ref_sf)
    assert PS.format_sf_view(sf) == RS.format_sf_view(ref_sf)
    mine = PS.sf_view(SFComm(sf, backend="global", device="cpu"))
    theirs = RS.sf_view(RSFComm(ref_sf, backend="global"))
    assert mine["backend"] == theirs["backend"] == "global"
    for k in theirs:
        if k not in ("plan_signature", "unit"):
            assert mine[k] == theirs[k], k


def test_engine_events_and_tallies_match_reference(both_on):
    kw = dict(dtype="float32", remat="none")
    rcfg = ref_get_config("qwen3-4b").smoke_config().scaled(**kw)
    cfg = get_config("qwen3-4b").smoke_config().scaled(**kw)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_arrays(cfg, jax.tree.map(np.asarray, rp),
                                device="cpu")
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 1]]

    def drive(S, eng, req_cls):
        reqs = [req_cls(i, p, max_new=3) for i, p in enumerate(prompts)]
        eng.run(reqs)
        snap = {n: {k: v for k, v in d.items()}
                for n, d in S.events_snapshot().items()}
        tags = {n: ev.tags for n, ev in S.events().items()}
        return eng, [r.out for r in reqs], snap, tags

    peng, pout, psnap, ptags = drive(
        PS, ServeEngine(cfg, params, batch=2, s_max=32, device="cpu",
                        ttft_slo=60.0, tpot_slo=60.0), Request)
    reng, rout, rsnap, rtags = drive(
        RS, RServeEngine(rcfg, rp, batch=2, s_max=32, ttft_slo=60.0,
                         tpot_slo=60.0), RRequest)
    assert pout == rout
    assert psnap == rsnap and ptags == rtags
    assert psnap["ServePrefill"]["count"] == 3
    for attr in ("_c_steps", "_c_tokens", "_c_ttft_n", "_c_ttft_ok",
                 "_c_tpot_n", "_c_tpot_ok"):
        assert getattr(peng, attr).value == getattr(reng, attr).value, attr
    assert peng.programs.stats() == {**reng.programs.stats(),
                                     "name": "serve-programs"}


# --------------------------------------------------------------------------
# the facade hooks: exact per-event counts and bytes on the consumer paths
# (the reference's tests/test_sflog.py), the same streams on both backends
# --------------------------------------------------------------------------
F32 = 4


def _tridiag(cls, **kw):
    """The 4-rank tridiagonal SPD matrix of the reference's sflog tests."""
    i = np.arange(64)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([np.full(64, 2.5), -np.ones(126)])
    return cls.from_global_coo(4, 64, 64, rows, cols, vals, **kw)


def test_cg_spmv_exact_counts_and_bytes(both_on):
    """Eager SpMV is one split-phase pair: count, bytes (halo edges x 4B
    f32 row) and a positive overlap window, exactly per call — the
    reference's counts, event for event."""
    import jax.numpy as jnp
    from repro.sparse.parmat import ParCSR as RParCSR
    from repro_torch.sparse import ParCSR
    A = _tridiag(ParCSR, device="cpu")
    rA = _tridiag(RParCSR)
    b = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    A.spmv(torch.as_tensor(b))
    jax.block_until_ready(rA.spmv(jnp.asarray(b)))
    PS.reset()
    RS.reset()
    for _ in range(4):
        A.spmv(torch.as_tensor(b))
        jax.block_until_ready(rA.spmv(jnp.asarray(b)))
    nb = float(A.sf.nedges_total * F32)
    d = PS.events_snapshot()
    assert d["SFBcastBegin"] == {"count": 4, "traced": 0, "bytes": 4 * nb}
    assert d["SFBcastEnd"] == {"count": 4, "traced": 0, "bytes": 4 * nb}
    assert d == RS.events_snapshot()
    assert PS.event("SFBcastEnd").overlap > 0.0
    assert PS.event("SFBcastEnd").tags["op"] == {"replace": 4}
    assert "Split-phase overlap windows" in PS.log_view()


@pytest.mark.parametrize("M", [None, "jacobi"])
def test_cg_blocking_exact_counts(both_on, M):
    """Host ``cg``: the port runs every SpMV eagerly, so each records one
    count (the initial residual's and one per iteration; the reference
    counts 1 eager and 1 traced, its step being jitted).  A preconditioner
    adds no SF event of its own here."""
    from repro_torch.solvers import cg
    from repro_torch.sparse import ParCSR
    A = _tridiag(ParCSR, device="cpu")
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(64)
                        .astype(np.float32))
    A.spmv(b)
    PS.reset()
    pre = None if M is None else (lambda r: r / 2.5)
    res = cg(A, b, tol=1e-6, maxiter=300, M=pre)
    assert res.converged and res.iters > 5
    nb = float(A.sf.nedges_total * F32)
    k = 1 + res.iters
    d = PS.events_snapshot()
    assert d["SFBcastBegin"] == {"count": k, "traced": 0, "bytes": k * nb}
    assert d["SFBcastEnd"] == {"count": k, "traced": 0, "bytes": k * nb}


def test_dmda_halo_exact_counts_and_bytes(both_on):
    """DMGlobalToLocal is one SFBcast, DMLocalToGlobal one SFReduce (halo
    edges x row bytes) — the reference's stream, bytes and all."""
    import jax.numpy as jnp
    from repro.meshdist.dmda import DMDA as RDMDA
    from repro_torch.meshdist import DMDA
    da, rda = (cls((9, 7), 4, stencil="star", width=1)
               for cls in (DMDA, RDMDA))
    g = np.random.default_rng(0).standard_normal(da.nglobal) \
        .astype(np.float32)
    lv = da.global_to_local(torch.as_tensor(g), backend="global",
                            device="cpu")
    rlv = rda.global_to_local(jnp.asarray(g), backend="global")
    PS.reset()
    RS.reset()
    for _ in range(3):
        lv = da.global_to_local(torch.as_tensor(g), backend="global",
                                device="cpu")
        rlv = rda.global_to_local(jnp.asarray(g), backend="global")
    da.local_to_global(lv, backend="global", device="cpu")
    rda.local_to_global(rlv, backend="global")
    nb = float(da.sf.nedges_total * F32)
    d = PS.events_snapshot()
    assert d["SFBcast"] == {"count": 3, "traced": 0, "bytes": 3 * nb}
    assert d["SFReduce"] == {"count": 1, "traced": 0, "bytes": nb}
    assert d == RS.events_snapshot()


@pytest.mark.parametrize("backend", ["global", "cuda"])
def test_field_bundle_multi_events_match_reference(both_on, backend):
    """``bcast_multi`` / ``reduce_multi`` record one Multi event per fused
    group (bytes: edges x fused row bytes) and the split forms one
    Begin/End pair per call, whichever way the token is completed — the
    reference's events, counts, bytes and tags."""
    import jax.numpy as jnp
    ref_sf = FIXTURES["general0"]()
    comm = SFComm(port_sf(ref_sf), backend=backend, device="cpu")
    rcomm = RSFComm(ref_sf, backend="global")
    nr, nl = ref_sf.nroots_total, ref_sf.nleafspace_total
    rng = np.random.default_rng(3)
    roots = [rng.standard_normal((nr, 3)).astype(np.float32),
             rng.integers(0, 9, nr).astype(np.int32),
             rng.standard_normal(nr).astype(np.float32)]
    leaves = [np.zeros((nl,) + a.shape[1:], a.dtype) for a in roots]

    def drive(c, conv, done):
        rf, lf = [conv(a) for a in roots], [conv(a) for a in leaves]
        done(c.bcast_multi(rf, lf))
        done(c.reduce_multi(lf, rf, "sum"))
        p = c.bcast_multi_begin(rf)
        done(c.bcast_multi_end(p, lf))
        p = c.reduce_multi_begin(lf, "sum")
        done(p.end(rf))
    drive(comm, torch.as_tensor, lambda out: None)
    drive(rcomm, jnp.asarray,
          lambda out: out and jax.block_until_ready(out))
    ne = float(ref_sf.nedges_total)
    d = PS.events_snapshot()
    # replace fuses all three (a 5-column uint32 carrier); sum fuses the
    # two f32 fields (4 columns) and moves the int32 field alone
    assert d["SFBcastMulti"] == {"count": 1, "traced": 0,
                                 "bytes": ne * 5 * F32}
    assert d["SFReduceMulti"] == {"count": 2, "traced": 0,
                                  "bytes": ne * 4 * F32 + ne * F32}
    assert d["SFBcastMultiEnd"]["count"] == 1
    assert d["SFReduceMultiEnd"]["bytes"] == ne * 5 * F32
    assert d == RS.events_snapshot()
    assert {n: e.tags for n, e in PS.events().items()} == \
        {n: e.tags for n, e in RS.events().items()}


def _event_stream(S, comm, zeros, roots, done):
    """counts+bytes the facade records for a fixed op sequence (time and
    overlap are machine-dependent and excluded)."""
    S.reset()
    leaves = zeros
    done(comm.bcast(roots, leaves, "replace"))
    done(comm.reduce(leaves + 1, roots * 0, "sum"))
    pend = comm.bcast_begin(roots, "replace")
    done(pend.end(leaves))
    pend = comm.reduce_begin(leaves + 1, "max")
    done(comm.reduce_end(pend, roots * 0))
    done(comm.fetch_and_op(roots * 0, leaves + 1, "sum"))
    done(comm.gather(leaves + 1))
    return S.events_snapshot()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_backend_event_stream_conformance(name, both_on):
    """Both port backends emit the identical event stream (names, counts,
    traced, bytes: edges x 8B for 2-wide f32 rows) for the same SF and op
    sequence, and it is the reference ``global`` backend's."""
    import jax.numpy as jnp
    ref_sf = FIXTURES[name]()
    sf = port_sf(ref_sf)
    roots = np.arange(2.0 * ref_sf.nroots_total, dtype=np.float32).reshape(
        ref_sf.nroots_total, 2)
    zeros = np.zeros((ref_sf.nleafspace_total, 2), np.float32)
    streams = {b: _event_stream(PS, SFComm(sf, backend=b, device="cpu"),
                                torch.as_tensor(zeros),
                                torch.as_tensor(roots), lambda out: None)
               for b in ("global", "cuda")}
    ref = _event_stream(RS, RSFComm(ref_sf, backend="global"),
                        jnp.asarray(zeros), jnp.asarray(roots),
                        jax.block_until_ready)
    nb = float(ref_sf.nedges_total * 2 * F32)
    assert ref["SFBcast"] == {"count": 1, "traced": 0, "bytes": nb}
    assert ref["SFReduceEnd"] == {"count": 1, "traced": 0, "bytes": nb}
    assert ref["SFFetchAndOp"]["bytes"] == 2 * nb
    for b, got in streams.items():
        assert got == ref, f"backend {b} diverged on fixture {name}"


def test_hooks_off_record_nothing_and_stash_claims_once(both_on):
    """Off: no event at all.  On: a token completed through the facade and
    then again through ``pending.end`` records one End event."""
    sf = port_sf(FIXTURES["general1"]())
    comm = SFComm(sf, backend="cuda", device="cpu")
    roots = torch.ones(sf.nroots_total)
    leaves = torch.zeros(sf.nleafspace_total)
    PS.set_mode("off")
    comm.bcast(roots, leaves)
    comm.bcast_begin(roots).end(leaves)
    assert PS.events() == {}
    PS.set_mode("on")
    pend = comm.bcast_begin(roots)
    comm.bcast_end(pend, leaves)
    pend.end(leaves)
    assert PS.event("SFBcastEnd").count == 1
    assert PS.claim_pending(pend) is None


def test_tuning_counters_match_reference(monkeypatch):
    """The autotuner keeps its counters in the sflog registry under
    ``tuning.sweeps`` / ``hits`` / ``defaults`` / ``pinned`` /
    ``candidate_errors`` in both packages, and the same autotune calls
    (a sweep, a hit, a sweep turned off, a pin) move them alike.  The
    port's ``candidate_errors`` stays 0: a raising candidate raises."""
    import jax.numpy as jnp
    from repro.kernels import tuning as RTU
    from repro_torch.kernels import tuning as PTU

    def drive(tune, cands, args):
        monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")
        for _ in range(3):                       # one sweep, two hits
            tune("k", ("swept",), cands, args, default="x", work=1)
        monkeypatch.setenv("REPRO_SF_AUTOTUNE", "0")
        tune("k", ("off",), cands, args, default="y", work=10**9)
        monkeypatch.setenv("REPRO_SF_IMPL_K", "y")
        tune("k", ("pinned",), cands, args, default="x", work=1)
        monkeypatch.delenv("REPRO_SF_IMPL_K")
        tune("k", ("pinned",), cands, args, default="x", work=1)

    def tuning_counters(S):
        return {k: v for k, v in S.counters().items()
                if k.startswith("tuning.")}

    RTU.clear_cache()
    PTU.clear_cache()
    try:
        drive(lambda kind, key, cands, args, **kw: RTU.autotune(
                  kind, key, cands, lambda: args, **kw),
              {"x": lambda a: a + 1, "y": lambda a: a * 2},
              (jnp.zeros((8,)),))
        drive(PTU.autotune, {"x": lambda a: a + 1, "y": lambda a: a * 2},
              (torch.zeros(8),))
        want = {f"tuning.{k}": v for k, v in
                {"sweeps": 1, "hits": 3, "defaults": 1, "pinned": 1,
                 "candidate_errors": 0}.items()}
        assert tuning_counters(RS) == tuning_counters(PS) == want
        assert PTU.stats() == RTU.stats()
    finally:
        RTU.clear_cache()
        PTU.clear_cache()
    assert tuning_counters(PS) == dict.fromkeys(want, 0)
