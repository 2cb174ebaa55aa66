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
