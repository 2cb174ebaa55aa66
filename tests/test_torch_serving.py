"""Port parity, serving slice: the port's ``ServeEngine`` (on the CPU, the
flash kernel's plain version) against the reference ``ServeEngine`` on the
scenarios of ``tests/test_serving.py``, with identical float32 weights.

Greedy streams must be identical token for token.  The reference engine is
run once, over every prompt the scenarios use (a greedy stream does not
depend on its batch neighbours or its budget, as the reference's own
isolation test asserts), so the module pays for one set of jit compiles.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import loadgen as RLG  # noqa: E402
from repro.serving.engine import Request as RRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RServeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_arrays  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import loadgen as LG  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine, \
    next_pow2  # noqa: E402

BUCKET_LENS = [3, 5, 6, 7, 9, 11, 13, 17, 19, 23]
PROMPTS = sorted({(1 + i, 2, 3) for i in range(10)}
                 | {(1 + i, 2, 3 + (i % 3)) for i in range(7)}
                 | {(5, 6, 7), (3, 1, 4, 1, 5), (2, 7), (9, 8, 7)}
                 | {tuple(range(1, n + 1)) for n in BUCKET_LENS})
MAX_NEW = 8


@pytest.fixture(scope="module")
def setup():
    kw = dict(dtype="float32", remat="none")
    rcfg = ref_get_config("qwen3-4b").smoke_config().scaled(**kw)
    cfg = get_config("qwen3-4b").smoke_config().scaled(**kw)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    params = params_from_arrays(cfg, jax.tree.map(np.asarray, rp),
                                device="cpu")
    return rcfg, cfg, rp, params


@pytest.fixture(scope="module")
def ref(setup):
    """prompt -> the reference engine's greedy stream of MAX_NEW tokens."""
    rcfg, _, rp, _ = setup
    eng = RServeEngine(rcfg, rp, batch=4, s_max=64)
    reqs = [RRequest(i, list(p), max_new=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    eng.run(reqs)
    return {p: r.out for p, r in zip(PROMPTS, reqs)}


def engine(setup, **kw):
    _, cfg, _, params = setup
    kw.setdefault("batch", 2)
    return ServeEngine(cfg, params, s_max=64, device="cpu", **kw)


def with_eos(stream, eos, max_new):
    """A greedy stream as an engine with ``eos_id`` ends it: decode tokens
    (not the prefill's first token) equal to eos stop the request."""
    for j in range(1, max_new):
        if stream[j] == eos:
            return stream[:j + 1]
    return stream[:max_new]


# ------------------------------------------------ tests/test_serving.py:21-131
def test_more_requests_than_slots(setup, ref):
    eng = engine(setup, batch=4)
    reqs = [Request(i, [1 + i, 2, 3], max_new=6) for i in range(10)]
    eng.run(reqs)
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert [r.out for r in reqs] == [ref[(1 + i, 2, 3)][:6]
                                     for i in range(10)]


def test_engine_matches_direct_greedy(setup, ref):
    _, cfg, _, params = setup
    r0 = Request(99, [5, 6, 7], max_new=4)
    engine(setup).run([r0])
    lg, cache = T.prefill(params, cfg, tokens=[[5, 6, 7]], s_max=64)
    tok = torch.argmax(lg, -1)
    want = [int(tok[0])]
    for _ in range(3):
        lg, cache = T.decode_step(params, cfg, tok, cache)
        tok = torch.argmax(lg, -1)
        want.append(int(tok[0]))
    assert r0.out == want == ref[(5, 6, 7)][:4]


def test_mixed_lengths_isolated(setup, ref):
    a = Request(0, [3, 1, 4, 1, 5], max_new=5)
    b = Request(1, [2, 7], max_new=5)
    engine(setup).run([a, b])
    for req in (a, b):
        solo = Request(0, list(req.tokens), max_new=5)
        engine(setup).run([solo])
        assert solo.out == req.out == ref[tuple(req.tokens)][:5]


def test_eos_stops_early(setup, ref):
    eos = ref[(1, 2, 3)][2]
    r = Request(1, [1, 2, 3], max_new=8)
    engine(setup, eos_id=eos).run([r])
    assert r.out[-1] == eos and len(r.out) <= 8
    assert r.out == with_eos(ref[(1, 2, 3)], eos, 8)


def test_eos_mid_batch_frees_slot_others_continue(setup, ref):
    eos = ref[(1, 2, 3)][2]
    eng = engine(setup, eos_id=eos)
    early = Request(1, [1, 2, 3], max_new=8)
    longr = Request(2, [9, 8, 7], max_new=8)
    queued = Request(3, [1, 2, 3], max_new=8)      # admitted into 1's slot
    eng.run([early, longr, queued])
    assert early.done and early.out[-1] == eos and len(early.out) < 8
    assert longr.out == with_eos(ref[(9, 8, 7)], eos, 8)
    assert queued.done and queued.out == early.out


def test_slot_reuse_queue_drain_and_metrics(setup, ref):
    eng = engine(setup, ttft_slo=60.0, tpot_slo=60.0)
    reqs = [Request(i, [1 + i, 2, 3 + (i % 3)], max_new=3 + i % 2)
            for i in range(7)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert eng.queue == [] and all(s is None for s in eng.active)
    assert [r.out for r in reqs] == [ref[tuple(r.tokens)][:r.max_new]
                                     for r in reqs]
    m = eng.metrics()
    assert m["requests_finished"] == 7
    assert m["tokens_generated"] == sum(len(r.out) for r in reqs)
    assert m["decode_steps"] > 0 and m["tokens_per_sec"] > 0
    assert m["ttft_p50_s"] > 0 and m["tpot_p50_s"] > 0
    assert m["ttft_slo_attainment"] == 1.0
    assert m["program_cache"]["hits"] > 0


def test_prefill_bucketing_bounds_program_cache(setup, ref):
    eng = engine(setup)
    reqs = [Request(i, list(range(1, n + 1)), max_new=4)
            for i, n in enumerate(BUCKET_LENS)]
    eng.run(reqs)
    assert eng.metrics()["prefill_buckets"] == [4, 8, 16, 32]
    unbucketed = engine(setup, bucket_prompts=False)
    ureqs = [Request(i, list(range(1, n + 1)), max_new=4)
             for i, n in enumerate(BUCKET_LENS)]
    unbucketed.run(ureqs)
    want = [ref[tuple(r.tokens)][:4] for r in reqs]
    assert [r.out for r in reqs] == [r.out for r in ureqs] == want
    assert len(unbucketed.metrics()["prefill_buckets"]) == len(BUCKET_LENS)
    # the program cache: one miss per bucket and one for the decode program
    stats = eng.metrics()["program_cache"]
    assert stats["misses"] == 4 + 1
    assert stats["hits"] == (len(reqs) - 4) + (eng.steps - 1)


# ----------------------------------------------------------------- port's own
def test_metrics_keys_match_reference(setup):
    rcfg, _, rp, _ = setup
    keys = set(RServeEngine(rcfg, rp, batch=2, s_max=64,
                            ttft_slo=1.0, tpot_slo=1.0).metrics())
    eng = engine(setup, ttft_slo=1.0, tpot_slo=1.0)
    assert set(eng.metrics()) == keys
    assert next_pow2(1) == 1 and next_pow2(5) == 8 and next_pow2(64) == 64


def test_sampling_is_seeded(setup):
    def run(seed):
        eng = engine(setup, greedy=False, temperature=1.5, seed=seed)
        reqs = [Request(i, [1 + i, 2, 3], max_new=6) for i in range(3)]
        eng.run(reqs)
        return [r.out for r in reqs]
    first = run(3)
    assert run(3) == first
    assert run(4) != first


def test_device_and_family_checks(setup, monkeypatch):
    _, cfg, _, params = setup
    xl = get_config("xlstm-350m").smoke_config()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(xl, params, device="cpu")
    meta = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="move them there explicitly"):
        ServeEngine(cfg, meta, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)


# -------------------------------------------------------------------- loadgen
@pytest.mark.parametrize("spec", [
    dict(rate_rps=80.0, n_requests=64, seed=123),
    dict(),
    dict(rate_rps=1000.0, n_requests=16, prompt_len=(64, 1024),
         max_new=(16, 64), vocab=151936, seed=0),     # chip_smoke's serve
])
def test_trace_fingerprint_matches_reference(spec):
    mine = LG.synthesize(LG.LoadSpec(**spec))
    theirs = RLG.synthesize(RLG.LoadSpec(**spec))
    assert LG.trace_fingerprint(mine) == RLG.trace_fingerprint(theirs)
    assert dataclasses.asdict(LG.LoadSpec(**spec)) == \
        dataclasses.asdict(RLG.LoadSpec(**spec))


def test_drive_serves_a_trace(setup, ref):
    trace = LG.synthesize(LG.LoadSpec(rate_rps=500.0, n_requests=6,
                                      prompt_len=(2, 12), max_new=(2, 5),
                                      vocab=256, seed=1))
    m = LG.drive(engine(setup, batch=3), trace)
    assert m["requests_finished"] == 6
    assert all(r.done and len(r.out) == r.max_new for _, r in trace)
    assert set(m["prefill_buckets"]) <= {2, 4, 8, 16}
