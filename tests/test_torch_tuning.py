"""Port parity, the kernel autotuner (``repro_torch.kernels.tuning``)
against the reference's semantics (``repro.kernels.tuning``, the knob and
cache tests of ``tests/test_tuning.py``), with stand-in candidates timed on
the host clock; the tuned entry points' candidate sets and defaults; and,
with ``REPRO_SF_AUTOTUNE=0``, every SF op over ``sf_fixtures`` bitwise what
the fixed rule gives.

Here on the CPU the entry points never sweep (every candidate is the same
plain version); the sweep under a CUDA-graph capture is a card test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import SFComm  # noqa: E402
from repro_torch.core.redplan import (build_reduction_plan,  # noqa: E402
                                      seg_block_candidates)
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels.sf_pack import pack, pack_blocked  # noqa: E402
from repro_torch.kernels.sf_unpack import (  # noqa: E402
    segment_reduce_blocked, segment_reduce_sorted)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Each test sees an empty winner cache and leaves none behind."""
    tuning.clear_cache()
    yield
    tuning.clear_cache()


def _counting_candidates(counts):
    def make(name):
        def fn(x):
            counts[name] += 1
            return x + 1
        return fn
    return {"a": make("a"), "b": make("b")}


def _args():
    return (torch.zeros(8),)


# ------------------------------------------------------------- autotune
def test_autotune_sweeps_once_then_hits(monkeypatch):
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")
    sweeps = []
    monkeypatch.setattr(tuning, "on_sweep", lambda *a: sweeps.append(a))
    counts = {"a": 0, "b": 0}
    cands = _counting_candidates(counts)
    w1 = tuning.autotune("k", ("sig",), cands, _args(), default="a", work=1)
    assert w1 in cands
    assert counts["a"] > 0 and counts["b"] > 0      # both were timed
    swept = dict(counts)
    w2 = tuning.autotune("k", ("sig",), cands, _args(), default="a", work=1)
    assert w2 == w1 and counts == swept             # a hit: no re-sweep
    st = tuning.stats()
    assert st["sweeps"] == 1 and st["hits"] == 1
    assert tuning.winners() == {("k", "sig"): w1}
    ((key, cands_seen, args, times, default, winner),) = sweeps
    assert key == ("k", "sig") and cands_seen is cands and winner == w1
    assert set(times) == {"a", "b"} and default == "a"


def test_autotune_rounds_and_iters(monkeypatch):
    """Each round times every candidate: one untimed call and ITERS timed
    ones, ROUNDS rounds interleaved."""
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")
    monkeypatch.setenv("REPRO_SF_TUNE_ITERS", "2")
    monkeypatch.setenv("REPRO_SF_TUNE_ROUNDS", "4")
    order = []
    cands = {n: (lambda x, n=n: order.append(n)) for n in ("a", "b")}
    tuning.autotune("k", ("r",), cands, _args(), default="a", work=1)
    # 4 rounds of (a x 3, b x 3), then a runoff if b won
    assert order[:24] == (["a"] * 3 + ["b"] * 3) * 4


def test_autotune_small_work_takes_default(monkeypatch):
    monkeypatch.delenv("REPRO_SF_AUTOTUNE", raising=False)
    counts = {"a": 0, "b": 0}
    w = tuning.autotune("k", ("tiny",), _counting_candidates(counts),
                        _args(), default="b", work=4)
    assert w == "b"
    assert counts == {"a": 0, "b": 0}               # nothing was timed
    assert tuning.stats()["defaults"] == 1
    w = tuning.autotune("k", ("big",), _counting_candidates(counts),
                        _args(), default="b", work=4096)
    assert tuning.stats()["sweeps"] == 1            # the gate is >= 4096


def test_autotune_disabled_env(monkeypatch):
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "0")
    counts = {"a": 0, "b": 0}
    w = tuning.autotune("k", ("big",), _counting_candidates(counts),
                        _args(), default="a", work=10**9)
    assert w == "a" and counts == {"a": 0, "b": 0}
    assert tuning.lookup(("k", "big")) == "a"       # memoized, as the ref


def test_autotune_env_pin(monkeypatch):
    monkeypatch.setenv("REPRO_SF_IMPL_K", "b")
    counts = {"a": 0, "b": 0}
    w = tuning.autotune("k", ("pinme",), _counting_candidates(counts),
                        _args(), default="a", work=10**9)
    assert w == "b" and tuning.stats()["pinned"] == 1
    assert counts == {"a": 0, "b": 0}
    monkeypatch.setenv("REPRO_SF_IMPL_K", "nope")
    with pytest.raises(ValueError, match="REPRO_SF_IMPL_K"):
        tuning.autotune("k", ("pinme2",), _counting_candidates(counts),
                        _args(), default="a", work=1)


def test_autotune_default_must_be_a_candidate():
    with pytest.raises(ValueError, match="not a candidate"):
        tuning.autotune("k", ("d",), {"a": lambda x: x}, _args(),
                        default="z")


def _scripted_times(monkeypatch, sweep, runoff):
    """Make ``_time_candidate`` return ``sweep[name]`` during the sweep's
    rounds and ``runoff[name]`` in the runoff after them."""
    calls = {"n": 0}
    rounds = 3

    def fake(fn, args, iters, device):
        calls["n"] += 1
        table = sweep if calls["n"] <= rounds * len(sweep) else runoff
        return table[fn.name]
    monkeypatch.setattr(tuning, "_time_candidate", fake)

    def named(name):
        f = lambda x: x  # noqa: E731
        f.name = name
        return f
    return {name: named(name) for name in sweep}


def test_runoff_keeps_default_on_a_tie(monkeypatch):
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")
    swept = []
    monkeypatch.setattr(tuning, "on_sweep", lambda *a: swept.append(a))
    cands = _scripted_times(monkeypatch, {"a": 1.0, "b": 0.5},
                            {"a": 1.0, "b": 1.0})
    assert tuning.autotune("k", ("tie",), cands, _args(), default="a",
                           work=1) == "a"
    assert swept[0][3] == {"a": 1.0, "b": 0.5}       # the sweep's times


def test_runoff_dethrones_default_when_confirmed(monkeypatch):
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")
    cands = _scripted_times(monkeypatch, {"a": 1.0, "b": 0.5},
                            {"a": 1.0, "b": 0.9})
    assert tuning.autotune("k", ("win",), cands, _args(), default="a",
                           work=1) == "b"


def test_raising_candidate_raises(monkeypatch):
    """Unlike the reference, which disqualifies it: every candidate is a
    hand kernel, and its error must not hide behind a sibling."""
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")

    def boom(x):
        raise RuntimeError("kernel failed")

    with pytest.raises(RuntimeError, match="kernel failed"):
        tuning.autotune("k", ("boom",), {"bad": boom, "good": lambda x: x},
                        _args(), default="good", work=1)
    assert tuning.stats()["candidate_errors"] == 0
    assert tuning.lookup(("k", "boom")) is None


def test_one_candidate_never_sweeps(monkeypatch):
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")
    counts = {"a": 0, "b": 0}
    cands = {"a": _counting_candidates(counts)["a"]}
    assert tuning.autotune("k", ("one",), cands, _args(), default="a",
                           work=10**9) == "a"
    assert counts["a"] == 0 and tuning.stats()["defaults"] == 1


def test_cpu_device_takes_default_without_sweeping(monkeypatch):
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")
    counts = {"a": 0, "b": 0}
    w = tuning.autotune("k", ("cpu",), _counting_candidates(counts),
                        _args(), default="b", work=10**9, device=CPU)
    assert w == "b" and counts == {"a": 0, "b": 0}
    assert tuning.stats() == {"sweeps": 0, "hits": 0, "defaults": 1,
                              "pinned": 0, "candidate_errors": 0}
    assert not tuning.can_sweep(CPU) and tuning.can_sweep(None)


def test_no_sweep_in_a_profiler_window(monkeypatch):
    assert not tuning._profiling()
    with torch.profiler.profile():
        assert tuning._profiling()
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
        assert not tuning.can_sweep(torch.device("cuda"))
    assert not tuning._profiling()


def test_no_sweep_under_sync_debug_or_capture(monkeypatch):
    monkeypatch.setattr(tuning, "_profiling", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 2)
    assert not tuning.can_sweep(torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    assert tuning.can_sweep(torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert not tuning.can_sweep(torch.device("cuda"))
    # a signature that cannot sweep now takes the default unmemoized
    counts = {"a": 0, "b": 0}
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "1")
    w = tuning.autotune("k", ("cap",), _counting_candidates(counts),
                        _args(), default="a", work=10**9,
                        device=torch.device("cuda"))
    assert w == "a" and counts == {"a": 0, "b": 0}
    assert tuning.lookup(("k", "cap")) is None
    assert tuning.stats()["defaults"] == 1


def test_clear_cache_empties_linked_caches():
    linked = {"x": 1}
    tuning.register_cache(linked)
    data = torch.arange(12.0).reshape(6, 2)
    K.pack_rows(data, np.array([1, 0, 5], np.int64), key=("t",))
    assert K._DISPATCH and tuning.winners()
    tuning.clear_cache()
    assert linked == {} and K._DISPATCH == {} and tuning.winners() == {}
    assert set(tuning.stats().values()) == {0}


# ------------------------------------------- tuned entry points (CPU)
def test_pack_rows_distinct_keys_tune_separately(rng):
    data = torch.as_tensor(rng.standard_normal((512, 64)).astype(np.float32))
    idx = rng.integers(0, 512, 128).astype(np.int64)
    for _ in range(3):
        K.pack_rows(data, idx, key=("plan_a",))
    K.pack_rows(data, idx, key=("plan_b",))
    keys = sorted(k[-1] for k in tuning.winners())
    assert keys == [("plan_a",), ("plan_b",)]       # per-plan cache scope
    assert tuning.stats()["defaults"] == 2 and tuning.stats()["sweeps"] == 0
    np.testing.assert_array_equal(K.pack_rows(data, idx).numpy(),
                                  data.numpy()[idx])


@pytest.mark.parametrize("unit,want", [((4,), "block:64"), ((255,), "block:64"),
                                       ((256,), "row"), ((16, 16), "row")])
def test_pack_default_is_the_fixed_rule(unit, want, rng):
    data = torch.as_tensor(rng.standard_normal((40,) + unit)
                           .astype(np.float32))
    idx = rng.integers(0, 40, 30)
    K.pack_rows(data, idx)
    ((key, winner),) = tuning.winners().items()
    assert key[0] == "pack" and winner == want
    assert want in K.pack_candidates(30)


def test_pack_candidates_are_the_hand_kernels():
    cands = K.pack_candidates(3000)
    assert sorted(cands) == ["block:128", "block:32", "block:512",
                             "block:64", "block:8", "row"]
    assert sorted(K.pack_candidates(100)) == ["block:100", "block:32",
                                              "block:64", "block:8", "row"]
    assert "xla" not in cands


@pytest.mark.parametrize("unit,want", [((3,), "block:64"), ((256,), "row")])
def test_segred_default_is_the_fixed_rule(unit, want, rng):
    lens = np.array([3, 0, 5, 1, 2, 4, 0, 7])
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    vals = torch.as_tensor(rng.standard_normal((int(lens.sum()),) + unit)
                           .astype(np.float32))
    out = K.segment_reduce_rows(vals, first, lens, op="max", key=("s",))
    ((key, winner),) = tuning.winners().items()
    assert key[0] == "segred" and winner == want
    assert key[3] == 7                              # Lmax in the signature
    for name, fn in K.segred_candidates(8, 7, "max").items():
        assert torch.equal(fn(vals, first, lens), out), name


def test_segred_candidates_follow_the_reduction_plan(rng):
    dst = rng.integers(0, 300, 2000)
    red = build_reduction_plan(dst)
    sb = red.seg_block_candidates()
    assert sb == seg_block_candidates(red.nseg, red.max_valid_seg_len)
    names = set(K.segred_candidates(red.nseg, red.max_valid_seg_len, "sum"))
    assert names == {"row"} | {f"block:{b}" for b in set(sb) | {64}}


@pytest.mark.parametrize("nseg,lmax,want", [
    (5, 3, (5,)), (300, 4, (8, 32, 128, 300)), (2000, 1, (8, 32, 128)),
    (2000, 600, (8, 32)), (2000, 10**6, (8,))])
def test_seg_block_candidates(nseg, lmax, want):
    assert seg_block_candidates(nseg, lmax) == want


def test_seg_block_candidates_match_reference(rng):
    pytest.importorskip("jax")
    from repro.core.redplan import build_reduction_plan as ref_build
    for n, hi in ((50, 10), (2000, 300), (5000, 3), (100, 100000)):
        dst = rng.integers(0, hi, n)
        garbage = hi if n % 2 else None
        if garbage is not None:
            dst[::7] = garbage
        assert build_reduction_plan(dst, garbage=garbage) \
            .seg_block_candidates() == \
            ref_build(dst, garbage=garbage).seg_block_candidates()


@pytest.mark.parametrize("unit,names", [((), {"fused", "generic"}),
                                        ((4,), {"fused", "generic"}),
                                        ((5,), {"fused"})])
def test_localbcast_candidates(unit, names, rng):
    leaf = torch.zeros((10,) + unit)
    assert set(K.localbcast_candidates(leaf)) == names
    root = torch.as_tensor(rng.standard_normal((7,) + unit)
                           .astype(np.float32))
    src = np.array([-1, 0, 6, -1, 2, 3, -1, 1, 5, 4], np.int32)
    outs = [fn(root, leaf, src) for fn in
            K.localbcast_candidates(leaf).values()]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(K.local_bcast_rows(root, leaf, src, key=("l",)),
                       outs[0])
    assert tuning.winners()[("localbcast",) + (
        (7,) + unit, (10,) + unit, "torch.float32", "torch.float32", "cpu",
        ("l",))] == "fused"


def test_dynamic_calls_make_no_cache_entry(rng):
    data = torch.as_tensor(rng.standard_normal((64, 8)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 64, 100))
    K.pack_rows(data, idx, dynamic=True)
    lens = torch.tensor([2, 3, 0, 4], dtype=torch.int32)
    first = torch.tensor([0, 2, 5, 5], dtype=torch.int32)
    K.segment_reduce_rows(data[:9], first, lens, dynamic=True)
    assert tuning.winners() == {} and K._DISPATCH == {}
    assert set(tuning.stats().values()) == {0}


def test_sweeps_put_launch_counts_back(monkeypatch):
    """A sweep's launches never reach a path's counts: ``_tuned`` restores
    every counter after ``autotune``, whatever it launched."""
    def fake_autotune(kind, sig, cands, args, *, default, work, device):
        pack.launches += 7
        segment_reduce_sorted.launches += 5
        return default
    monkeypatch.setattr(tuning, "autotune", fake_autotune)
    K.reset_launch_counts()
    data = torch.zeros(10, 3)
    K.pack_rows(data, np.arange(5))
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


# ---------------------- REPRO_SF_AUTOTUNE=0: the fixed rule, bit for bit
def _fixed_pack_rows(data, idx, *, dynamic=False, key=None):
    if K._row_elems(data) >= K.WIDE_ROW:
        return pack(data, idx, dynamic=dynamic)
    return pack_blocked(data, idx, block_rows=K.PACK_BLOCK_ROWS,
                        dynamic=dynamic)


def _fixed_segment_reduce_rows(v, f, l, *, op="sum", key=None,
                               dynamic=False):
    if K._row_elems(v) >= K.WIDE_ROW:
        return segment_reduce_sorted(v, f, l, op=op)
    return segment_reduce_blocked(v, f, l, segs_per_block=K.SEG_BLOCK, op=op)


def _fixed_local_bcast_rows(root, leaf, src, *, key=None):
    from repro_torch.kernels.sf_pack import bcast_fused
    return bcast_fused(root, leaf, src)


def _all_ops(comm, rng, unit, dtype):
    sf = comm.sf

    def pay(rows):
        a = rng.standard_normal((rows,) + unit) * 10
        return torch.as_tensor(a.astype(dtype))
    root, leaf = pay(sf.nroots_total), pay(sf.nleafspace_total)
    out = [comm.bcast(root, leaf, op) for op in ("replace", "sum")]
    out += [comm.reduce(leaf, root, op) for op in ("sum", "max", "min",
                                                   "replace")]
    if dtype == np.int32:
        out += list(comm.fetch_and_op(root, leaf, "sum"))
    return out


@pytest.mark.parametrize("unit,dtype", [((), np.float32), ((3,), np.float32),
                                        ((300,), np.float32),
                                        ((2,), np.int32)])
def test_autotune_off_is_the_fixed_rule(unit, dtype, monkeypatch):
    pytest.importorskip("jax")
    from sf_fixtures import FIXTURES
    from torch_parity import port_sf
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "0")
    for name in sorted(FIXTURES):
        comm = SFComm(port_sf(FIXTURES[name]()), backend="cuda", device=CPU)
        got = _all_ops(comm, np.random.default_rng(1), unit, dtype)
        with monkeypatch.context() as m:
            m.setattr(K, "pack_rows", _fixed_pack_rows)
            m.setattr(K, "segment_reduce_rows", _fixed_segment_reduce_rows)
            m.setattr(K, "local_bcast_rows", _fixed_local_bcast_rows)
            want = _all_ops(comm, np.random.default_rng(1), unit, dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(
                g.view(torch.int32) if g.dtype == torch.float32 else g,
                w.view(torch.int32) if w.dtype == torch.float32 else w), name
    fixed = {"pack": "row" if np.prod(unit) >= 256 else "block:64",
             "segred": "row" if np.prod(unit) >= 256 else "block:64",
             "localbcast": "fused"}
    assert tuning.winners()
    for key, winner in tuning.winners().items():
        assert winner == fixed[key[0]], key
    assert tuning.stats()["sweeps"] == 0


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_no_sweep_while_a_stream_captures():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the tuner on "
                    "the card")
    dev = torch.device("cuda")
    data = torch.randn(4096, 4, device=dev)
    idx = torch.randint(0, 4096, (8192,), device=dev, dtype=torch.int32)
    idx_np = idx.cpu().numpy()
    K.pack_rows(data, idx_np[:16])              # build + warm outside
    # the index is prepared (uploaded, its bounds read) once, outside the
    # capture, as a plan prepares its index lists at construction
    from repro_torch.kernels._index import device_index
    device_index(idx_np, data.device, "idx")
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = K.pack_rows(data, idx_np, key=("captured",))
    assert tuning.stats()["sweeps"] == 0
    assert tuning.lookup(("pack", 4096, 8192, (4,), "torch.float32",
                          "cuda", ("captured",))) is None
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, data[idx.long()])
    # eagerly the same signature sweeps once, then hits
    K.pack_rows(data, idx_np, key=("captured",))
    assert tuning.stats()["sweeps"] == 1
    K.pack_rows(data, idx_np, key=("captured",))
    assert tuning.stats()["sweeps"] == 1
