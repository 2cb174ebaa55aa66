"""The readers of the program's spans and counters on fabricated traces: the
device's idle time under a span (split across spans, nested and
overlapping spans counted once, idle outside every span left out, nothing
without device operations or without the span) and the matvecs an
iteration from the solves' results."""

import dataclasses

import pytest

from sfbench import harness, spans

SPAN_READERS = {"idle_capture.cg": "cg.capture", "idle_loop.cg": "cg.loop",
                "idle_solve.cg": "cg.solve",
                "idle_bwd.train": "train.backward",
                "idle_optim.train": "optim.update"}
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def ctx_of(host, ops=(("k", 0.0, 10.0), ("k", 40.0, 10.0),
                      ("k", 90.0, 10.0)), window_s=100e-6):
    """Device busy 0-10, 40-50, 90-100 us: idle 10-40 and 50-90."""
    return {"ops": list(ops), "host": list(host), "window_s": window_s,
            "busy_s": 30e-6}


def test_intervals_merge_nested_and_overlapping():
    host = [("a", 0.0, 10.0), ("a", 2.0, 3.0), ("a", 8.0, 7.0),
            ("b", 0.0, 50.0), ("a", 30.0, 5.0)]
    assert spans.intervals(host, ["a"]) == [(0.0, 15.0), (30.0, 35.0)]
    assert spans.intervals(host, ["a", "b"]) == [(0.0, 50.0)]
    assert spans.overlap_us([(0.0, 15.0), (30.0, 35.0)],
                            [(10.0, 32.0)]) == 7.0


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_idle_split_across_two_spans(name):
    """One idle interval (10-40 us) half under one instance of the span
    and half under another; the other idle interval (50-90) lies outside
    every span."""
    s = SPAN_READERS[name]
    ctx = ctx_of([(s, 5.0, 20.0), (s, 25.0, 20.0), ("other", 50.0, 40.0)])
    # idle 10-25 and 25-40 under the span: 30 us of a 100 us window
    assert read(name, ctx) == pytest.approx(30.0)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_nested_and_overlapping_spans_count_once(name):
    s = SPAN_READERS[name]
    ctx = ctx_of([(s, 0.0, 100.0), (s, 15.0, 10.0), (s, 20.0, 60.0)])
    assert read(name, ctx) == pytest.approx(70.0)    # all the idle, once


def test_idle_outside_every_span_is_left_out():
    ctx = ctx_of([("cg.solve", 0.0, 12.0), ("cg.solve", 88.0, 12.0)])
    # 10-12 and 88-90 only
    assert read("idle_solve.cg", ctx) == pytest.approx(4.0)
    assert read("idle_solve.cg", ctx) <= 100.0 * (1 - 30e-6 / 100e-6)


def test_idle_before_the_first_and_after_the_last_op():
    ctx = ctx_of([("cg.capture", -20.0, 25.0), ("cg.loop", 95.0, 20.0)],
                 ops=[("k", 0.0, 100.0)])
    assert read("idle_capture.cg", ctx) == pytest.approx(20.0)
    assert read("idle_loop.cg", ctx) == pytest.approx(15.0)


def test_idle_moe_takes_the_union_of_its_four_spans():
    host = [(MOE[0], 10.0, 5.0), (MOE[1], 15.0, 5.0), (MOE[2], 12.0, 10.0),
            (MOE[3], 60.0, 10.0), ("train.forward", 0.0, 100.0)]
    assert read("idle_moe.train", ctx_of(host)) == pytest.approx(22.0)


@pytest.mark.parametrize("name", sorted(SPAN_READERS) + ["idle_moe.train"])
def test_nothing_without_ops_or_without_the_span(name):
    s = SPAN_READERS.get(name, MOE[0])
    assert read(name, ctx_of([(s, 0.0, 100.0)], ops=[])) is None
    assert read(name, {"host": [(s, 0.0, 100.0)], "window_s": 1.0}) is None
    assert read(name, ctx_of([("train.forward", 0.0, 100.0)])) is None
    assert read(name, ctx_of([])) is None


def test_relations_of_the_cg_readers():
    """Capture and loop lie inside the solve, disjoint: their idle sums to
    at most the solve's, which is at most the window's."""
    host = [("cg.solve", 5.0, 90.0), ("cg.capture", 12.0, 10.0),
            ("cg.loop", 22.0, 40.0), ("cg.flag", 30.0, 5.0)]
    ctx = ctx_of(host)
    cap, loop, solve = (read(n, ctx) for n in ("idle_capture.cg",
                                               "idle_loop.cg",
                                               "idle_solve.cg"))
    assert (cap, loop, solve) == (pytest.approx(10.0), pytest.approx(30.0),
                                  pytest.approx(70.0))
    assert cap + loop <= solve <= read("device_idle.cg", ctx)


@dataclasses.dataclass
class _Res:
    iters: int
    matvecs: int


@dataclasses.dataclass
class _OldRes:
    iters: int


def test_matvecs_per_iter_from_the_results():
    res = [_Res(545, 2 + 10 + 10 * 55), _Res(20, 2 + 10 + 10 * 2)]
    assert read("matvecs_per_iter.cg", {"result": res}) == pytest.approx(
        (562 + 32) / 565)
    from repro_torch.solvers.cg import CGResult
    got = read("matvecs_per_iter.cg",
               {"result": [CGResult(None, 10, 0.0, True, 1, 22)]})
    assert got == pytest.approx(2.2)


def test_matvecs_per_iter_nothing_without_the_counter():
    for ctx in ({}, {"result": []}, {"result": [_OldRes(500)]},
                {"result": [_Res(0, 2)]}):
        assert read("matvecs_per_iter.cg", ctx) is None
