"""The metric arithmetic on fabricated device traces: the busy time as a
union of intervals, the idle gaps, the readers, and the CG window's retake
rule."""

import json

import pytest

from sfbench import counts, harness, trace

PEAKS = harness.peaks("NVIDIA H100 80GB HBM3")


def test_union_counts_overlap_once():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0),
           ("d", 31.0, 1.0)]
    assert trace.union_us(ops) == 20.0
    assert trace.gaps_us(ops, (-5.0, 40.0)) == [(-5.0, 0.0), (15.0, 30.0),
                                                (35.0, 40.0)]


def test_chrome_trace_round_trip(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_MARK,
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "void spmv_ell_kernel<4>()",
           "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "CatArrayBatchedCopy_contig",
           "ts": 25, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 60,
           "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 35,
           "dur": 30},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    dev, host, window = trace.read_chrome_trace(p)
    assert window == (0.0, 100.0) and len(dev) == 3 and len(host) == 1
    bd = trace.breakdown(dev, host, window)
    assert bd["device_ops"][0] == ["void spmv_ell_kernel<4>()",
                                   pytest.approx(20e-6)]
    assert bd["idle_gaps"][0] == ["host", pytest.approx(35e-6)]
    assert bd["idle_gaps"][1] == ["aten::item", pytest.approx(25e-6)]
    assert trace.union_us(dev) == 30.0
    s, n = trace.kernel_seconds(dev, [r"CatArrayBatchedCopy\w*"])
    assert n == 1 and s == pytest.approx(10e-6)
    s, n = trace.kernel_seconds(dev, trace.whole_names(["spmv_ell"]))
    assert n == 0


def cg_ctx(ell_s=0.5, iters=(600, 600)):
    conf = harness.config("poisson3d-256")
    spmvs = sum(iters) + 10
    ops = [("void spmv_ell_kernel<7>(...)", 0.0, ell_s * 1e6 / spmvs)] \
        * spmvs + [("CatArrayBatchedCopy<float>", 0.0, 5.0)] * 100 \
        + [("wide_gather_kernel", 0.0, 2.0)] * 50
    return {"ops": ops, "busy_s": 0.8, "window_s": 1.0, "peaks": PEAKS,
            "config": conf,
            "program": {"iters": list(iters), "solves": len(iters),
                        "spmv_ell_launches": 16 * spmvs,
                        "ell_blocks_per_spmv": 16}}


def test_cg_readers():
    ctx = cg_ctx()
    read = lambda n: harness.metric_reader(n).read(ctx)  # noqa: E731
    assert read("cg_iters") == 600
    assert read("device_idle.cg") == pytest.approx(20.0)
    assert read("spmv_copy_ms.cg") == pytest.approx(100 * 5e-3 / 1200)
    assert read("sf_kernel_ms.cg") == pytest.approx(50 * 2e-3 / 1200)
    bound = 1210 * counts.spmv_bytes((256, 256, 256)) / 3.35e12
    assert read("spmv_ell_roofline.cg") == pytest.approx(100 * bound / 0.5)


def test_readers_return_nothing_without_their_input():
    ctx = cg_ctx()
    ctx["ops"] = []
    for name in ("spmv_copy_ms.cg", "sf_kernel_ms.cg",
                 "spmv_ell_roofline.cg", "device_idle.cg"):
        assert harness.metric_reader(name).read(ctx) is None
    ctx = cg_ctx()
    ctx["peaks"] = None
    assert harness.metric_reader("spmv_ell_roofline.cg").read(ctx) is None


def test_train_readers():
    flash = 2e-3
    ctx = {"ops": [("void flash_fwd_sm90_kernel<128>(...)", 0.0, 1e3),
                   ("flash_bwd_dq_sm90_kernel", 0.0, 1e3),
                   ("wide_gather_kernel", 0.0, 500.0),
                   ("segment_reduce_vec_kernel", 0.0, 250.0)],
           "busy_s": 0.9, "window_s": 1.0, "peaks": PEAKS,
           "program": {"steps": 1, "mfu_steps": 4, "mfu_seconds": 2.0,
                       "flops_per_step": 1e13,
                       "flash_flops_per_step": 9.89e11}}
    read = lambda n: harness.metric_reader(n).read(ctx)  # noqa: E731
    assert read("train_mfu") == pytest.approx(100 * 2e13 / 989e12)
    assert read("flash_roofline.train") == pytest.approx(
        100 * (9.89e11 / 989e12) / flash)
    assert read("moe_sf_ms.train") == pytest.approx(0.75)
    assert read("device_idle.train") == pytest.approx(10.0)


def test_kernel_names_are_the_ports():
    names = harness.kernel_names("sf_pack", "sf_unpack", "spmv_ell")
    assert {"wide_gather_kernel", "segment_reduce_vec_kernel",
            "spmv_ell_kernel"} <= set(names)


class _Counter:
    launches = 0


def test_cg_window_is_taken_again_until_whole(monkeypatch):
    """The traced CG window is retaken while the trace holds fewer
    spmv_ell launches than the program counted, and fails if no try is
    whole."""
    import torch
    drv = harness.driver("cg_solves")
    from repro_torch.kernels import ops as kops
    cell = drv.Cell(harness.config("poisson3d-256"),
                    harness.workload("poisson3d-256.cg_graph"), 1,
                    torch.device("cuda"))
    monkeypatch.setattr(drv, "RETAKE_WAITS_S", (0.0, 0.0, 0.0))
    tries = []

    def solve(n):
        kops.spmv_ell.launches += 4
        cell.iters.append(3)
        cell.converged.append(True)

    def profiled(fn, path, cuda):
        fn()
        seen = 8 if len(tries) >= 1 else 5
        tries.append(seen)
        return {"ops": [("spmv_ell_kernel", 0.0, 1.0)] * seen}

    monkeypatch.setattr(cell, "solve", solve)
    monkeypatch.setattr(drv.trace, "profiled", profiled)
    out = cell.traced(None)
    assert tries == [5, 8] and out["program"]["spmv_ell_launches"] == 8
    tries.clear()
    monkeypatch.setattr(drv.trace, "profiled",
                        lambda fn, path, cuda: (fn(), tries.append(0),
                                                {"ops": []})[2])
    with pytest.raises(RuntimeError, match="in every try"):
        cell.traced(None)
    assert len(tries) == 3
