#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line and asserting as it goes:

  env      torch / CUDA versions, the card, ``nvidia-smi`` name and power
           limit, and the time to build the CUDA kernels from ``src``.
  setup    the main path's objects: a 7-point Poisson matrix on a 128^3 grid
           (2,097,152 unknowns) as ``ParCSR`` over 8 logical ranks in
           z-slabs, a random general star forest (8 ranks, 2^20 roots,
           2^22 edges), a local-only SF, a 3D-box halo SF and a wide-row SF.
  kernels  every kernel entry point against its plain PyTorch version on the
           card, at the main path's shapes and over a sweep of units, dtypes
           and ops (bitwise, except ``spmv_ell``: max|d| <= 1e-5 max|y|);
           device times of kernel (warm and with L2 scrubbed), plain
           version and one library call; both gather and both
           segment-reduce variants on wide rows.
  sf_ops   ``SFComm(backend="cuda")`` against ``SFComm(backend="global")``.
  spmv_cg  SpMV / SpMV^T against scipy in float64, then CG and CGAsync on
           the Poisson matrix through the ELL kernel.

``sf_ops`` and ``spmv_cg`` are the main path: every launch counter is set to
0 before them and read after, and each kernel must have launched there.
The line before the last two is ``{"kernels": [...]}``, then the card's
``nvidia-smi --query-gpu=name,power.limit`` line, then the result line.
Exits non-zero without a CUDA device, without the repository's ``src``, or
on any failed check.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores

REPLACES = {
    "pack": "src/repro/kernels/sf_pack.py:60",
    "pack_blocked": "src/repro/kernels/sf_pack.py:96",
    "pack_strided": "src/repro/kernels/sf_pack.py:177",
    "bcast_fused": "src/repro/kernels/sf_pack.py:141",
    "segment_reduce_sorted": "src/repro/kernels/sf_unpack.py:86",
    "segment_reduce_blocked": "src/repro/kernels/sf_unpack.py:154",
    "spmv_ell": "src/repro/kernels/spmv_ell.py:33",
}
SOURCES = {
    "pack": "src/repro_torch/kernels/csrc/sf_pack.cu",
    "pack_blocked": "src/repro_torch/kernels/csrc/sf_pack.cu",
    "pack_strided": "src/repro_torch/kernels/csrc/sf_pack.cu",
    "bcast_fused": "src/repro_torch/kernels/csrc/sf_pack.cu",
    "segment_reduce_sorted": "src/repro_torch/kernels/csrc/sf_unpack.cu",
    "segment_reduce_blocked": "src/repro_torch/kernels/csrc/sf_unpack.cu",
    "spmv_ell": "src/repro_torch/kernels/csrc/spmv_ell.cu",
}


@dataclasses.dataclass
class Sizes:
    grid: int = 128               # Poisson grid edge (grid^3 unknowns)
    nranks: int = 8
    gen_roots: int = 1 << 20      # general SF
    gen_edges: int = 1 << 22
    local_roots: int = 1 << 20    # local-only SF
    box: tuple = (100, 100, 8)    # halo box inside a grid^3 root block
    wide_roots: int = 1 << 14     # wide-row SF (unit (WIDE,))
    wide_edges: int = 1 << 16
    cg_maxiter: int = 2000
    timing_iters: int = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- helpers
def same_bits(a, b) -> bool:
    """Bitwise equality (NaN positions must match, payloads may differ)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    eq = a.contiguous().view(view) == b.contiguous().view(view)
    return bool((eq | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs(a, b) -> float:
    import torch
    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=0.0).max())


def call_ms(fn, dev, iters: int) -> float:
    """Mean milliseconds per ``fn()`` call, host overhead included: CUDA
    events around ``iters`` back-to-back calls after a warm-up (host clock
    on the CPU), with the garbage collector held off."""
    import torch
    for _ in range(2):
        fn()
    gc.collect()
    gc.disable()
    try:
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    finally:
        gc.enable()


def profiled(fn, dev):
    """(device ms by kernel name, wall ms) of one ``fn()`` under
    torch.profiler; on the CPU, no device times and the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return {}, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {e.key: e.device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.device_time_total > 0}
    return by_name, wall


def _profiled_device_ms(many, dev, exclude=frozenset()) -> float:
    """Device milliseconds torch.profiler records for one ``many()``, less
    the kernels named in ``exclude``.  The profiler now and then returns no
    device events for a window; such a window is taken again, and three
    empty windows in a row fail the run."""
    for _ in range(3):
        by_name = profiled(many, dev)[0]
        total = sum(v for k, v in by_name.items() if k not in exclude)
        if total > 0:
            return total
    raise AssertionError("torch.profiler recorded no device time")


def device_ms(fn, dev, iters: int) -> float:
    """Mean device milliseconds per ``fn()`` call: the kernel and copy
    times torch.profiler records over ``iters`` calls after a warm-up (the
    host's time per call on the CPU)."""
    if dev.type != "cuda":
        return call_ms(fn, dev, iters)
    for _ in range(2):
        fn()

    def many():
        for _ in range(iters):
            fn()
    return _profiled_device_ms(many, dev) / iters


def cold_device_ms(fn, dev, iters: int) -> float:
    """Mean device milliseconds of ``fn()``'s own kernels per call when L2
    holds none of its data: a 256 MB buffer (five times the H100's 50 MB
    L2) is read before each call, and the profiler's times for that read's
    kernels are left out (the host's time per call on the CPU)."""
    import torch
    if dev.type != "cuda":
        return call_ms(fn, dev, iters)
    scrub = torch.ones(64 << 20, dtype=torch.int32, device=dev)
    flush = lambda: scrub.sum()
    for _ in range(3):
        flush_names = frozenset(profiled(flush, dev)[0])
        if flush_names:
            break
    check(flush_names, "torch.profiler recorded no kernel of the L2 scrub")
    fn()

    def many():
        for _ in range(iters):
            flush()
            fn()
    return _profiled_device_ms(many, dev, flush_names) / iters


def bound(nbytes: float, nops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    float32 operations over the card's non-tensor float32 rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


# ------------------------------------------------------------------ setup
def poisson_coo(g: int):
    """7-point Laplacian (Dirichlet) on a g^3 grid, x fastest."""
    n = g ** 3
    idx = np.arange(n, dtype=np.int64)
    i, j, k = idx % g, (idx // g) % g, idx // (g * g)
    rows, cols, vals = [idx], [idx], [np.full(n, 6.0)]
    for coord, step in ((i, 1), (j, g), (k, g * g)):
        for sgn in (-1, 1):
            ok = (coord + sgn >= 0) & (coord + sgn < g)
            rows.append(idx[ok])
            cols.append(idx[ok] + sgn * step)
            vals.append(np.full(int(ok.sum()), -1.0))
    return n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def random_sf(nranks: int, nroots: int, nedges: int, rng, holes=0.05):
    """Random general SF: duplicate roots, leafless roots, isolated leaves,
    self and remote edges."""
    from repro_torch.core import StarForest
    per_r, per_l = nroots // nranks, nedges // nranks
    space = per_l + int(per_l * holes)
    sf = StarForest(nranks)
    for q in range(nranks):
        local = rng.permutation(space)[:per_l]
        remote = np.stack([rng.integers(0, nranks, per_l),
                           rng.integers(0, per_r, per_l)], axis=1)
        sf.set_graph(q, per_r, local, remote, nleafspace=space)
    return sf.setup()


def local_only_sf(nranks: int, nroots: int, rng):
    from repro_torch.core import StarForest
    per_r = nroots // nranks
    sf = StarForest(nranks)
    for q in range(nranks):
        remote = np.stack([np.full(per_r, q), rng.permutation(per_r)], 1)
        local = rng.permutation(per_r + per_r // 16)[:per_r]
        sf.set_graph(q, per_r, local, remote,
                     nleafspace=per_r + per_r // 16)
    return sf.setup()


def box_halo_sf(g: int, box):
    """Rank 1's leaves are a 3D box of rank 0's g^3 grid of roots."""
    from repro_torch.core import StarForest
    dx, dy, dz = box
    start = 3 + 5 * g + 7 * g * g
    offs = (start + np.arange(dx)[None, None, :]
            + np.arange(dy)[None, :, None] * g
            + np.arange(dz)[:, None, None] * g * g).reshape(-1)
    sf = StarForest(2)
    sf.set_graph(0, g ** 3, None, np.zeros((0, 2), np.int64), nleafspace=1)
    sf.set_graph(1, 0, None, np.stack([np.zeros(offs.size, np.int64), offs],
                                      1), nleafspace=offs.size)
    return sf.setup()


def phase_setup(sz: Sizes, dev, rng) -> dict:
    from repro_torch.core import build_global_plan
    from repro_torch.sparse import ParCSR
    t0 = time.perf_counter()
    n, rows, cols, vals = poisson_coo(sz.grid)
    # the default selection on the card; the kernel backend (on its plain
    # versions) when rehearsed on the CPU
    A = ParCSR.from_global_coo(sz.nranks, n, n, rows, cols, vals,
                               dtype=np.float32, device=dev,
                               backend=None if dev.type == "cuda" else "cuda")
    t_mat = time.perf_counter() - t0
    t1 = time.perf_counter()
    gen = random_sf(sz.nranks, sz.gen_roots, sz.gen_edges, rng)
    objs = {
        "A": A, "coo": (n, rows, cols, vals),
        "gen": gen, "gen_plan": build_global_plan(gen),
        "local": local_only_sf(sz.nranks, sz.local_roots, rng),
        "box": box_halo_sf(sz.grid, sz.box),
        "wide": random_sf(sz.nranks, sz.wide_roots, sz.wide_edges, rng),
    }
    t_sf = time.perf_counter() - t1
    objs["setup"] = {"phase": "setup", "unknowns": n, "nnz": int(rows.size),
                     "matrix_s": t_mat, "star_forests_s": t_sf,
                     "gen_edges": gen.nedges_total,
                     "gen_Lmax": objs["gen_plan"].red.max_valid_seg_len}
    return objs


# ---------------------------------------------------------------- kernels
def kernel_records(objs, sz: Sizes, dev) -> dict:
    """Each entry point at the main path's shapes: kernel vs plain, times,
    bound.  Returns name -> record (launches are filled in later)."""
    import torch
    from repro_torch.kernels import ops as kops, sf_pack, sf_unpack
    from repro_torch.kernels import spmv_ell as ell_mod
    from repro_torch.core import CudaBackend
    it = sz.timing_iters
    recs = {}

    def record(name, run, plain, library, nbytes, nops=0.0, tol=None):
        got, want = run(), plain()
        err = max_abs(got, want)
        if tol is None:
            check(same_bits(got, want), f"{name}: kernel != plain version")
        else:
            scale = float(want.abs().max()) if want.numel() else 0.0
            check(err <= tol * scale, f"{name}: max|d| {err} > {tol}*{scale}")
        bms, by = bound(nbytes, nops)
        recs[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": device_ms(run, dev, it),
            "ms_cold_l2": cold_device_ms(run, dev, it),
            "plain_ms": device_ms(plain, dev, it),
            "bound_ms": bms, "bound_by": by,
            "library_ms": None if library is None else
            device_ms(library, dev, it),
            "call_ms": call_ms(run, dev, it)}

    # pack_blocked: the SpMV ghost bcast's pack (x -> send buffer)
    A = objs["A"]
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(A.shape[1], generator=g, device=dev)
    be = A.comm.backend
    idx = be._k_gr
    idx64 = idx.long()
    nuniq = int(torch.unique(idx).numel())
    rb = x.element_size()
    record("pack_blocked",
           lambda: sf_pack.pack_blocked(x, idx,
                                        block_rows=kops.PACK_BLOCK_ROWS),
           lambda: sf_pack.pack_plain(x, idx),
           lambda: torch.index_select(x, 0, idx64),
           nuniq * rb + idx.numel() * (rb + 4))

    # pack / segment_reduce_sorted: the wide-row SF's bcast pack and reduce
    wide = CudaBackend(objs["wide"], device=dev)
    W = kops.WIDE_ROW
    root = torch.randn(objs["wide"].nroots_total, W, generator=g, device=dev)
    leaf = torch.randn(objs["wide"].nleafspace_total, W, generator=g,
                       device=dev)
    widx = wide._k_gr
    widx64 = widx.long()
    rb = W * 4
    record("pack", lambda: sf_pack.pack(root, widx),
           lambda: sf_pack.pack_plain(root, widx),
           lambda: torch.index_select(root, 0, widx64),
           int(torch.unique(widx).numel()) * rb + widx.numel() * (rb + 4))
    sv = sf_pack.pack_plain(leaf, wide._k_gl_sorted)
    st, ln = wide._k_seg_first, wide._k_seg_len
    S = st.numel()
    ln64 = ln.long()
    record("segment_reduce_sorted",
           lambda: sf_unpack.segment_reduce_sorted(sv, st, ln, op="sum"),
           lambda: sf_unpack.segment_reduce_plain(sv, st, ln, "sum"),
           lambda: torch.segment_reduce(sv, "sum", lengths=ln64),
           sv.numel() * 4 + S * (8 + rb))

    wide_ms = wide_row_variants(objs["wide"], wide, g, dev, it)

    # segment_reduce_blocked: the general SF's reduce (sum) unpack
    gen_be = CudaBackend(objs["gen"], plan=objs["gen_plan"], device=dev)
    gleaf = torch.randn(objs["gen"].nleafspace_total, generator=g, device=dev)
    gsv = sf_pack.pack_plain(gleaf, gen_be._k_gl_sorted)
    gst, gln = gen_be._k_seg_first, gen_be._k_seg_len
    gln64 = gln.long()
    run_seg = lambda: sf_unpack.segment_reduce_blocked(
        gsv, gst, gln, segs_per_block=kops.SEG_BLOCK, op="sum")
    record("segment_reduce_blocked", run_seg,
           lambda: sf_unpack.segment_reduce_plain(gsv, gst, gln, "sum"),
           lambda: torch.segment_reduce(gsv, "sum", lengths=gln64),
           gsv.numel() * 4 + gst.numel() * 12)
    check(same_bits(run_seg(), run_seg()), "segment reduce not bitwise "
          "identical run to run")

    # pack_strided: the box halo SF's bcast pack
    box_be = CudaBackend(objs["box"], device=dev)
    s3 = box_be._bcast_strided
    check(s3 is not None and s3.dims == tuple(sz.box),
          f"detect_strided missed the halo box: {s3}")
    broot = torch.randn(objs["box"].nroots_total, 3, generator=g, device=dev)
    rows64 = sf_pack.strided_rows(s3.start, s3.dims, s3.strides, dev)
    M = rows64.numel()
    record("pack_strided", lambda: kops.pack_strided_rows(broot, s3),
           lambda: sf_pack.pack_strided_plain(broot, s3.start, s3.dims,
                                              s3.strides),
           lambda: torch.index_select(broot, 0, rows64), M * 12 * 2)

    # bcast_fused: the local-only SF's replace bcast, f32 rows of 3
    loc_be = CudaBackend(objs["local"], device=dev)
    src = loc_be._k_src_of_leaf
    lroot = torch.randn(objs["local"].nroots_total, 3, generator=g,
                        device=dev)
    lleaf = torch.randn(objs["local"].nleafspace_total, 3, generator=g,
                        device=dev)
    Nl, E = lleaf.shape[0], objs["local"].nedges_total
    record("bcast_fused", lambda: sf_pack.bcast_fused(lroot, lleaf, src),
           lambda: sf_pack.bcast_fused_plain(lroot, lleaf, src), None,
           Nl * 4 + Nl * 12 + E * 12 + (Nl - E) * 12)

    # spmv_ell: rank 0's diagonal block of the Poisson matrix
    blk = A._diag_ell[0]
    xz = torch.cat([x[: blk.n], x.new_zeros(1)])
    N, K = blk.data.shape
    nnz = int((blk.cols < blk.n).sum())
    csr = torch.sparse_csr_tensor(*_csr_of(blk), size=(N, blk.n + 1),
                                  device=dev)
    record("spmv_ell", lambda: ell_mod.spmv_ell(blk.data, blk.cols, xz),
           lambda: ell_mod.spmv_ell_plain(blk.data, blk.cols, xz),
           lambda: torch.mv(csr, xz),
           N * K * 8 + (blk.n + 1) * 4 + N * 4, 2.0 * nnz, tol=1e-5)
    return recs, wide_ms


def wide_row_variants(sf, be, g, dev, it: int) -> dict:
    """Device ms of both gather and both segment-reduce variants on the
    wide-row SF's bcast pack and reduce, at f32 rows of 64, 256 and 1024
    elements: the readings behind ``kernels/ops.py``'s ``WIDE_ROW``.  Each
    variant is timed twice, in turns with the others."""
    import torch
    from repro_torch.kernels import ops as kops, sf_pack, sf_unpack
    idx, st, ln = be._k_gr, be._k_seg_first, be._k_seg_len
    out = {}
    for w in (64, 256, 1024):
        root = torch.randn(sf.nroots_total, w, generator=g, device=dev)
        leaf = torch.randn(sf.nleafspace_total, w, generator=g, device=dev)
        sv = sf_pack.pack_plain(leaf, be._k_gl_sorted)
        runs = {
            "pack": lambda: sf_pack.pack(root, idx),
            "pack_blocked": lambda: sf_pack.pack_blocked(
                root, idx, block_rows=kops.PACK_BLOCK_ROWS),
            "segment_reduce_sorted": lambda: sf_unpack.segment_reduce_sorted(
                sv, st, ln, op="sum"),
            "segment_reduce_blocked": lambda: sf_unpack.segment_reduce_blocked(
                sv, st, ln, segs_per_block=kops.SEG_BLOCK, op="sum")}
        check(same_bits(runs["pack"](), runs["pack_blocked"]()),
              f"pack variants differ at width {w}")
        check(same_bits(runs["segment_reduce_sorted"](),
                        runs["segment_reduce_blocked"]()),
              f"segment reduce variants differ at width {w}")
        ms = {k: [] for k in runs}
        for _ in range(2):
            for k, f in runs.items():
                ms[k].append(device_ms(f, dev, it))
        out[str(w)] = ms
    return out


def _csr_of(blk):
    """(crow, col, values) of an ELL block without its padding."""
    import torch
    keep = blk.cols < blk.n
    counts = keep.sum(1)
    crow = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                       device=counts.device)
    crow[1:] = torch.cumsum(counts, 0)
    return crow, blk.cols64[keep], blk.data[keep]


def kernel_sweep(dev) -> int:
    """Small shapes over units, dtypes and ops, kernel vs plain bitwise
    (spmv_ell to 1e-5 max|y|).  Returns the number of cases."""
    import torch
    from repro_torch.kernels import sf_pack, sf_unpack, spmv_ell as em
    rng = np.random.default_rng(7)
    cases = 0
    dtypes = [torch.float32, torch.float64, torch.int32, torch.bfloat16]

    def rand(shape, dt):
        a = torch.as_tensor(rng.standard_normal(shape), device=dev)
        if dt == torch.int32:
            a = a * 1000
        return a.to(dt)

    for unit in [(), (3,), (2, 2)]:
        for dt in dtypes + [torch.int8, torch.bool]:
            data = rand((1000,) + unit, dt) if dt != torch.bool else \
                torch.as_tensor(rng.random((1000,) + unit) > .5, device=dev)
            idx = torch.as_tensor(rng.integers(0, 1000, 777), device=dev)
            want = sf_pack.pack_plain(data, idx)
            # data[1:] starts off the 16-byte alignment: narrower words
            sub, sidx = data[1:], idx[idx < 999]
            for got, ref in (
                    (sf_pack.pack(data, idx), want),
                    (sf_pack.pack_blocked(data, idx, block_rows=64), want),
                    (sf_pack.pack_blocked(data, idx, block_rows=5), want),
                    (sf_pack.pack_blocked(sub, sidx, block_rows=64),
                     sf_pack.pack_plain(sub, sidx))):
                check(same_bits(got, ref), f"pack {unit} {dt}")
                cases += 1
            for dims, strides, start in [((4, 3, 2), (1, 8, 48), 2),
                                         ((8, 1, 1), (1, 8, 8), 0),
                                         ((2, 5, 4), (1, 16, 80), 7)]:
                got = sf_pack.pack_strided(data, start=start, dims=dims,
                                           strides=strides, block_rows=3)
                check(same_bits(got, sf_pack.pack_strided_plain(
                    data, start, dims, strides)), f"pack_strided {dt}")
                cases += 1
            leaf = rand((600,) + unit, dt) if dt != torch.bool else \
                torch.zeros((600,) + unit, dtype=torch.bool, device=dev)
            src = np.full(600, -1, np.int32)
            hit = rng.permutation(600)[:400]
            src[hit] = rng.integers(0, 1000, 400)
            src = torch.as_tensor(src, device=dev)
            check(same_bits(sf_pack.bcast_fused(data, leaf, src),
                            sf_pack.bcast_fused_plain(data, leaf, src)),
                  f"bcast_fused {unit} {dt}")
            cases += 1
    fl = [torch.float32, torch.float64, torch.bfloat16]
    for rdt in fl:
        for ldt in fl:
            if rdt == ldt:
                continue
            root, leaf = rand((1000, 3), rdt), rand((600, 3), ldt)
            check(same_bits(sf_pack.bcast_fused(root, leaf, src),
                            sf_pack.bcast_fused_plain(root, leaf, src)),
                  f"bcast_fused cast {rdt}->{ldt}")
            cases += 1
    # segment reduce: zero-length segments, a NaN row for max/min
    M, S = 3000, 700
    lens = rng.integers(0, 9, S)
    lens[:5] = 0
    lens[10] = 4
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    check(int(lens.sum()) <= M, "sweep segments exceed buffer")
    st = torch.as_tensor(starts, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    for unit in [(), (3,), (2, 2)]:
        for dt in dtypes:
            for op in ["sum", "prod", "max", "min"]:
                buf = rand((M,) + unit, dt)
                if op == "prod" and dt.is_floating_point:
                    buf = (1 + 0.05 * buf.float()).to(dt)
                if op in ("max", "min") and dt.is_floating_point:
                    buf[int(starts[10]) + 1] = float("nan")
                want = sf_unpack.segment_reduce_plain(buf, st, ln, op)
                for got in (sf_unpack.segment_reduce_sorted(buf, st, ln,
                                                            op=op),
                            sf_unpack.segment_reduce_blocked(
                                buf, st, ln, segs_per_block=64, op=op),
                            sf_unpack.segment_reduce_blocked(
                                buf, st, ln, segs_per_block=7, op=op)):
                    check(same_bits(got, want),
                          f"segment reduce {op} {unit} {dt}")
                    cases += 1
                if op in ("max", "min") and dt.is_floating_point:
                    check(bool(torch.isnan(want[10]).all()),
                          "NaN did not propagate")
    for N, K, Nx in [(50, 7, 40), (256, 16, 300), (8, 1, 8)]:
        for dt in (torch.float32, torch.float64):
            data = rand((N, K), dt)
            cols = torch.as_tensor(rng.integers(0, Nx, (N, K)), device=dev)
            x = rand((Nx + 1,), dt)
            got, want = em.spmv_ell(data, cols, x), em.spmv_ell_plain(
                data, cols, x)
            check(max_abs(got, want) <= 1e-5 * float(want.abs().max()),
                  f"spmv_ell {N} {K} {dt}")
            cases += 1
    return cases


# ----------------------------------------------------------------- sf_ops
def phase_sf_ops(objs, dev) -> dict:
    import torch
    from repro_torch.core import SFComm, select_backend
    from repro_torch.kernels import ops as kops
    g = torch.Generator(device=dev).manual_seed(2)
    out = {"phase": "sf_ops"}

    def close(a, b, what):
        check(a.shape == b.shape, f"{what}: shapes {a.shape} {b.shape}")
        if a.dtype.is_floating_point:
            scale = float(b.abs().max()) if b.numel() else 0.0
            err = max_abs(a, b)
            check(err <= 1e-6 * scale, f"{what}: max|d| {err} vs {scale}")
        else:
            check(torch.equal(a, b), what)

    def bits(a, b, what):
        check(same_bits(a, b), f"{what}: cuda != global")

    sf, plan = objs["gen"], objs["gen_plan"]
    cu = SFComm(sf, backend="cuda", device=dev, plan=plan)
    gl = SFComm(sf, backend="global", device=dev, plan=plan)
    check(select_backend(sf, device=dev) == "cuda" or dev.type != "cuda",
          "select_backend did not pick cuda for the general SF")
    check(plan.red.max_valid_seg_len > 1, "general SF has no repeated root")
    on_card = dev.type == "cuda"
    before = kops.launch_counts()
    for unit in [(), (3,)]:
        root = torch.randn((sf.nroots_total,) + unit, generator=g, device=dev)
        leaf = torch.randn((sf.nleafspace_total,) + unit, generator=g,
                           device=dev)
        for op in ["replace", "sum"]:
            bits(cu.bcast(root, leaf, op), gl.bcast(root, leaf, op),
                 f"bcast {op} {unit}")
        pend = cu.bcast_begin(root)
        bits(pend.end(leaf), gl.bcast(root, leaf), f"bcast begin/end {unit}")
        bits(cu.bcast_end(cu.bcast_begin(root, "sum"), leaf),
             gl.bcast(root, leaf, "sum"), f"bcast_end {unit}")
        close(cu.reduce(leaf, root, "sum"), gl.reduce(leaf, root, "sum"),
              f"reduce sum {unit}")
        for op in ["max", "replace"]:
            bits(cu.reduce(leaf, root, op), gl.reduce(leaf, root, op),
                 f"reduce {op} {unit}")
        multi = cu.gather(leaf)
        bits(multi, gl.gather(leaf), f"gather {unit}")
        bits(cu.scatter(multi, leaf), gl.scatter(multi, leaf),
             f"scatter {unit}")
    ri = torch.randint(0, 100, (sf.nroots_total,), generator=g, device=dev,
                       dtype=torch.int32)
    li = torch.randint(0, 100, (sf.nleafspace_total,), generator=g,
                       device=dev, dtype=torch.int32)
    for a, b in zip(cu.fetch_and_op(ri, li), gl.fetch_and_op(ri, li)):
        bits(a, b, "fetch_and_op")
    deg = cu.compute_degrees()
    bits(deg, gl.compute_degrees(), "compute_degrees")
    check(np.array_equal(deg.cpu().numpy(), plan.degrees), "degrees")
    moved = {k for k, v in kops.launch_counts().items() if v > before[k]}
    check(not on_card or {"pack_blocked", "segment_reduce_blocked"} <= moved,
          f"general SF ops launched only {sorted(moved)}")

    # local-only SF: the replace bcast goes through the fused kernel
    loc = objs["local"]
    lcu = SFComm(loc, backend="cuda", device=dev)
    lgl = SFComm(loc, backend="global", device=dev)
    before = kops.bcast_fused.launches
    root = torch.randn(loc.nroots_total, 3, generator=g, device=dev)
    leaf = torch.randn(loc.nleafspace_total, 3, generator=g, device=dev)
    bits(lcu.bcast(root, leaf), lgl.bcast(root, leaf), "local bcast")
    leaf16 = leaf.to(torch.bfloat16)
    bits(lcu.bcast(root, leaf16), lgl.bcast(root, leaf16),
         "local bcast f32->bf16")
    check(kops.bcast_fused.launches == before + 2 or not on_card,
          "local-only bcast did not take bcast_fused")

    # 3D-box halo SF: detect_strided routes both packs to pack_strided
    box = objs["box"]
    bcu = SFComm(box, backend="cuda", device=dev)
    bgl = SFComm(box, backend="global", device=dev)
    check(bcu.backend._bcast_strided is not None
          and bcu.backend._reduce_strided is not None,
          "detect_strided did not match the halo box")
    before = kops.pack_strided.launches
    for unit in [(), (3,)]:
        root = torch.randn((box.nroots_total,) + unit, generator=g,
                           device=dev)
        leaf = torch.randn((box.nleafspace_total,) + unit, generator=g,
                           device=dev)
        bits(bcu.bcast(root, leaf), bgl.bcast(root, leaf), f"box bcast {unit}")
        bits(bcu.reduce(leaf, root, "sum"), bgl.reduce(leaf, root, "sum"),
             f"box reduce {unit}")
    check(kops.pack_strided.launches == before + 4 or not on_card,
          "halo box packs did not take pack_strided")

    # wide rows: one row / one segment per CTA
    wide = objs["wide"]
    wcu = SFComm(wide, backend="cuda", device=dev)
    wgl = SFComm(wide, backend="global", device=dev)
    W = kops.WIDE_ROW
    root = torch.randn(wide.nroots_total, W, generator=g, device=dev)
    leaf = torch.randn(wide.nleafspace_total, W, generator=g, device=dev)
    before = kops.launch_counts()
    bits(wcu.bcast(root, leaf), wgl.bcast(root, leaf), "wide bcast")
    close(wcu.reduce(leaf, root, "sum"), wgl.reduce(leaf, root, "sum"),
          "wide reduce sum")
    moved = {k for k, v in kops.launch_counts().items() if v > before[k]}
    check(not on_card or moved == {"pack", "segment_reduce_sorted"},
          f"wide-row ops launched {sorted(moved)}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["checks"] = "bitwise except float sums (max|d| <= 1e-6 max|y|)"
    return out


# ---------------------------------------------------------------- spmv_cg
def phase_spmv_cg(objs, sz: Sizes, dev) -> dict:
    import scipy.sparse as sp
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.solvers import cg, cg_async
    A = objs["A"]
    n, rows, cols, vals = objs["coo"]
    check(A.comm.backend_name == "cuda" or dev.type != "cuda",
          f"select_backend picked {A.comm.backend_name!r}, not 'cuda'")
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    rng = np.random.default_rng(3)
    xh = rng.standard_normal(n).astype(np.float32)
    x = torch.as_tensor(xh, device=dev)
    want = S @ xh.astype(np.float64)
    wantT = S.T @ xh.astype(np.float64)
    errs = {}
    for name, got, ref in [
            ("spmv_kernel", A.spmv(x, use_kernel=True), want),
            ("spmv_plain", A.spmv(x), want),
            ("spmv_transpose", A.spmv_transpose(x), wantT)]:
        err = float(np.abs(got.double().cpu().numpy() - ref).max())
        check(err <= 1e-5 * np.abs(ref).max(), f"{name}: max|d| {err}")
        errs[name] = err

    bh = rng.standard_normal(n).astype(np.float32)
    b = torch.as_tensor(bh, device=dev)
    mv = lambda v: A.spmv(v, use_kernel=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    before = kops.launch_counts()
    gc.collect()
    sync()
    t0 = time.perf_counter()
    res = cg(mv, b, tol=1e-5, maxiter=sz.cg_maxiter)
    sync()
    t_cg = time.perf_counter() - t0
    per_it = {k: (v - before[k]) / max(res.iters, 1)
              for k, v in kops.launch_counts().items() if v != before[k]}
    xs = res.x.double().cpu().numpy()
    true_rel = float(np.linalg.norm(bh - S @ xs) / np.linalg.norm(bh))
    check(res.converged, f"cg did not converge in {res.iters} iterations")
    check(true_rel <= 1e-4, f"cg true relative residual {true_rel}")
    check(bool(torch.isfinite(res.x).all()), "cg x not finite")

    sync()
    t0 = time.perf_counter()
    ares = cg_async(mv, b, tol=1e-5, maxiter=50, check_every=0)
    sync()
    t_async = time.perf_counter() - t0
    check(ares.iters == 50, f"cg_async(check_every=0) ran {ares.iters}")
    check(bool(torch.isfinite(ares.x).all()), "cg_async x not finite")

    # where a CG iteration's time goes: 20 iterations under the profiler
    ell0 = kops.spmv_ell.launches
    by_name, wall = profiled(
        lambda: cg_async(mv, b, maxiter=20, check_every=0), dev)
    busy = sum(by_name.values())
    # spmv_ell on the main path, where one SpMV's 16 blocks (about 130 MB)
    # stream through the 50 MB L2, against the byte bound of those blocks
    ell_launches = kops.spmv_ell.launches - ell0
    ell_ms = sum(v for k, v in by_name.items() if "spmv_ell_kernel" in k)
    spmv_bytes = sum(blk.data.numel() * 8 + (blk.n + 1) * 4
                     + blk.data.shape[0] * 4
                     for blk in A._diag_ell + A._offd_ell)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"phase": "spmv_cg", "backend": A.comm.backend_name,
            "unknowns": n, "spmv_max_abs_err": errs,
            "cg_iters": res.iters, "cg_true_rel_residual": true_rel,
            "cg_ms_per_iter": t_cg * 1e3 / max(res.iters, 1),
            "cg_launches_per_iter": per_it,
            "cg_async_iters": ares.iters,
            "cg_async_ms_per_iter": t_async * 1e3 / ares.iters,
            "profiled_20_iters": {
                "wall_ms": wall, "device_ms": busy,
                "device_idle_share": 1.0 - busy / wall if wall else None,
                "spmv_ell_launches": ell_launches,
                "spmv_ell_ms": ell_ms,
                "spmv_ell_bound_ms": bound(spmv_bytes)[0]
                * ell_launches / len(A._diag_ell + A._offd_ell),
                "top_kernels_ms": {k[:60]: v for k, v in top}}}


# ------------------------------------------------------------------- main
def run(dev, sz: Sizes) -> list:
    """All phases on ``dev``; returns the kernel records."""
    import torch
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(0)
    objs = phase_setup(sz, dev, rng)
    emit(objs["setup"])

    t0 = time.perf_counter()
    recs, wide_ms = kernel_records(objs, sz, dev)
    cases = kernel_sweep(dev)
    emit({"phase": "kernels", "sweep_cases": cases,
          "seconds": time.perf_counter() - t0,
          "wide_row_variants_ms": wide_ms,
          "main_path_shapes": {k: {"max_err": v["max_abs_err"],
                                   "kernel_ms": v["ms"],
                                   "kernel_ms_cold_l2": v["ms_cold_l2"],
                                   "call_ms": v["call_ms"],
                                   "plain_ms": v["plain_ms"],
                                   "library_ms": v["library_ms"],
                                   "bound_ms": v["bound_ms"]}
                               for k, v in recs.items()}})

    # the main path: counters from 0, driven through the user entry points
    kops.reset_launch_counts()
    emit(phase_sf_ops(objs, dev))
    emit(phase_spmv_cg(objs, sz, dev))
    counts = kops.launch_counts()
    missing = [k for k, v in counts.items() if v == 0]
    check(not missing or dev.type != "cuda",
          f"main path never launched {missing}")
    for name, rec in recs.items():
        rec["launches"] = counts[name]
    return [recs[k] for k in REPLACES]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    build_s = _build.build_all()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "kernel_build_s": build_s})
    kernels = run(dev, Sizes())
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
