#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line and asserting as it goes:

  env      torch / CUDA versions, the card, ``nvidia-smi`` name and power
           limit, the time to build the CUDA kernels from ``src``, and the
           flash, narrow and strided kernels' registers, spills and shared
           memory (ptxas -v).
  setup    the main path's objects: a 7-point Poisson matrix on a 128^3 grid
           (2,097,152 unknowns) as ``ParCSR`` over 8 logical ranks in
           z-slabs, a random general star forest (8 ranks, 2^20 roots,
           2^22 edges), a local-only SF, a 3D-box halo SF and a wide-row SF.
  kernels  every kernel entry point against its plain PyTorch version on the
           card, at the main path's shapes and over a sweep of units, dtypes
           and ops (bitwise, except ``spmv_ell``: max|d| <= 1e-5 max|y|);
           device times of kernel (warm and with L2 scrubbed), plain version
           and one library call; both gather and both segment-reduce variants
           on wide rows.  ``pack_blocked`` and ``bcast_fused`` also against
           their first kernels (the generic loop) on the same inputs
           (``prev_ms``, in turns), ``pack_blocked`` at the general SF's
           4,194,304-row bcast pack (unit () and (3,), with the index sorted as
           a control) and at three CTA tiles, ``bcast_fused`` beside the
           two-call ``index_select`` + ``index_copy`` composition and in a
           warm-against-cold study (fresh or preallocated output, plain or
           evict-first stores and loads, the write-back each leaves behind);
           the sweep adds ragged row counts and bases off the 16-byte alignment
           for both.  ``pack_strided`` at five shapes (``strided_shapes``):
           the box halo SF's box (rows of 3 f32 and of 1), the 256^3
           interior of a 258^3 ghosted local array (rows of 3 f32 and of 1;
           its source is four times L2) and that array's x-face, each
           against its first kernel in turns (``prev_ms``), with L2
           scrubbed, beside ``as_strided(...).contiguous()`` (its library
           call), ``index_select`` and both panel designs; its sweep covers
           every route over units () to (64,), five dtypes, skewed starts,
           ``data[1:]``, a 258-pitch plane and x-faces, and every route the
           plan can pick must be taken.
           ``flash_attention`` at the serving prefill's shape for every bucket
           the trace uses (bf16, Sq = Skv, 32 query / 8 KV heads of 128,
           causal) and over a sweep (float32 / bf16, head sizes 16-128, GQA
           1/4/8, windows, Sq < Skv, Sq > Skv with fully masked rows exactly 0,
           ragged tails, a batch; for the wgmma kernel's ring also S = 4096
           with a window of 1000, Skv off the tile, Sq = 1 against 2048 keys
           and a batch of 3), each case with the route it took, within
           FLASH_TOL, which scales with each query row; three faulty outputs
           made in plain torch (late rows 0, the diagonal KV tile skipped,
           every KV tile after the first holding the previous tile's K and V)
           must fail it.  Each bucket also times the other bf16 kernel
           (``prev_ms``) and gives the achieved TFLOP/s.  SDPA is its library
           call.
  sf_ops   ``SFComm(backend="cuda")`` against ``SFComm(backend="global")``.
  spmv_cg  SpMV / SpMV^T against scipy in float64, then CG and CGAsync on
           the Poisson matrix through the ELL kernel.
  serve    qwen3-4b at its published size in bf16 (random weights from a
           seeded generator): the flash kernel held against the plain decode
           attention through the whole model (prefill(p) vs prefill(p[:-1])
           + decode_step(p[-1]) logits: the last query row of every layer;
           two faulty last rows must fail it), one engine stream against
           direct greedy decoding, then ``ServeEngine(batch=8, s_max=2048)`` driven
           by ``loadgen.drive`` on 16 requests (prompts 64-1024 tokens,
           16-64 new tokens each): service metrics, launches (every flash
           launch on the wgmma route), and profiled windows of prefills and
           decode steps.

Two paths carry the kernels: ``sf_ops`` + ``spmv_cg`` (the SF kernels) and
the serve phase's drive (``flash_attention``).  Every launch counter is set
to 0 just before each and read just after, and each kernel must have
launched on its path; the ``launches`` of a kernel are its path's count.
A ``profiler`` line counts the profiled windows and those taken again
because the profiler returned them without all their device events.
The line before the last two is ``{"kernels": [...]}``, then the card's
``nvidia-smi --query-gpu=name,power.limit`` line, then the result line.
Exits non-zero without a CUDA device, without the repository's ``src``, or
on any failed check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM, dense bf16 on the tensor cores
# prefill(prompt) against prefill(prompt[:-1]) + decode_step(prompt[-1]) in
# bf16 through the whole model, ||d|| / ||logits|| over the vocabulary.  Both
# sides share the kernel's rows 0..n-2 (the cache is seeded by prefill), so
# this holds only the last query row of every layer: the kernel's against
# the plain decode attention's.
PREFILL_DECODE_REL_TOL = 5e-2
# flash_attention against its plain version, per element
#   |d| <= rtol |want| + atol + row_atol * rms(want's query row)
# and per query row ||d|| <= row_rel ||want|| (a row of want that is 0 must
# come back 0).  The row terms scale with the data, so rows whose outputs are
# small (late causal rows average many keys) are held as tightly as the
# large early ones.  float32: the reference's tests/test_kernels.py:84.
FLASH_TOL = {
    "float32": {"rtol": 2e-4, "atol": 2e-5, "row_atol": 0.0,
                "row_rel": 2e-4},
    "bfloat16": {"rtol": 2e-2, "atol": 0.0, "row_atol": 1e-2,
                 "row_rel": 1e-2}}

REPLACES = {
    "pack": "src/repro/kernels/sf_pack.py:60",
    "pack_blocked": "src/repro/kernels/sf_pack.py:96",
    "pack_strided": "src/repro/kernels/sf_pack.py:177",
    "bcast_fused": "src/repro/kernels/sf_pack.py:141",
    "segment_reduce_sorted": "src/repro/kernels/sf_unpack.py:86",
    "segment_reduce_blocked": "src/repro/kernels/sf_unpack.py:154",
    "spmv_ell": "src/repro/kernels/spmv_ell.py:33",
    "flash_attention": "src/repro/kernels/flash_attention.py:92",
}
SOURCES = {
    "pack": "src/repro_torch/kernels/csrc/sf_pack.cu",
    "pack_blocked": "src/repro_torch/kernels/csrc/sf_pack.cu",
    "pack_strided": "src/repro_torch/kernels/csrc/sf_pack.cu",
    "bcast_fused": "src/repro_torch/kernels/csrc/sf_pack.cu",
    "segment_reduce_sorted": "src/repro_torch/kernels/csrc/sf_unpack.cu",
    "segment_reduce_blocked": "src/repro_torch/kernels/csrc/sf_unpack.cu",
    "spmv_ell": "src/repro_torch/kernels/csrc/spmv_ell.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
}
SF_PATH = ("pack", "pack_blocked", "pack_strided", "bcast_fused",
           "segment_reduce_sorted", "segment_reduce_blocked", "spmv_ell")
SERVE_PATH = ("flash_attention",)


@dataclasses.dataclass
class Sizes:
    grid: int = 128               # Poisson grid edge (grid^3 unknowns)
    nranks: int = 8
    gen_roots: int = 1 << 20      # general SF
    gen_edges: int = 1 << 22
    local_roots: int = 1 << 20    # local-only SF
    box: tuple = (100, 100, 8)    # halo box inside a grid^3 root block
    ghost: int = 258              # edge of the ghosted local array whose
                                  # (ghost - 2)^3 interior pack_strided packs
    wide_roots: int = 1 << 14     # wide-row SF (unit (WIDE,))
    wide_edges: int = 1 << 16
    cg_maxiter: int = 2000
    timing_iters: int = 20
    # serve: qwen3-4b at its published size, bf16 (smoke=True: its smoke
    # config, for rehearsals on the CPU)
    serve_arch: str = "qwen3-4b"
    serve_smoke: bool = False
    serve_batch: int = 8
    serve_s_max: int = 2048
    serve_requests: int = 16
    serve_prompt: tuple = (64, 1024)
    serve_new: tuple = (16, 64)
    check_prompt: int = 200       # prefill-vs-decode check prompt length


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


# torch.profiler on the H100 now and then returns a window without its
# device events, in bursts that several windows in a row fall into.  A window
# that is not whole is taken again after a growing wait, so that the retakes
# outlast a burst; ``PROFILER_WINDOWS`` counts them for the ``profiler`` line.
RETAKE_WAITS_S = (0.05, 0.2, 0.5, 1.0, 2.0, 4.0)
PROFILER_WINDOWS = {"taken": 0, "retaken": 0}


def _profile(fn, dev):
    """(device ms by kernel name, events by kernel name, wall ms) of one
    ``fn()`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    PROFILER_WINDOWS["taken"] += 1
    dev_events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.device_time_total > 0]
    return ({e.key: e.device_time_total / 1e3 for e in dev_events},
            {e.key: e.count for e in dev_events}, wall)


def profiled(fn, dev):
    """(device ms by kernel name, wall ms) of one ``fn()`` under
    torch.profiler, for a window that cannot be taken again; on the CPU, no
    device times and the host wall time."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return {}, (time.perf_counter() - t0) * 1e3
    by_name, _, wall = _profile(fn, dev)
    return by_name, wall


def profiled_whole(fn, dev, calls: int = 1, whole=None) -> dict:
    """Device ms by kernel name of one ``fn()`` that makes ``calls`` alike
    calls, from a whole window: one with device events, every kernel in it
    recorded a multiple of ``calls`` times, and ``whole(events by name)``
    true where given.  Other windows are taken again after the waits of
    ``RETAKE_WAITS_S``; the run fails if none is whole."""
    for wait in (0.0,) + RETAKE_WAITS_S:
        time.sleep(wait)
        by_name, counts, _ = _profile(fn, dev)
        if (by_name and all(c % calls == 0 for c in counts.values())
                and (whole is None or whole(counts))):
            return by_name
        PROFILER_WINDOWS["retaken"] += 1
    raise AssertionError(f"torch.profiler returned no whole window in "
                         f"{1 + len(RETAKE_WAITS_S)} tries")


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
    return sum(profiled_whole(many, dev, iters).values()) / iters


_SCRUB_KERNELS = {}


def scrub_kernels(flush, dtype, dev) -> frozenset:
    """Names of the kernels of the L2 scrub ``flush()`` of ``dtype``."""
    if dtype not in _SCRUB_KERNELS:
        _SCRUB_KERNELS[dtype] = frozenset(profiled_whole(flush, dev))
    return _SCRUB_KERNELS[dtype]


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
    flush_names = scrub_kernels(flush, scrub.dtype, dev)
    fn()

    def many():
        for _ in range(iters):
            flush()
            fn()
    by_name = profiled_whole(many, dev, iters,
                             whole=lambda c: flush_names <= c.keys())
    total = sum(v for k, v in by_name.items() if k not in flush_names)
    check(total > 0, "torch.profiler recorded no kernel of the call")
    return total / iters


def bound(nbytes: float, nops: float = 0.0, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's peak rate for their type (by default
    float32 outside the tensor cores)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def flash_ptxas() -> list:
    """Registers, spills and static shared memory of both flash sources'
    kernels, from their ``nvcc -Xptxas=-v`` build logs, with the dynamic
    shared memory of each wgmma instance."""
    from repro_torch.kernels import _build, flash_attention as fa
    out = []
    for src in ("flash_attention_sm90", "flash_attention"):
        for r in _build.ptxas_report(src):
            r = dict(r, source=src)
            for D in fa.SM90_HEAD_DIMS:
                for nc in (1, 2):
                    if src == fa.SM90 and f"ILi{D}ELi{nc}E" in r["function"]:
                        r.update(D=D, rows=64 * nc, dynamic_smem_bytes=fa
                                 .sm90_smem_bytes(D, 64 * nc))
            out.append(r)
    return out


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
    recs["pack_blocked"].update(gather_against_prev(x, idx, dev, it))
    recs["pack_blocked"]["tile_sweep_ms"] = {
        str(b): device_ms(lambda b=b: sf_pack.pack_blocked(
            x, idx, block_rows=b), dev, it) for b in (64, 512, 1024)}
    # the general SF's bcast pack: 4,194,304 rows, f32 rows of unit () and
    # (3,), the byte-bound shape
    gen_be = CudaBackend(objs["gen"], plan=objs["gen_plan"], device=dev)
    gidx = gen_be._k_gr
    gidx64 = gidx.long()
    guniq = int(torch.unique(gidx).numel())
    shapes = []
    for unit in ((), (3,)):
        groot = torch.randn((objs["gen"].nroots_total,) + unit, generator=g,
                            device=dev)
        grb = groot[:1].numel() * 4
        run = lambda: sf_pack.pack_blocked(groot, gidx,
                                           block_rows=kops.PACK_BLOCK_ROWS)
        got = run()
        check(same_bits(got, sf_pack.pack_plain(groot, gidx)),
              f"pack_blocked general SF {unit}: kernel != plain version")
        bms = bound(guniq * grb + gidx.numel() * (grb + 4))[0]
        rec = {"rows": gidx.numel(), "unit": list(unit), "bound_ms": bms,
               **gather_against_prev(groot, gidx, dev, it),
               "ms_cold_l2": cold_device_ms(run, dev, it),
               "library_ms": device_ms(
                   lambda: torch.index_select(groot, 0, gidx64), dev, it)}
        rec["share_of_bound"] = bms / rec["ms_in_turns"]
        # the same bytes with the index sorted: source rows shared by
        # neighbouring threads instead of one sector per random row
        sidx = torch.sort(gidx).values
        rec["sorted_idx_ms"] = device_ms(lambda: sf_pack.pack_blocked(
            groot, sidx, block_rows=kops.PACK_BLOCK_ROWS), dev, it)
        shapes.append(rec)
        del groot
    recs["pack_blocked"]["general_sf_shapes"] = shapes

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
    M = math.prod(s3.dims)
    record("pack_strided", lambda: kops.pack_strided_rows(broot, s3),
           lambda: sf_pack.pack_strided_plain(broot, s3.start, s3.dims,
                                              s3.strides),
           lambda: strided_view(broot, s3.start, s3.dims,
                                s3.strides).contiguous(), M * 12 * 2)
    recs["pack_strided"]["library"] = "torch.as_strided(...).contiguous()"
    recs["pack_strided"]["strided_shapes"] = strided_shapes(
        broot[:, 0].contiguous(), broot, s3, sz, dev, it)
    main = recs["pack_strided"]["strided_shapes"][0]
    recs["pack_strided"].update(
        {k: main[k] for k in ("ms_in_turns", "ms_runs", "prev_ms",
                              "prev_ms_runs", "prev_ms_cold_l2",
                              "prev_source", "index_select_ms", "plan",
                              "variants")})
    recs["pack_strided"]["host_cost"] = strided_host_cost(broot, s3, dev, it)

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
    recs["bcast_fused"].update(bcast_against_prev(lroot, lleaf, src, dev, it))

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


def in_turns(run, prev, dev, it: int):
    """(min, runs) of ``run`` and of ``prev``, each timed twice in turns:
    run, prev, prev, run."""
    ms = [device_ms(run, dev, it)]
    prev_ms = [device_ms(prev, dev, it), device_ms(prev, dev, it)]
    ms.append(device_ms(run, dev, it))
    return (min(ms), ms), (min(prev_ms), prev_ms)


def gather_against_prev(data, idx, dev, it: int) -> dict:
    """pack_blocked against the first blocked gather (the generic loop at
    64 rows per CTA) on the same inputs: both warm in turns and with L2
    scrubbed, and the launch plan the kernel took."""
    from repro_torch.kernels import ops as kops, sf_pack
    run = lambda: sf_pack.pack_blocked(data, idx,
                                       block_rows=kops.PACK_BLOCK_ROWS)
    prev = lambda: sf_pack.gather_generic(data, idx, rows_per_cta=64)
    check(same_bits(prev(), run()), "generic gather != pack_blocked")
    (ms, ms_runs), (prev_ms, prev_runs) = in_turns(run, prev, dev, it)
    out = run()
    plan = sf_pack.gather_plan(data, idx, out, kops.PACK_BLOCK_ROWS)
    return {"ms_in_turns": ms, "ms_runs": ms_runs, "prev_ms": prev_ms,
            "prev_ms_runs": prev_runs,
            "prev_ms_cold_l2": cold_device_ms(prev, dev, it),
            "prev_source": "sf_gather_rows, 64 rows per CTA (generic loop)",
            "plan": dataclasses.asdict(plan)}


def strided_view(data, start: int, dims, strides):
    """``data``'s strided box as a view of shape ``(dz, dy, dx, *unit)``:
    ``.contiguous()`` of it is the one library call that packs the box."""
    import torch
    dx, dy, dz = dims
    _, sy, sz = strides
    r = data.stride(0)
    return torch.as_strided(data, (dz, dy, dx) + tuple(data.shape[1:]),
                            (sz * r, sy * r, r) + tuple(data.stride()[1:]),
                            data.storage_offset() + start * r)


def strided_record(data, start: int, dims, strides, dev, it: int) -> dict:
    """pack_strided on one box: bitwise against the plain version, the
    first kernel (``prev``, the generic loop at 64 rows per CTA) and
    ``as_strided().contiguous()``; warm in turns with ``prev`` and cold-L2
    device ms, the other kernel routes that can copy the box (``variants``),
    ``as_strided().contiguous()`` and ``index_select`` beside them."""
    import torch
    from repro_torch.kernels import sf_pack
    kw = dict(start=start, dims=dims, strides=strides)
    run = lambda: sf_pack.pack_strided(data, **kw)
    prev = lambda: sf_pack.strided_variant(data, route="generic", **kw)
    lib = lambda: strided_view(data, start, dims, strides).contiguous()
    rows64 = sf_pack.strided_rows(start, dims, strides, dev)
    isel = lambda: torch.index_select(data, 0, rows64)
    want = sf_pack.pack_strided_plain(data, start, dims, strides)
    for what, fn in (("kernel", run), ("prev", prev), ("isel", isel)):
        check(same_bits(fn(), want), f"pack_strided {dims}: {what} differs")
    check(same_bits(lib().reshape(want.shape), want),
          f"pack_strided {dims}: as_strided differs")
    out = run()
    rb = out[:1].numel() * out.element_size()
    plan = sf_pack.box_plan(data, out, start, dims, strides)
    others = [r for r in ("panel", "lanes") if r != plan.route
              and plan.route != "generic"
              and (r == "panel" or plan.panel_words
                   <= sf_pack.LANES_MAX_WORDS)]
    variants = {}
    for route in others:
        fn = lambda route=route: sf_pack.strided_variant(data, route=route,
                                                         **kw)
        check(same_bits(fn(), want), f"pack_strided {dims} {route} differs")
        variants[route] = {"ms": device_ms(fn, dev, it),
                           "ms_cold_l2": cold_device_ms(fn, dev, it)}
    del want, out
    (ms, ms_runs), (prev_ms, prev_runs) = in_turns(run, prev, dev, it)
    M = math.prod(dims)
    bms = bound(2 * M * rb)[0]
    rec = {"dims": list(dims), "strides": list(strides), "start": start,
           "unit": list(data.shape[1:]), "dtype": str(data.dtype),
           "rows": M, "bytes": 2 * M * rb, "plan_route": plan.route,
           "plan": dataclasses.asdict(plan),
           "ms_in_turns": ms, "ms_runs": ms_runs,
           "ms_cold_l2": cold_device_ms(run, dev, it),
           "prev_ms": prev_ms, "prev_ms_runs": prev_runs,
           "prev_ms_cold_l2": cold_device_ms(prev, dev, it),
           "prev_source": "sf_gather_strided, 64 rows per CTA (the first "
                          "kernel's generic loop)",
           "bound_ms": bms, "library_ms": device_ms(lib, dev, it),
           "library_ms_cold_l2": cold_device_ms(lib, dev, it),
           "index_select_ms": device_ms(isel, dev, it),
           "variants": variants}
    rec["share_of_bound"] = bms / ms
    rec["share_of_bound_cold_l2"] = bms / rec["ms_cold_l2"]
    return rec


def strided_host_cost(data, s3, dev, it: int) -> dict:
    """The host's share of the path's ``pack_strided`` call on the main
    path's box, against the first kernel's wrapper (the contract's checks,
    ``torch.empty`` and one ``sf_gather_strided`` launch, no plan):
    ``call_ms`` of each (host included) in turns, run, prev, prev, run,
    and the host microseconds of the plan lookup alone."""
    import torch
    from repro_torch.kernels import _build, ops as kops, sf_pack
    run = lambda: kops.pack_strided_rows(data, s3)

    def prev():
        start, (dx, dy, dz), (_, sy, sz) = sf_pack._strided_args(
            data, s3.start, s3.dims, s3.strides)
        M = dx * dy * dz
        out = torch.empty((M,) + tuple(data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        if dev.type == "cuda":
            _build.launch("sf_gather_strided", data.data_ptr(),
                          out.data_ptr(), M, sf_pack._row_bytes(data), 64,
                          start, dx, dy, sy, sz, _build.stream_of(data))
        else:
            out.copy_(sf_pack.pack_strided_plain(data, start, s3.dims,
                                                 s3.strides))
        return out
    check(same_bits(prev(), run()), "pack_strided != the first wrapper")
    ms = [call_ms(run, dev, it)]
    prev_ms = [call_ms(prev, dev, it), call_ms(prev, dev, it)]
    ms.append(call_ms(run, dev, it))
    out, n = run(), 10000
    t0 = time.perf_counter()
    for _ in range(n):
        sf_pack.box_plan(data, out, s3.start, s3.dims, s3.strides)
    return {"call_ms": min(ms), "call_ms_runs": ms,
            "prev_wrapper_call_ms": min(prev_ms),
            "prev_wrapper_call_ms_runs": prev_ms,
            "plan_lookup_us": (time.perf_counter() - t0) * 1e6 / n}


def strided_shapes(root1, root3, s3, sz: Sizes, dev, it: int) -> list:
    """pack_strided at the five timed shapes: the main path's box halo
    (f32 rows of 3, then of 1), the (ghost - 2)^3 interior of a ghost^3
    ghosted local array (rows of 3 f32, then f32; 206 MB of source at
    258^3, four times L2) and that array's x-face (rows of 3 f32)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(3)
    out = [strided_record(root3, s3.start, s3.dims, s3.strides, dev, it),
           strided_record(root1, s3.start, s3.dims, s3.strides, dev, it)]
    e = sz.ghost
    n = e - 2
    strides, start = (1, e, e * e), 1 + e + e * e
    for unit, dims in (((3,), (n, n, n)), ((), (n, n, n)),
                       ((3,), (1, n, n))):
        data = torch.randn((e ** 3,) + unit, generator=g, device=dev)
        out.append(strided_record(data, start, dims, strides, dev, it))
        del data
    return out


def scrub_ms(fn, dev, iters: int) -> dict:
    """Device ms of the 256 MB L2 scrub alone and of the same scrub run
    right after each ``fn()``: the difference is the write-back of the
    dirty lines ``fn`` left in L2, which a cold-L2 reading of ``fn`` does
    not see."""
    import torch
    if dev.type != "cuda":
        return {}
    # a float32 sum reads at close to the HBM rate, so that write-back
    # traffic added to it shows in its time
    scrub = torch.ones(64 << 20, dtype=torch.float32, device=dev)
    flush = lambda: scrub.sum()
    names = scrub_kernels(flush, scrub.dtype, dev)
    fn()

    def alone():
        for _ in range(iters):
            flush()

    def after():
        for _ in range(iters):
            fn()
            flush()
    out = {}
    for key, many in (("scrub_alone", alone), ("scrub_after_call", after)):
        by_name = profiled_whole(many, dev, iters,
                                 whole=lambda c: names <= c.keys())
        out[key] = sum(v for k, v in by_name.items() if k in names) / iters
    out["write_back_ms"] = out["scrub_after_call"] - out["scrub_alone"]
    return out


def bcast_against_prev(root, leaf, src, dev, it: int) -> dict:
    """bcast_fused against its first kernel (generic loop, 64 rows per
    CTA) on the same inputs in turns, the two-call composition
    ``leaf.index_copy(0, gl, root.index_select(0, gr))`` as a yardstick,
    and the warm-against-cold study: the narrow kernel into a fresh or a
    preallocated output, with plain or evict-first (.cs) stores, and with
    its evict-first loads made plain, warm and with L2 scrubbed, and the
    write-back the kernel (and the generic one) leaves to the next kernel."""
    import torch
    from repro_torch.kernels import sf_pack
    run = lambda: sf_pack.bcast_fused(root, leaf, src)
    prev = lambda: sf_pack.bcast_variant(root, leaf, src, route="generic")
    want = run()
    check(same_bits(prev(), want), "generic bcast_fused != bcast_fused")
    gl = torch.nonzero(src >= 0).reshape(-1)
    gr = src[gl].long()
    composed = lambda: leaf.index_copy(0, gl, root.index_select(0, gr))
    check(same_bits(composed(), want), "index_copy composition differs")
    (ms, ms_runs), (prev_ms, prev_runs) = in_turns(run, prev, dev, it)
    fixed = torch.empty_like(leaf)
    variants = {
        "fresh_out": run,
        "preallocated_out": lambda: sf_pack.bcast_variant(
            root, leaf, src, route="narrow", out=fixed),
        "fresh_out_streaming": lambda: sf_pack.bcast_variant(
            root, leaf, src, route="narrow", streaming=True),
        "preallocated_out_streaming": lambda: sf_pack.bcast_variant(
            root, leaf, src, route="narrow", out=fixed, streaming=True),
        "fresh_out_cached_loads": lambda: sf_pack.bcast_variant(
            root, leaf, src, route="narrow", stream_loads=False)}
    study = {}
    for name, fn in variants.items():
        check(same_bits(fn(), want), f"bcast_fused {name} differs")
        study[name] = {"ms": device_ms(fn, dev, it),
                       "ms_cold_l2": cold_device_ms(fn, dev, it)}
    study["scrub"] = {name: scrub_ms(fn, dev, it)
                      for name, fn in (("fresh_out", run),
                                       ("fresh_out_streaming",
                                        variants["fresh_out_streaming"]),
                                       ("prev", prev))}
    out = run()
    return {"ms_in_turns": ms, "ms_runs": ms_runs, "prev_ms": prev_ms,
            "prev_ms_runs": prev_runs,
            "prev_ms_cold_l2": cold_device_ms(prev, dev, it),
            "prev_source": "sf_bcast_fused_copy, 64 rows per CTA (generic "
                           "loop)",
            "composed_ms": device_ms(composed, dev, it),
            "plan": dataclasses.asdict(sf_pack.bcast_plan(root, leaf, src,
                                                          out)),
            "warm_cold_study": study}


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
                want = sf_pack.pack_strided_plain(data, start, dims,
                                                  strides)
                kw = dict(start=start, dims=dims, strides=strides)
                for got in (sf_pack.pack_strided(data, **kw),
                            sf_pack.strided_variant(data, route="generic",
                                                    **kw)):
                    check(same_bits(got, want), f"pack_strided {dt}")
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
    cases += strided_sweep(dev, rng)
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
    # the narrow kernels' ragged and misaligned cases: 4k + 1 .. 4k + 3
    # rows, data[1:] / leaf[1:] and idx[1:] / src_of_leaf[1:] (bases off
    # the 16-byte alignment), block_rows 1 / 5 / 64 / 1024, copy and casts
    def ragged(shape, dt):
        a = torch.as_tensor(rng.standard_normal(shape) * 100, device=dev)
        return a > 0 if dt == torch.bool else a.to(dt)

    all_dt = dtypes + [torch.int8, torch.bool]
    counts = (1, 3, 4 * 101 + 1, 4 * 101 + 2, 4 * 101 + 3, 4 * 3000 + 1)
    for unit in [(), (2,), (3,), (4,), (2, 2), (5,)]:
        for dt in all_dt:
            data = ragged((700,) + unit, dt)
            for M in counts:
                idx = torch.as_tensor(rng.integers(0, 699, M + 1),
                                      dtype=torch.int32, device=dev)
                for d, ix in ((data, idx[:M]), (data[1:], idx[1:])):
                    want = sf_pack.pack_plain(d, ix)
                    for br in (1, 5, 64, 1024):
                        check(same_bits(sf_pack.pack_blocked(
                            d, ix, block_rows=br), want),
                            f"pack_blocked ragged {unit} {dt} M={M} "
                            f"block_rows={br}")
                        cases += 1
    pairs = [(a, a) for a in all_dt] + [(a, b) for a in fl for b in fl
                                        if a != b]
    for unit in [(), (2,), (3,), (4,), (5,)]:
        for rdt, ldt in pairs:
            root = ragged((700,) + unit, rdt)
            for M in counts:
                leaf = ragged((M + 1,) + unit, ldt)
                src = torch.as_tensor(rng.integers(-1, 699, M + 1),
                                      dtype=torch.int32, device=dev)
                for lf, sm in ((leaf[:M], src[:M]), (leaf[1:], src[1:])):
                    for rt in (root, root[1:]):
                        check(same_bits(sf_pack.bcast_fused(rt, lf, sm),
                                        sf_pack.bcast_fused_plain(rt, lf,
                                                                  sm)),
                              f"bcast_fused ragged {unit} {rdt}->{ldt} "
                              f"M={M}")
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


# the strided sweep's boxes: (dims, strides, start) in an array of
# STRIDED_SWEEP_ROWS rows: starts skewed 0-3 rows, a 258-pitch plane (the
# ghosted array's rows) and its x-face, a box whose panels start on a
# 16-byte boundary for 4-byte rows, 1,500 panels of 4 rows, a single
# plane, a single row of panels, a contiguous run
STRIDED_SWEEP_ROWS = 258 * 16 * 3 + 64
STRIDED_SWEEP_BOXES = (
    [((30, 7, 3), (1, 64, 64 * 8), s) for s in range(4)]
    + [((256, 4, 2), (1, 258, 258 * 16), 1 + 258),
       ((1, 14, 3), (1, 258, 258 * 16), 1 + 258),
       ((12, 6, 3), (1, 16, 256), 4 + 16 + 256),
       ((4, 1, 1500), (1, 8, 8), 0),
       ((40, 1, 3), (1, 50, 300), 7),
       ((40, 5, 1), (1, 50, 300), 7),
       ((500, 1, 1), (1, 500, 500), 3)])


def strided_sweep(dev, rng) -> int:
    """pack_strided bitwise against its plain version over units (), (2,),
    (3,), (4,), (5,), (64,), dtypes float32 / bfloat16 / float64 / int8 /
    bool, the boxes of STRIDED_SWEEP_BOXES on data and on data[1:] (a base
    off the 16-byte alignment): the plan's route and every other route
    that can copy the box.  Every route the plan can
    pick must have been taken.  Returns the number of cases."""
    import torch
    from repro_torch.kernels import sf_pack
    before = dict(sf_pack.pack_strided.routes)
    cases = 0
    for unit in [(), (2,), (3,), (4,), (5,), (64,)]:
        for dt in (torch.float32, torch.bfloat16, torch.float64, torch.int8,
                   torch.bool):
            a = torch.as_tensor(rng.standard_normal(
                (STRIDED_SWEEP_ROWS,) + unit) * 100, device=dev)
            data = a > 0 if dt == torch.bool else a.to(dt)
            rb = data[:1].numel() * data.element_size()
            for d in (data, data[1:]):
                for dims, strides, start in STRIDED_SWEEP_BOXES:
                    kw = dict(start=start, dims=dims, strides=strides)
                    want = sf_pack.pack_strided_plain(d, start, dims,
                                                      strides)
                    check(same_bits(sf_pack.pack_strided(d, **kw), want),
                          f"pack_strided {unit} {dt} {dims} {start}")
                    cases += 1
                    plan = sf_pack.strided_plan(dims, strides, rb,
                                                start=start,
                                                src_ptr=d.data_ptr(),
                                                out_ptr=0)
                    forced = [dict(route="generic")]
                    if plan.route != "generic":
                        forced.append(dict(route="panel"))
                        if plan.panel_words <= sf_pack.LANES_MAX_WORDS:
                            forced.append(dict(route="lanes"))
                    for opts in forced:
                        got = sf_pack.strided_variant(d, **opts, **kw)
                        check(same_bits(got, want),
                              f"pack_strided {opts} {unit} {dt} {dims} "
                              f"{start}")
                        cases += 1
    taken = {r for r, n in sf_pack.pack_strided.routes.items()
             if n > before[r]}
    can = set(sf_pack.STRIDED_ROUTES)
    check(dev.type != "cuda" or taken == can,
          f"the sweep took pack_strided routes {sorted(taken)}, the plan "
          f"can pick {sorted(can)}")
    return cases


# -------------------------------------------------------- flash attention
def visible_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave visible: the work the data
    needs, not the full Sq x Skv rectangle."""
    qpos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.zeros(Sq, np.int64) if window is None else \
        np.maximum(qpos - int(window) + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def flash_gap(got, want) -> dict:
    """How far a flash_attention result lies from its plain version, read
    against FLASH_TOL: max|d|, ||d||/||want||, the largest per-row
    ||d||/||want||, and the elements and rows outside the limit."""
    import torch
    tol = FLASH_TOL[str(want.dtype).split(".")[-1]]
    H, D = want.shape[-2:]
    g = got.float().reshape(-1, H * D)           # one query row per line
    w = want.float().reshape(-1, H * D)
    d = g - w
    rms = w.square().mean(1, keepdim=True).sqrt()
    limit = tol["rtol"] * w.abs() + tol["atol"] + tol["row_atol"] * rms
    dn, wn = d.norm(dim=1), w.norm(dim=1)
    row_bad = dn > tol["row_rel"] * wn
    row_rel = torch.where(wn > 0, dn / wn.clamp_min(1e-30),
                          torch.where(dn > 0, float("inf"), 0.0))
    return {"max_abs": float(d.abs().max()),
            "rel_l2": float(d.norm() / w.norm()),
            "row_rel_max": float(row_rel.max()),
            "elements_outside": int((d.abs() > limit).sum()),
            "rows_outside": int(row_bad.sum()),
            "finite": bool(torch.isfinite(g).all())}


def flash_check(got, want, what: str) -> float:
    """Hold a flash_attention result against its plain version within
    FLASH_TOL; returns max|d|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    gap = flash_gap(got, want)
    check(gap["finite"], f"{what}: non-finite output")
    check(gap["elements_outside"] == 0 and gap["rows_outside"] == 0,
          f"{what}: outside FLASH_TOL: {gap}")
    return gap["max_abs"]


def flash_controls(q, k, v, want, tile: int = 64) -> dict:
    """Outputs of faults the kernel could have, made in plain torch from the
    causal serving shape's inputs, each read against FLASH_TOL beside the
    old fixed (5e-2, 5e-2) limit: rows past S/4 returned as 0; every query
    tile's last KV tile (the diagonal one) skipped; and a stale ring stage,
    where every KV tile of the wgmma kernel's width after the first holds
    the previous tile's K and V.  flash_check must reject each."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    S, kv_tile = q.shape[0], fa.SM90_BC
    zeroed = want.clone()
    zeroed[S // 4:] = 0
    # each query row sees only the keys before its own 64-row tile
    qg = q.float().reshape(S, k.shape[1], -1, q.shape[-1])
    s = torch.einsum("qkrd,skd->krqs", qg, k.float()) / q.shape[-1] ** 0.5
    pos = torch.arange(S, device=q.device)
    keep = pos[None, :] < (pos[:, None] // tile) * tile
    p = torch.nan_to_num(torch.softmax(s.masked_fill(~keep, float("-inf")),
                                       -1), nan=0.0)
    skipped = torch.einsum("krqs,skd->qkrd", p, v.float()) \
        .reshape(want.shape).to(want.dtype)
    del s, p
    faults = [("late_rows_zero", zeroed),
              ("diagonal_kv_tile_skipped", skipped)]
    if S > kv_tile:          # one KV tile has no stale stage to read
        k_stale, v_stale = k.clone(), v.clone()
        k_stale[kv_tile:], v_stale[kv_tile:] = k[:-kv_tile], v[:-kv_tile]
        faults.append(("stale_kv_stage",
                       fa.flash_attention_plain(q, k_stale, v_stale)))
    out = {}
    for name, bad in faults:
        gap = flash_gap(bad, want)
        gap["rejected"] = gap["elements_outside"] > 0 or \
            gap["rows_outside"] > 0
        d = (bad.float() - want.float()).abs()
        gap["old_5e-2_limit_rejects"] = bool(
            (d > 5e-2 + 5e-2 * want.float().abs()).any())
        check(gap["rejected"], f"flash control {name} passes FLASH_TOL: "
              f"{gap}")
        out[name] = gap
    return out


def flash_sweep(dev) -> dict:
    """flash_attention against its plain version over dtypes, head sizes,
    GQA ratios 1/4/8, windows, Sq < Skv, Sq > Skv (fully masked rows must
    be exactly 0), ragged tails and a batched call, then the ring-stress
    shapes of the wgmma kernel in bf16 at head sizes 64 and 128.  Each case
    records the kernel it took (read from the launch counters and held to
    ``route``).  Returns the cases, the count per route and the largest
    error per dtype."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(11)
    shapes = [  # Sq, Skv, H, Hkv, causal, window
        (128, 128, 4, 4, True, None), (100, 100, 8, 2, True, None),
        (64, 192, 8, 1, True, 48), (1, 96, 4, 1, True, None),
        (128, 128, 4, 2, False, None), (73, 129, 6, 3, True, None),
        (48, 16, 4, 2, True, None), (200, 200, 8, 8, True, 17),
        (130, 70, 8, 1, False, 20)]
    ring = [  # B, Sq, Skv, H, Hkv, causal, window: many tiles per ring
        (1, 4096, 4096, 8, 2, True, 1000), (1, 300, 333, 8, 2, True, None),
        (1, 1, 2048, 8, 2, True, None), (3, 257, 257, 8, 2, True, None)]
    cases, worst, routes = [], {}, {}

    def run_case(q, k, v, what, causal=True, window=None):
        before = fa.flash_attention.launches_sm90
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        took = "plain" if dev.type != "cuda" else fa.SM90 \
            if fa.flash_attention.launches_sm90 > before \
            else "flash_attention"
        check(took == fa.route(q.dtype, q.shape[-1]) or dev.type != "cuda",
              f"{what}: took {took}")
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        err = flash_check(got, want, what)
        key = str(q.dtype).split(".")[-1]
        worst[key] = max(worst.get(key, 0.0), err)
        Sq, Skv = q.shape[-3], k.shape[-3]
        if causal and Sq > Skv:
            check(bool((got[..., : Sq - Skv, :, :] == 0).all()),
                  f"{what}: fully masked rows are not 0")
        routes[took] = routes.get(took, 0) + 1
        cases.append([what, took, err])

    for dt in (torch.float32, torch.bfloat16):
        def rand(*shape):
            return torch.as_tensor(rng.standard_normal(shape),
                                   device=dev).to(dt)
        for D in (16, 32, 64, 128):
            for Sq, Skv, H, Hkv, causal, window in shapes:
                run_case(rand(Sq, H, D), rand(Skv, Hkv, D), rand(Skv, Hkv, D),
                         f"{str(dt)[6:]} D{D} {Sq}x{Skv} H{H}/{Hkv} "
                         f"causal={causal} window={window}", causal, window)
            # a leading batch dimension goes into the grid
            run_case(rand(2, 77, 8, D), rand(2, 77, 2, D), rand(2, 77, 2, D),
                     f"{str(dt)[6:]} D{D} batched 2x77")
            if dt != torch.bfloat16 or D not in fa.SM90_HEAD_DIMS:
                continue
            for B, Sq, Skv, H, Hkv, causal, window in ring:
                run_case(rand(B, Sq, H, D), rand(B, Skv, Hkv, D),
                         rand(B, Skv, Hkv, D),
                         f"ring bfloat16 D{D} {B}x{Sq}x{Skv} H{H}/{Hkv} "
                         f"causal={causal} window={window}", causal, window)
    return {"n_cases": len(cases), "routes": routes, "max_abs_err": worst,
            "cases": cases}


def flash_record(dev, S: int, it: int, H: int, Hkv: int, D: int,
                 window) -> dict:
    """The serving prefill's attention core at one bucket (bf16, Sq = Skv
    = S, causal): kernel vs plain, device times, bound and the library
    call (SDPA with enable_gqa), as the other kernel rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(S, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(S, Hkv, D, generator=g, device=dev).bfloat16()
    v = torch.randn(S, Hkv, D, generator=g, device=dev).bfloat16()
    run = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                             window=window)
    # the first kernel (mma.sync) on the same bf16 inputs
    prev = lambda: fa.launch_kernel("flash_attention", q, k, v, causal=True,
                                    window=window)
    got, want = run(), plain()
    flash_check(prev(), want, f"first flash kernel S={S}")
    err = flash_check(got, want, f"flash serving shape S={S}")
    gap = flash_gap(got, want)
    controls = flash_controls(q, k, v, want)
    qt, kt, vt = (x.transpose(0, 1)[None] for x in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    nops = 4.0 * visible_pairs(S, S, True, window) * H * D
    bms, by = bound(nbytes, nops, BF16_OPS_PER_S)
    # kernel and first kernel in turns: kernel, prev, prev, kernel
    ms = [device_ms(run, dev, it)]
    prev_ms = [device_ms(prev, dev, it), device_ms(prev, dev, it)]
    ms.append(device_ms(run, dev, it))
    rec = {"S": S, "route": fa.route(q.dtype, D),
           "max_abs_err": err, "rel_l2": gap["rel_l2"],
           "row_rel_max": gap["row_rel_max"], "controls": controls,
           "ms": min(ms), "ms_runs": ms,
           "ms_cold_l2": cold_device_ms(run, dev, it),
           "prev_ms": min(prev_ms), "prev_ms_runs": prev_ms,
           "prev_ms_cold_l2": cold_device_ms(prev, dev, it),
           "plain_ms": device_ms(plain, dev, it),
           "library_ms": device_ms(library, dev, it),
           "call_ms": call_ms(run, dev, it),
           "bound_ms": bms, "bound_by": by, "flop": nops}
    rec["tflops"] = nops / (rec["ms"] * 1e-3) / 1e12
    rec["share_of_bound"] = bms / rec["ms"]
    return rec


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
    routes = dict(kops.pack_strided.routes)
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
    out["box_halo_routes"] = {k: v - routes[k] for k, v in
                              kops.pack_strided.routes.items()
                              if v > routes[k]}

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
    # (taken again until the profiler saw every spmv_ell launch of it)
    cg20 = lambda: cg_async(mv, b, maxiter=20, check_every=0)
    for wait in (0.0,) + RETAKE_WAITS_S:
        ell0 = kops.spmv_ell.launches
        if dev.type != "cuda":
            by_name, wall = profiled(cg20, dev)
            ell_launches = kops.spmv_ell.launches - ell0
            break
        time.sleep(wait)
        by_name, counts, wall = _profile(cg20, dev)
        ell_launches = kops.spmv_ell.launches - ell0
        if ell_launches and sum(c for k, c in counts.items()
                                if "spmv_ell_kernel" in k) == ell_launches:
            break
        PROFILER_WINDOWS["retaken"] += 1
    else:
        raise AssertionError("torch.profiler missed spmv_ell launches of "
                             "the profiled CG window in every try")
    busy = sum(by_name.values())
    # spmv_ell on the main path, where one SpMV's 16 blocks (about 130 MB)
    # stream through the 50 MB L2, against the byte bound of those blocks
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


# ------------------------------------------------------------------ serve
def serve_config(sz: Sizes):
    from repro_torch.configs import get_config
    cfg = get_config(sz.serve_arch)
    return cfg.smoke_config() if sz.serve_smoke else cfg


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_trace(sz: Sizes, cfg):
    """The serve phase's arrival trace: ``serve_requests`` requests at 1000
    requests/s, so that the queue never empties while the engine works."""
    from repro_torch.serving import LoadSpec, synthesize
    return synthesize(LoadSpec(rate_rps=1000.0, n_requests=sz.serve_requests,
                               prompt_len=sz.serve_prompt,
                               max_new=sz.serve_new, vocab=cfg.vocab, seed=0))


def serve_buckets(trace, sz: Sizes) -> list:
    """The prefill buckets (sequence lengths) the trace's prompts take."""
    from repro_torch.serving import next_pow2
    return sorted({min(next_pow2(r.prompt_len), sz.serve_s_max)
                   for _, r in trace})


@contextlib.contextmanager
def faulty_attention_core(fault):
    """Within the block, the models' prefill attention core is the flash
    kernel followed by ``fault(out)``, which edits its output in place."""
    from repro_torch.kernels import ops as kops
    real = kops.flash_attention

    def core(*args, **kwargs):
        out = real(*args, **kwargs)
        fault(out)
        return out
    kops.flash_attention = core
    try:
        yield
    finally:
        kops.flash_attention = real


def serve_checks(cfg, params, sz: Sizes, dev, rng) -> dict:
    """The path's correctness checks, run before the traffic: the flash
    kernel against the plain decode attention through the whole model, and
    one request's engine stream against direct greedy prefill + decode."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine
    out = {}
    # 1. last-position logits of prefill(prompt) (flash kernel on every
    #    layer) against prefill(prompt[:-1]) + decode_step(prompt[-1])
    #    (plain decode attention), full width and depth, bf16
    n = sz.check_prompt
    prompt = rng.integers(0, cfg.vocab, (1, n))
    with torch.no_grad():
        full, _ = T.prefill(params, cfg, tokens=prompt, s_max=n)
        _, cache = T.prefill(params, cfg, tokens=prompt[:, :-1], s_max=n)
        step, _ = T.decode_step(params, cfg, prompt[:, -1], cache)
    a, b = full.float(), step.float()
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          "prefill / decode logits are not finite")
    rel = float((a - b).norm() / b.norm())
    out["prefill_vs_decode"] = {
        "prompt": n, "rel_l2": rel, "tol": PREFILL_DECODE_REL_TOL,
        "max_abs": max_abs(a, b), "logit_abs_max": float(b.abs().max()),
        "same_argmax": bool(a.argmax() == b.argmax())}
    check(rel <= PREFILL_DECODE_REL_TOL, f"prefill vs decode logits: "
          f"||d||/||y|| {rel} > {PREFILL_DECODE_REL_TOL}")
    # controls: the same prefill(prompt) with the attention core's last
    # query row made wrong on every layer (0, or the row before it); the
    # check must reject both
    out["prefill_vs_decode"]["controls"] = {}
    for name, fault in (("last_row_zero", lambda o: o[..., -1, :, :].zero_()),
                        ("last_row_is_previous", lambda o: o[..., -1, :, :]
                         .copy_(o[..., -2, :, :]))):
        with faulty_attention_core(fault), torch.no_grad():
            bad, _ = T.prefill(params, cfg, tokens=prompt, s_max=n)
        crel = float((bad.float() - b).norm() / b.norm())
        out["prefill_vs_decode"]["controls"][name] = crel
        check(crel > PREFILL_DECODE_REL_TOL, f"control {name}: rel L2 "
              f"{crel} passes the prefill-vs-decode check")
    # 2. one request through the engine equals direct greedy prefill +
    #    decode_step (tests/test_serving.py:29).  In float32 at two layers of
    #    the full width, so that the engine's batch-of-slots decode and the
    #    single-stream decode_step round alike and greedy ties cannot flip;
    #    a power-of-two prompt makes the bucket the prompt itself.
    cfg32 = cfg.scaled(dtype="float32", n_layers=2)
    g = torch.Generator(device=dev).manual_seed(1)
    p32 = T.init_params(cfg32, generator=g, device=dev)
    toks = rng.integers(0, cfg.vocab, 64).tolist()
    req = Request(0, toks, max_new=8)
    ServeEngine(cfg32, p32, batch=2, s_max=256, device=dev).run([req])
    lg, cache = T.prefill(p32, cfg32, tokens=[toks], s_max=256)
    tok = torch.argmax(lg, -1)
    want = [int(tok[0])]
    for _ in range(7):
        lg, cache = T.decode_step(p32, cfg32, tok, cache)
        tok = torch.argmax(lg, -1)
        want.append(int(tok[0]))
    check(req.out == want, f"engine stream {req.out} != direct greedy {want}")
    out["engine_equals_direct_greedy"] = {"layers": 2, "dtype": "float32",
                                          "tokens": len(want)}
    del p32, cache
    return out


def phase_serve(sz: Sizes, dev) -> dict:
    """Serve a synthetic trace on the model at its published size through
    ``ServeEngine`` + ``loadgen.drive``: every prefill runs the flash
    kernel on every layer.  Launch counters are set to 0 just before the
    drive and read just after it."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine, drive, \
        trace_fingerprint
    cfg = serve_config(sz)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, generator=g, device=dev)
    sync(dev)
    leaves = [params["embed"], params["final_norm"],
              *params["blocks"].values()] + \
        ([] if cfg.tie_embeddings else [params["lm_head"]])
    out = {"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.param_count(),
           "param_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "init_s": time.perf_counter() - t0}
    out["checks"] = serve_checks(cfg, params, sz, dev, rng)

    trace = serve_trace(sz, cfg)
    eng = ServeEngine(cfg, params, batch=sz.serve_batch, s_max=sz.serve_s_max,
                      device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    sync(dev)
    kops.reset_launch_counts()
    t1 = time.perf_counter()
    metrics = drive(eng, trace)
    sync(dev)
    wall = time.perf_counter() - t1
    counts = kops.launch_counts()
    reqs = [r for _, r in trace]
    check(all(r.done and len(r.out) == r.max_new for r in reqs),
          "a request did not finish with its budget of tokens")
    buckets = serve_buckets(trace, sz)
    check(metrics["prefill_buckets"] == buckets,
          f"prefill buckets {metrics['prefill_buckets']} != {buckets}")
    sm90 = fa.flash_attention.launches_sm90
    check(counts["flash_attention"] == cfg.n_layers * len(reqs) or
          dev.type != "cuda", f"flash launches {counts['flash_attention']} "
          f"!= {cfg.n_layers} layers x {len(reqs)} prefills")
    check(sm90 == counts["flash_attention"], f"only {sm90} of "
          f"{counts['flash_attention']} flash launches took the wgmma route")
    out.update({"trace_fingerprint": trace_fingerprint(trace),
                "requests": len(reqs),
                "prompt_tokens": sum(r.prompt_len for r in reqs),
                "drive_wall_s": wall, "metrics": metrics,
                "launches": counts, "flash_launches_sm90": sm90,
                "flash_launches_per_prefill":
                    counts["flash_attention"] / len(reqs),
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None})

    # where a step's time goes: 7 slots admitted outside the windows; then
    # one prefill and five decode steps of all 8 slots, a prefill of the
    # largest bucket alone, and five decode steps alone, each under the
    # profiler
    lo, hi = sz.serve_prompt
    for i in range(sz.serve_batch - 1):
        eng.submit(Request(100 + i, rng.integers(0, cfg.vocab,
                                                 (lo + hi) // 2).tolist(),
                           max_new=32))
    eng.step()
    probe = Request(200, rng.integers(0, cfg.vocab, hi // 2).tolist(),
                    max_new=8)

    def mixed():
        eng.submit(probe)
        for _ in range(5):
            eng.step()
    big = rng.integers(0, cfg.vocab, (1, max(serve_buckets(trace, sz))))
    windows = {
        "prefill_and_5_decode_steps": mixed,
        f"prefill_{big.shape[1]}": lambda: T.prefill(
            params, cfg, tokens=big, s_max=sz.serve_s_max),
        "5_decode_steps": lambda: [eng.step() for _ in range(5)]}
    for name, fn in windows.items():
        # the prefill alone is taken again until the profiler saw each of
        # its flash launches; the other two move the engine on, so each
        # keeps its one window, with its launches and recorded flash kernels
        for wait in (0.0,) + RETAKE_WAITS_S:
            fl0 = kops.launch_counts()["flash_attention"]
            if dev.type == "cuda":
                time.sleep(wait)
                by_name, counts, wall_ms = _profile(fn, dev)
            else:
                (by_name, wall_ms), counts = profiled(fn, dev), {}
            fl = kops.launch_counts()["flash_attention"] - fl0
            seen = sum(c for k, c in counts.items() if "flash_fwd" in k)
            if (dev.type != "cuda" or not name.startswith("prefill_")
                    or (fl and seen == fl)):
                break
            PROFILER_WINDOWS["retaken"] += 1
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[f"profiled_{name}"] = {
            "wall_ms": wall_ms, "device_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "flash_ms": sum(v for k, v in by_name.items()
                            if "flash_fwd" in k),
            "flash_launches": fl, "flash_kernels_recorded": seen,
            "top_kernels_ms": {k[:60]: v for k, v in top}}
    out["seconds"] = time.perf_counter() - t0
    del eng, params
    gc.collect()
    return out


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
    cfg = serve_config(sz)
    buckets = serve_buckets(serve_trace(sz, cfg), sz)
    by_bucket = [flash_record(dev, S, sz.timing_iters, H=cfg.n_heads,
                              Hkv=cfg.n_kv_heads, D=cfg.hd,
                              window=sz.serve_s_max) for S in buckets]
    flash = dict(by_bucket[-1])           # the row: the largest bucket
    recs["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": 0,
        **{k: flash[k] for k in ("max_abs_err", "ms", "ms_cold_l2",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "call_ms", "prev_ms",
                                 "prev_ms_cold_l2", "tflops")},
        "prev_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "ptxas": [{k: r[k] for k in ("D", "rows", "registers",
                                     "spill_stores", "dynamic_smem_bytes")}
                  for r in flash_ptxas() if "rows" in r]}
    sweep = flash_sweep(dev)
    emit({"phase": "kernels", "sweep_cases": cases,
          "seconds": time.perf_counter() - t0,
          "wide_row_variants_ms": wide_ms,
          "flash_sweep": sweep, "flash_tolerance": FLASH_TOL,
          "flash_serving_buckets": by_bucket,
          "main_path_shapes": {k: {"max_err": v["max_abs_err"],
                                   "kernel_ms": v["ms"],
                                   "kernel_ms_cold_l2": v["ms_cold_l2"],
                                   "call_ms": v["call_ms"],
                                   "plain_ms": v["plain_ms"],
                                   "library_ms": v["library_ms"],
                                   "bound_ms": v["bound_ms"]}
                               for k, v in recs.items()}})

    # the SF path: counters from 0, driven through the user entry points
    on_card = dev.type == "cuda"
    kops.reset_launch_counts()
    emit(phase_sf_ops(objs, dev))
    emit(phase_spmv_cg(objs, sz, dev))
    counts = kops.launch_counts()
    missing = [k for k in SF_PATH if counts[k] == 0]
    check(not missing or not on_card, f"SF path never launched {missing}")
    for name in SF_PATH:
        recs[name]["launches"] = counts[name]
    del objs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the serving path: phase_serve zeroes the counters before its drive
    serve = phase_serve(sz, dev)
    emit(serve)
    missing = [k for k in SERVE_PATH if serve["launches"][k] == 0]
    check(not missing or not on_card, f"serving never launched {missing}")
    for name in SERVE_PATH:
        recs[name]["launches"] = serve["launches"][name]
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
          "nvidia_smi": smi, "kernel_build_s": build_s,
          "flash_ptxas": flash_ptxas(),
          "sf_pack_narrow_ptxas": [
              r for r in _build.ptxas_report("sf_pack")
              if ("rows_c" in r["function"] or "lanes_c" in r["function"])
              and "BoxRows" not in r["function"]],
          "sf_pack_strided_ptxas": [
              r for r in _build.ptxas_report("sf_pack")
              if any(k in r["function"] for k in ("panel_c", "BoxRows",
                                                  "gather_rows_kernel"))]})
    kernels = run(dev, Sizes())
    emit({"phase": "profiler", "windows": PROFILER_WINDOWS["taken"],
          "retaken": PROFILER_WINDOWS["retaken"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
