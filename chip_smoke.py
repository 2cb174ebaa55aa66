#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line and asserting as it goes:

  env      torch / CUDA versions, the card, ``nvidia-smi`` name and power
           limit, the time to build the CUDA kernels from ``src``, and the
           flash, narrow, strided and wide-gather kernels' registers, spills
           and shared memory (ptxas -v).
  setup    the main path's objects: a 7-point Poisson matrix on a 128^3 grid
           (2,097,152 unknowns) as ``ParCSR`` over 8 logical ranks in
           z-slabs, a random general star forest (8 ranks, 2^20 roots,
           2^22 edges), a local-only SF, a 3D-box halo SF and a wide-row SF.
  tuning   the autotuner (``kernels/tuning.py``), from setup on: every sweep
           of the run checks each candidate of its signature bitwise
           against the plain version on the call's own inputs (NaN
           payloads included) and records
           each candidate's best-round device ms, the default's, the
           winner and its speed-up over the default; the sf_ops and
           spmv_cg paths' signatures sweep right after setup (their calls
           once each on the setup objects), the dist child's, the dmda,
           mg, assembly and plex paths' as those paths make their first
           calls.  The line comes after the plex phase.  Each path then
           takes its winners: the general and wide-row SFs launch the
           kernels their plan's winners name, the graph CG captures only
           routes its eager chunks' winners named, and the dist path
           launches its plan's winners.
  kernels  every kernel entry point against its plain PyTorch version on the
           card, at the main path's shapes and over a sweep of units, dtypes
           and ops (bitwise, except ``spmv_ell``: max|d| <= 1e-5 max|y|);
           device times of kernel (warm and with L2 scrubbed), plain version
           and one library call; both gather and both segment-reduce variants
           on wide rows.  ``pack``, ``pack_blocked`` and ``bcast_fused``
           also against their first kernels (the generic loop) on the same
           inputs (``prev_ms``, in turns), ``pack`` with each chunk size
           forced and with plain stores (``variants_ms``), ``pack_blocked``
           at the general SF's
           4,194,304-row bcast pack (unit () and (3,), with the index sorted as
           a control) and at three CTA tiles, ``bcast_fused`` beside the
           two-call ``index_select`` + ``index_copy`` composition and in a
           warm-against-cold study (fresh or preallocated output, plain or
           evict-first stores and loads, the write-back each leaves behind);
           the sweep adds ragged row counts and bases off the 16-byte alignment
           for both, and ``pack`` at rows of 256-16,388 bytes (multiples of
           16 and 2-6 bytes past one), sources 0-8 bytes off the 16-byte
           alignment, an output off it, int8 / bool / bf16 / f32 / f64,
           1-4,097 rows, unchecked and checked instances.  ``pack_strided`` at five shapes (``strided_shapes``):
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
           ``segment_reduce_blocked`` also sums the general SF's reduce in
           float16 and int64 (``dtype_shapes``), and the sweep holds every
           segment-reduce dtype (int8, uint8, int16, int64, float16 beside
           the first four) bitwise with ragged and empty segments.  Both
           segment-reduce rows give their main path's longest segment and
           route (the short one), and ``long_cut_sweep`` times a segment of
           64-4,096 rows alone and beside 262,144 short ones on the short
           and the long route (the table ``LONG_SEG`` comes from).
  sf_ops   ``SFComm(backend="cuda")`` against ``SFComm(backend="global")``;
           then the fixed_rule path: the wide-row bcast and reduce and the
           general reduce again with ``REPRO_SF_AUTOTUNE=0``, bitwise the
           tuned calls, its launches counted apart from the sf path's.
  spmv_cg  SpMV / SpMV^T against scipy in float64, then both CG loops on the
           Poisson matrix through the ELL kernel (``cg_loops``): the
           host-stepped ``cg`` and ``cg_async``, replayed as a CUDA graph,
           each solve timed twice in turns, the graph's capture timed apart,
           the graph against its guarded chunks run eagerly, and a profiled
           20-iteration window of each loop (launch counters against the
           profiler's kernels; a replay counts its captured launches).
  dmda     the structured-grid path: a 128^3 DMDA over 2x2x2 ranks, box
           stencil, width 1 (PETSc's ``snes/tutorials/ex19.c`` multi-dof
           exchange in 3D), in both interior modes: five fields (f32 (3,),
           f32, f32, int32, bf16, NaN payload bits) through ``bcast_multi``
           (a 6-column uint32 carrier and a bf16 group) bitwise against the
           grid's geometry, ``reduce_multi`` sum against ``np.add.at`` in
           float64 and bitwise between runs and against the global
           backend, one pack (and segment reduce) per group, and the fused
           bundle against five sequential bcasts in turns; then the star
           stencil's ``ParCSR.from_dmda_stencil`` (``ksp/tutorials/ex45.c``:
           2,097,152 unknowns) against scipy, ``diagonal()``, and
           ``cg_loops`` on it.
  mg       geometric-multigrid-preconditioned CG (``ksp/tutorials/ex45.c``
           with ``-pc_type mg`` and Galerkin coarse operators): a 129^3
           star-stencil DMDA over 2x2x2 ranks (2,146,689 unknowns),
           ``Multigrid(nlevels=5)`` (129 -> 65 -> 33 -> 17 -> 9; the 729-point
           coarsest level through a dense pinv), V(1,1) Jacobi at 2/3.  Each
           Galerkin operator against scipy's P^T A P (float64, 1e-4; P built
           apart from ``Transfer``), prolong / restrict against P x / P^T x
           and inject exactly, one V-cycle on the card against its CPU twin
           (1e-4 max|v|) and against itself (bitwise); then host ``cg(M=)``
           and graph ``cg_async(M=)`` in turns (same count, true relative
           residual <= 1e-4 at tol 1e-5, at most half of plain CG's
           iterations), the graph against its eager chunks (bitwise), each
           setup stage's host seconds, capture ms, the V-cycle's device ms
           (a graph replay) and its kernels, its SF events, and a profiled
           10-iteration window of each loop.
  assembly stash assembly (``MatSetValues`` with off-process rows, paper
           §6.4): every rank of the 129^3 DMDA adds the 7-point operator as
           edge elements (6,390,144 edges); the matrix bitwise equal to
           ``from_dmda_stencil`` and to an ``np.add.at`` oracle, exactly one
           SFReduce per ``assemble()`` (sflog), a second ``assemble()``
           reusing the flush SF; ``assemble_coo`` stash and fetch (whose
           counting SF has roots of ~3 M leaves) give the same matrix; the
           fetch path's counting fold (``fetch_fold``: 8 segments of ~3.2 M
           int32 rows through ``segment_reduce_blocked``'s long route,
           again in float32, and one 2^22-row segment under max / min /
           sum) beside its bounds, the short route alone on the same input
           (``prev_ms``), ``index_add_`` and ``segment_reduce``.
  plex     ``DMPlexDistribute`` / ``DMPlexDistributeOverlap`` (paper §6.3):
           a periodic 64^3 hex mesh over 8 ranks from the ``seq`` and
           ``rand`` layouts, balanced, cones and labels carried bitwise;
           the vertex SF's ghost assembly (8 cells a vertex); one- and
           two-level overlaps against a breadth-first oracle, and the
           overlap ``DMGlobalToLocal`` of the cell ids.
  dist     (run first, in a child process: ``chip_smoke.py --dist DEVICE
           GRID ITERS``, whose launch counts are the path's; run late in
           this process its torch.profiler windows lost device events)
           the distributed backend on an NCCL process group of one rank
           (a ``file://`` store in a temporary directory, destroyed after):
           the 128^3 Poisson matrix's column-gather SF (2,097,152 roots,
           14,581,760 leaves, one a nonzero, Lmax 7; MatMultTranspose's
           SFReduce), bcast replace / sum, reduce sum / max / min / replace
           at units () and (3,) and fetch-and-add on int32, through
           ``SFComm(backend="dist")`` and ``DistSF``, under the SF's own
           ``local_only`` lowering (no collective) and ``"general"`` (an
           all-to-all), each bitwise against ``"cuda"`` on the same SF and
           against ``DistSF(use_kernels=False)``; device and call ms of each
           op on both backends (``reduce_sum_device_ratio_to_cuda``), the
           world-1 collectives alone, and bcast_begin / ``spmv_ell`` /
           bcast_end against ``sync_mode=True``.
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
  moe      runtime-routed star forests and MoE serving, after qwen3-4b is
           freed: (a) ``DynPlan`` at 2^16 roots and 2^18 leaves (duplicate
           writers, unrouted roots, 10% drops), unit (4096,) bf16 and ()
           f32: fresh and keep-prior bcast, the unique reduce with and
           without rootdata, leaf_rep 2 and 8, the general sum and max,
           each bitwise against the same call on the plain versions
           (``plain_kernels``), the general reduce bitwise against
           ``SFComm`` on the routing's SF, and a leaf_root of nroots + 1
           failing each route in a child process
           (``--out-of-range ROUTE DEVICE``; also ``pack(dynamic=True)``
           itself on 8,194-byte rows); (b) phi3.5-moe's MoE layer at
           full width in float32: SF against dense (rtol 1e-5, atol 1e-6)
           at decode (8, 1), prefill (1, 1024) and a starved prefill (cf
           0.3, which must drop picks), SF with kernels against SF with
           plain gathers bitwise, both SF lowerings under
           ``torch.cuda.set_sync_debug_mode("error")``; (c) kimi-k2's
           384-expert layer with its shared expert at full width in bf16,
           kernels against plain gathers bitwise; (d) phi3.5-moe at full
           width, 16 of its 32 layers in bf16: one engine stream at batch 1
           against direct greedy decoding (float32, 2 layers), then the
           serve phase's trace through ``ServeEngine(batch=8,
           s_max=2048)`` + ``loadgen.drive``: metrics, the plan cache's hit
           rate, launches, profiled windows of a prefill and of five
           decode steps with device ms by kernel group.  Every gather of
           (b)-(d) is timed on its own inputs beside ``index_select`` and
           its bound, ``pack``'s also beside its first kernel (``prev_ms``)
           and each chunk size (``moe_shapes`` of the ``pack`` /
           ``pack_blocked`` rows), and both dispatch lowerings at both
           serving shapes (``fuse_switch``).

  families (in a child process: ``chip_smoke.py --families DEVICE``, which
           prints one ``FAMILIES_RESULT`` JSON line) the model families of
           the twelfth slice, bf16, random weights from seeded generators,
           each freed before the next: hymba-1.5b at its published width
           and depth (32 layers) through ``ServeEngine(batch=8,
           s_max=4096)`` + ``loadgen.drive`` on 16 requests (prompts
           64-3,000 tokens, past the sliding layers' 2,048-key window;
           16-64 new tokens), prefill(2,500) against prefill + decode_step,
           a batch-1 engine stream against direct greedy decoding (float32,
           2 layers, a 2,100-token prompt), profiled windows of the
           longest prefill and of five decode steps by kernel group;
           whisper-base (6 + 6 layers) on (8, 1,500, 512) frame
           embeddings: every flash call of a prefill (encoder, cross-
           attention) against the plain version, prefill against decode,
           prefill and 64 decode steps; xlstm-350m (24 layers, no kernel):
           decode after a 300-token prefill against forward of 301,
           prefill 8 x 512 and 32 decode steps; llava-next-34b at full
           width, 16 of 60 layers: prefill from ``embed[tokens]`` bitwise
           the prefill from tokens, then from 2,880 visual embeddings.
           Row 8 at hymba's and whisper's shapes beside SDPA
           (``family_shapes`` on the kernels line).  The counted drives
           (hymba's engine, whisper's prefill and decode, xlstm's,
           llava's prefill) are the families path.
  long_sweep  the long segment reduce (segments over ``LONG_SEG`` rows)
           of both wrappers bitwise, NaN payloads included, against the
           plain version: every dtype and op at units (), (3,) and (2, 2),
           256- and 300-element rows, segments at the cut and the chunk
           edges beside short, empty, overlapping and unsorted ones
           (``long_case``).  Last, because its plain folds' ~4 M small
           launches leave torch.profiler on the card returning windows
           without all their device events.

Ten paths carry the kernels: ``sf_ops`` + ``spmv_cg`` (the SF kernels),
``fixed_rule`` (the fixed rule's wide gather and one-segment-a-CTA
reduce, which the tuned paths launch only where a sweep picks them),
``dmda`` (a gather, a segment reduce, ``spmv_ell``), ``mg`` (the same),
``assembly`` (a gather, a segment reduce), ``plex`` (a gather), ``dist``
(a gather, a segment reduce), the serve phase's drive
(``flash_attention``), the moe phase's drive (``pack``, ``pack_blocked``,
``flash_attention``) and the families phase's drives
(``flash_attention``).  A gather is ``pack`` or ``pack_blocked`` and a
segment reduce ``segment_reduce_sorted`` or ``segment_reduce_blocked``,
as the tuner's winners name them (``PACK``, ``SEGRED``).  Every launch
counter is set to 0 just before each path and read just after, each
kernel must have launched on its path and every kernel on some path; a
kernel's ``launches_by_path`` are those counts and its ``launches`` their
sum.
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
# each path's kernels; a tuple is a tuned kind's kernels, of which the
# path launches the ones its signatures' winners name (PACK, SEGRED)
PACK = ("pack", "pack_blocked")
SEGRED = ("segment_reduce_sorted", "segment_reduce_blocked")
SF_PATH = (PACK, "pack_strided", "bcast_fused", SEGRED, "spmv_ell")
DMDA_PATH = (PACK, SEGRED, "spmv_ell")
SERVE_PATH = ("flash_attention",)
MG_PATH = (PACK, SEGRED, "spmv_ell")
ASSEMBLY_PATH = (PACK, SEGRED)
PLEX_PATH = (PACK,)
MOE_PATH = ("pack", "pack_blocked", "flash_attention")
DIST_PATH = (PACK, SEGRED)
FAMILIES_PATH = ("flash_attention",)
# MoE layer, dispatch="sf" against dispatch="dense", float32: the
# reference's tests/test_models.py:127-159
MOE_RTOL, MOE_ATOL, MOE_AUX_RTOL = 1e-5, 1e-6, 1e-6
# profiled serving windows: a kernel's group is the first whose name holds
# one of its words; the rest are "other"
KERNEL_GROUPS = (
    ("flash_attention", ("flash_fwd",)),
    ("sf_gathers", ("gather_rows_kernel", "rows_copy_kernel",
                    "lanes_copy_kernel", "wide_gather_kernel")),
    ("segment_reduce", ("segment_reduce",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("routing", ("sort", "topk", "radix", "search", "scatter", "index",
                 "gather", "arange")),
)


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
    dmda_grid: int = 128          # DMDA edge (the halo and CG configs)
    mg_grid: int = 129            # mg and assembly DMDA edge (odd: coarsens)
    mg_levels: int = 5            # 129 -> 65 -> 33 -> 17 -> 9
    mg_maxiter: int = 100
    plex_mesh: int = 64           # periodic hex mesh edge (cells = edge^3)
    dist_grid: int = 128          # the dist phase's Poisson grid edge
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
    # moe: phi3.5-moe at full width in bf16, 16 of its 32 layers (41.6 GB
    # of blocks; 32 layers, 84 GB, do not fit in 80 GB), kimi-k2's 384-expert
    # layer alone, and DynPlan at dispatch scale (moe_smoke=True: the
    # smoke configs, for rehearsals on the CPU)
    moe_arch: str = "phi3.5-moe-42b-a6.6b"
    moe_wide_arch: str = "kimi-k2-1t-a32b"
    moe_smoke: bool = False
    moe_layers: int = 16
    moe_prefill: int = 1024       # the layer checks' prefill tokens
    moe_decode_batch: int = 8
    dyn_roots: int = 1 << 16      # DynPlan checks: expert slots
    dyn_leaves: int = 1 << 18     # picks
    dyn_width: int = 4096         # bf16 hidden rows (phi's d_model)
    hub_rows: int = 1 << 22       # fetch_fold's one-segment max / min / sum
    # families: hymba-1.5b served at its published size, whisper-base and
    # xlstm-350m at theirs, llava-next-34b at full width and llava_layers
    # of its 60 layers, all in bf16 (families_smoke=True: the smoke configs
    # at small sizes, for rehearsals on the CPU)
    families_smoke: bool = False
    hymba_batch: int = 8
    hymba_s_max: int = 4096
    hymba_requests: int = 16
    hymba_prompt: tuple = (64, 3000)  # the sliding layers' 2,048 keys bite
    hymba_new: tuple = (16, 64)
    hymba_check_prompt: int = 2500
    hymba_short_scan: int = 100       # an SSM scan shorter than a chunk
    hymba_stream_prompt: int = 2100   # the float32 engine-vs-greedy stream
    whisper_batch: int = 8
    whisper_frames: int = 1500        # whisper's 30 s window
    whisper_prompt: int = 4
    whisper_s_max: int = 448          # whisper's decoder context
    whisper_steps: int = 64
    xlstm_batch: int = 8
    xlstm_prefill: int = 512
    xlstm_steps: int = 32
    xlstm_check: int = 300            # not a multiple of 128
    llava_layers: int = 16            # 19.6 GB of 60 layers' 68.8
    llava_tokens: int = 2880          # LLaVA-NeXT anyres: 5 x 576


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def missing_kernels(path: tuple, counts: dict) -> list:
    """The entries of ``path`` (a kernel, or a tuple of a tuned kind's
    kernels, any of which will do) that launched no time in ``counts``."""
    return [k for k in path
            if not any(counts[n] for n in ((k,) if isinstance(k, str)
                                           else k))]


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


def same_raw_bits(a, b) -> bool:
    """Bitwise equality, NaN payloads included."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(a.contiguous().view(view),
                            b.contiguous().view(view)))


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
    raise AssertionError(f"torch.profiler returned no whole window of "
                         f"{calls} calls in {1 + len(RETAKE_WAITS_S)} tries; "
                         f"the last counted {counts}")


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


def graph_ms(fn, dev, iters: int) -> float:
    """Mean device milliseconds per ``fn()`` with the host out of the way:
    ``fn`` captured once into a CUDA graph (after a side-stream warm-up)
    and replayed ``iters`` times between CUDA events, its kernels back to
    back (the host's time per call on the CPU).  The launch counters count
    the replays' launches, not the capture's."""
    import torch
    from repro_torch.kernels import ops as kops
    if dev.type != "cuda":
        return call_ms(fn, dev, iters)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    before = kops.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    captured = {k: v - before[k] for k, v in kops.launch_counts().items()}
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    kops.add_launches(captured, iters)     # 1 + iters replays, 1 capture
    del graph
    return start.elapsed_time(end) / iters


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
    recs["pack"].update(gather_against_prev(root, widx, dev, it,
                                            kernel="pack"))
    recs["pack"]["variants_ms"] = wide_variants(root, widx, dev, it)
    sv = sf_pack.pack_plain(leaf, wide._k_gl_sorted)
    st, ln = wide._unpack.seg_first, wide._unpack.seg_len
    S = st.numel()
    ln64 = ln.long()
    record("segment_reduce_sorted",
           lambda: sf_unpack.segment_reduce_sorted(sv, st, ln, op="sum"),
           lambda: sf_unpack.segment_reduce_plain(sv, st, ln, "sum"),
           lambda: torch.segment_reduce(sv, "sum", lengths=ln64),
           sv.numel() * 4 + S * (8 + rb))
    recs["segment_reduce_sorted"].update(short_route(sv, st, ln))

    wide_ms = wide_row_variants(objs["wide"], wide, g, dev, it)

    # segment_reduce_blocked: the general SF's reduce (sum) unpack
    gleaf = torch.randn(objs["gen"].nleafspace_total, generator=g, device=dev)
    gsv = sf_pack.pack_plain(gleaf, gen_be._k_gl_sorted)
    gst, gln = gen_be._unpack.seg_first, gen_be._unpack.seg_len
    gln64 = gln.long()
    run_seg = lambda: sf_unpack.segment_reduce_blocked(
        gsv, gst, gln, segs_per_block=kops.SEG_BLOCK, op="sum")
    record("segment_reduce_blocked", run_seg,
           lambda: sf_unpack.segment_reduce_plain(gsv, gst, gln, "sum"),
           lambda: torch.segment_reduce(gsv, "sum", lengths=gln64),
           gsv.numel() * 4 + gst.numel() * 12)
    check(same_bits(run_seg(), run_seg()), "segment reduce not bitwise "
          "identical run to run")
    recs["segment_reduce_blocked"].update(short_route(gsv, gst, gln))
    recs["segment_reduce_blocked"]["dtype_shapes"] = segment_dtype_shapes(
        gsv, gst, gln, dev, it)
    recs["segment_reduce_blocked"]["long_cut_sweep"] = long_cut_sweep(dev,
                                                                      it)

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


def short_route(sv, st, ln) -> dict:
    """The longest segment and route of a main-path segment reduce, which
    must be the short one (the one-thread-a-segment kernel, unchanged)."""
    from repro_torch.kernels import sf_unpack
    from repro_torch.kernels._index import segment_meta
    lmax = segment_meta(st, ln, sv.device)[3]
    route = sf_unpack.reduce_route(lmax, sv.dtype, "sum")
    check(route == "short", f"a main-path segment reduce (Lmax {lmax}) "
          f"took the {route} route")
    return {"lmax": lmax, "route": route, "long_seg": sf_unpack.LONG_SEG}


def segment_dtype_shapes(sv, st, ln, dev, it: int) -> list:
    """segment_reduce_blocked's sum at the general SF's reduce (4,194,304
    rows, 1 M segments) in float16 and int64, two of the dtypes added for
    the structured-grid slice: kernel against plain bitwise, device ms warm
    and with L2 scrubbed, bound, and one library call (``segment_reduce``
    for float16; ``index_add_`` over the segment ids for int64, which
    ``segment_reduce`` does not take)."""
    import torch
    from repro_torch.kernels import ops as kops, sf_unpack
    S, M = st.numel(), sv.shape[0]
    ln64 = ln.long()
    seg_ids = torch.repeat_interleave(torch.arange(S, device=dev), ln64)
    out = []
    for dt in (torch.float16, torch.int64):
        buf = sv.to(dt) if dt.is_floating_point else (sv * 1000).to(dt)
        run = lambda: sf_unpack.segment_reduce_blocked(
            buf, st, ln, segs_per_block=kops.SEG_BLOCK, op="sum")
        plain = lambda: sf_unpack.segment_reduce_plain(buf, st, ln, "sum")
        check(same_bits(run(), plain()),
              f"segment_reduce_blocked {dt}: kernel != plain version")
        if dt.is_floating_point:
            library = lambda: torch.segment_reduce(buf, "sum", lengths=ln64)
            lib_name = "torch.segment_reduce"
        else:
            library = lambda: torch.zeros(S, dtype=dt, device=dev).index_add_(
                0, seg_ids, buf)
            lib_name = "torch.zeros().index_add_"
        check(max_abs(library(), plain()) <= (
            0 if not dt.is_floating_point else
            2e-2 * float(plain().abs().max())), f"library sum {dt} disagrees")
        rb = buf.element_size()
        bms, by = bound(M * rb + S * (8 + rb))
        out.append({"dtype": str(dt)[6:], "rows": M, "segments": S,
                    "ms": device_ms(run, dev, it),
                    "ms_cold_l2": cold_device_ms(run, dev, it),
                    "plain_ms": device_ms(plain, dev, it),
                    "library": lib_name, "library_ms": device_ms(
                        library, dev, it),
                    "bound_ms": bms, "bound_by": by})
    return out


def in_turns(run, prev, dev, it: int):
    """(min, runs) of ``run`` and of ``prev``, each timed twice in turns:
    run, prev, prev, run."""
    ms = [device_ms(run, dev, it)]
    prev_ms = [device_ms(prev, dev, it), device_ms(prev, dev, it)]
    ms.append(device_ms(run, dev, it))
    return (min(ms), ms), (min(prev_ms), prev_ms)


def gather_against_prev(data, idx, dev, it: int,
                        kernel: str = "pack_blocked") -> dict:
    """``kernel`` (``pack_blocked`` or ``pack``) against its first kernel,
    the generic loop (at 64 rows per CTA for ``pack_blocked``, one row per
    CTA for ``pack``), on the same inputs: both warm in turns and with L2
    scrubbed, and the launch plan the kernel took."""
    from repro_torch.kernels import ops as kops, sf_pack
    if kernel == "pack":
        run = lambda: sf_pack.pack(data, idx)
        rows_per_cta = 1
        plan_of = lambda out: sf_pack.pack_plan(data, idx, out)
    else:
        run = lambda: sf_pack.pack_blocked(data, idx,
                                           block_rows=kops.PACK_BLOCK_ROWS)
        rows_per_cta = 64
        plan_of = lambda out: sf_pack.gather_plan(data, idx, out,
                                                  kops.PACK_BLOCK_ROWS)
    prev = lambda: sf_pack.gather_generic(data, idx,
                                          rows_per_cta=rows_per_cta)
    check(same_bits(prev(), run()), f"generic gather != {kernel}")
    (ms, ms_runs), (prev_ms, prev_runs) = in_turns(run, prev, dev, it)
    return {"ms_in_turns": ms, "ms_runs": ms_runs, "prev_ms": prev_ms,
            "prev_ms_runs": prev_runs,
            "prev_ms_cold_l2": cold_device_ms(prev, dev, it),
            "prev_source": "sf_gather_rows, " + (
                "one row" if rows_per_cta == 1 else f"{rows_per_cta} rows")
            + " per CTA (generic loop)",
            "plan": dataclasses.asdict(plan_of(run()))}


def wide_variants(data, idx, dev, it: int, dynamic: bool = False,
                  timer=None) -> dict:
    """Device ms of ``pack``'s wide gather with each chunk size K = 1-4
    forced and with plain (not evict-first) stores
    (``sf_pack.wide_variant``; each bitwise against ``pack`` first), and
    the K its plan picks: the readings behind ``wide_plan``'s choices."""
    from repro_torch.kernels import sf_pack
    timer = timer or device_ms
    want = sf_pack.pack(data, idx, dynamic=dynamic)
    out = {"plan_K": sf_pack.pack_plan(data, idx, want).K}
    runs = {str(K): lambda K=K: sf_pack.wide_variant(
        data, idx, K=K, dynamic=dynamic)
        for K in range(1, sf_pack.WIDE_MAX_K + 1)}
    runs["plain_stores"] = lambda: sf_pack.wide_variant(
        data, idx, dynamic=dynamic, plain_stores=True)
    for name, run in runs.items():
        check(same_bits(run(), want), f"pack variant {name} != pack")
        out[name] = timer(run, dev, it)
    return out


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
    idx, st, ln = be._k_gr, be._unpack.seg_first, be._unpack.seg_len
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
    # the MoE path's rows on the runtime-index route: 8,192-byte hidden
    # rows, the decode's fused 8,194-byte rows (hidden state + gate weight:
    # 2 bytes past a 16-byte multiple) and kimi's 14,338; int64 and int32
    # indices, and a source off the 16-byte alignment
    for width in (4096, 4097, 7169):
        data = rand((41, width), torch.bfloat16)
        for idx in (torch.as_tensor(rng.integers(0, 41, 33), device=dev),
                    torch.as_tensor(rng.integers(0, 40, 16), device=dev,
                                    dtype=torch.int32)):
            sub, sidx = data[1:], idx[idx < 40]
            for got, ref in (
                    (sf_pack.pack(data, idx, dynamic=True),
                     sf_pack.pack_plain(data, idx)),
                    (sf_pack.pack_blocked(data, idx, block_rows=64,
                                          dynamic=True),
                     sf_pack.pack_plain(data, idx)),
                    (sf_pack.pack(sub, sidx, dynamic=True),
                     sf_pack.pack_plain(sub, sidx))):
                check(same_bits(got, ref), f"pack dynamic ({width},) bf16")
                cases += 1
    cases += strided_sweep(dev, rng)
    cases += pack_sweep(dev, rng)
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
    # the dtypes added with the structured-grid slice: integers over their
    # whole range (sums and products wrap), float16
    def seg_rand(shape, dt):
        if dt.is_floating_point or dt == torch.int32:
            return rand(shape, dt)
        info = torch.iinfo(dt)
        return torch.as_tensor(rng.integers(info.min, info.max, shape,
                                            endpoint=True), device=dev
                               ).to(dt)

    seg_dtypes = dtypes + [torch.int8, torch.uint8, torch.int16, torch.int64,
                           torch.float16]
    for unit in [(), (3,), (2, 2)]:
        for dt in seg_dtypes:
            for op in ["sum", "prod", "max", "min"]:
                buf = seg_rand((M,) + unit, dt)
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


SEG_DTYPES = ("float32", "float64", "bfloat16", "float16", "int8", "uint8",
              "int16", "int32", "int64")
SEG_OPS = ("sum", "prod", "max", "min")
# NaN bit patterns with distinct payloads (the last with the sign bit set)
NAN_BITS = {"float32": (0x7FC00001, 0x7FC00A02, 0xFFC00003),
            "float64": (0x7FF8000000000001, 0x7FF80000000A0002,
                        0xFFF8000000000003),
            "bfloat16": (0x7FC1, 0x7FD2, 0xFFC3),
            "float16": (0x7E01, 0x7E52, 0xFE03)}


def _signed(bits: int, nbytes: int) -> int:
    return bits - (1 << 8 * nbytes) if bits >> (8 * nbytes - 1) else bits


def long_case(dtype: str, op: str, rng, dev, width: int = 4):
    """A ``(rows, width)`` buffer of ``dtype`` and unsorted (start, len)
    pairs for the long route: segments of the cut's length and one more,
    of C - 1, C and C + 1 rows (C the chunk rows), one of the cut's length
    plus one inside another, a long one of identities, 200 short and empty
    ones; in float max / min runs NaNs with distinct payloads (one on a
    chunk's first row), a run of -0 / +0 among values that never reach 0,
    and +-inf; integers over their whole range (odd for prod: products
    that wrap and stay non-zero).  The plain version's Lmax is C + 1."""
    import torch
    from repro_torch.kernels import sf_unpack
    cut, C = sf_unpack.LONG_SEG, sf_unpack.LONG_CHUNK_ROWS
    longs = [(0, C + 1), (C + 4, C), (2 * C + 9, C - 1), (5, cut + 1),
             (3 * C + 20, cut), (3 * C + 40 + cut, cut + 1)]
    M = 3 * C + 60 + 2 * cut
    tdt = getattr(torch, dtype)
    if tdt.is_floating_point:
        vals = rng.standard_normal((M, width))
        if op == "prod":
            vals = 1 + 0.01 * vals
        buf = torch.as_tensor(vals, device=dev).to(tdt)
        if op in ("max", "min"):
            iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                buf.element_size()]
            for row, bits in zip((700, 5000, C), NAN_BITS[dtype]):
                buf.view(iv)[row, row % width] = _signed(
                    bits, buf.element_size())
            # the extremum is 0, reached first by a -0 or a +0
            a, b = C + 4, 2 * C + 4
            run = -torch.as_tensor(np.abs(vals[a:b]) + 1, device=dev)
            buf[a:b] = (run if op == "max" else -run).to(tdt)
            zeros = rng.choice(np.arange(a + 50, b), 40, replace=False)
            signs = rng.choice([-1.0, 1.0], (40, width))
            buf[torch.as_tensor(zeros, device=dev)] = torch.as_tensor(
                signs * 0.0, device=dev).to(tdt)
        inf = rng.choice(np.arange(2 * C + 9, 3 * C + 8), 30, replace=False)
        buf[torch.as_tensor(inf, device=dev)] = torch.as_tensor(
            rng.choice([-np.inf, np.inf], (30, width)), device=dev).to(tdt)
    else:
        info = torch.iinfo(tdt)
        vals = rng.integers(info.min, info.max, (M, width), endpoint=True)
        if op == "prod":
            vals |= 1
        buf = torch.as_tensor(vals, device=dev).to(tdt)
    ident = {"sum": 0, "prod": 1}.get(op)
    if ident is None:
        ident = (-math.inf if op == "max" else math.inf) \
            if tdt.is_floating_point else \
            (torch.iinfo(tdt).min if op == "max" else torch.iinfo(tdt).max)
    a = 3 * C + 40 + cut
    buf[a:a + cut + 1] = ident
    short = [(int(rng.integers(0, M - 8)), int(rng.integers(0, 9)))
             for _ in range(200)]
    pairs = longs + short
    order = rng.permutation(len(pairs))
    st = torch.as_tensor([pairs[i][0] for i in order], dtype=torch.int32,
                         device=dev)
    ln = torch.as_tensor([pairs[i][1] for i in order], dtype=torch.int32,
                         device=dev)
    return buf, st, ln


def long_sweep(dev, rng) -> int:
    """The long route of both segment-reduce wrappers bitwise, NaN payloads
    included, against the plain version on ``long_case`` buffers: every
    dtype and op at units (), (3,) and (2, 2) (one plain fold of the 4-wide
    buffer holds all three), int32 max on 256-element rows and float32 sum
    on 300-element ones.
    Returns the number of cases (none on the CPU, where every wrapper is
    the plain version)."""
    from repro_torch.kernels import sf_unpack
    cases = 0
    if dev.type != "cuda":
        return cases
    runs = (lambda b, st, ln, op: sf_unpack.segment_reduce_sorted(
                b, st, ln, op=op),
            lambda b, st, ln, op: sf_unpack.segment_reduce_blocked(
                b, st, ln, segs_per_block=64, op=op),
            lambda b, st, ln, op: sf_unpack.segment_reduce_blocked(
                b, st, ln, segs_per_block=7, op=op))
    for dtype in SEG_DTYPES:
        for op in SEG_OPS:
            buf, st, ln = long_case(dtype, op, rng, dev)
            route = sf_unpack.reduce_route(int(ln.max()), buf.dtype, op)
            check(route == ("split" if sf_unpack.order_free(buf.dtype, op)
                            else "ordered"), f"{dtype} {op}: {route} route")
            want = sf_unpack.segment_reduce_plain(buf, st, ln, op)
            for unit, b, w in (
                    ((), buf[:, 0].contiguous(), want[:, 0]),
                    ((3,), buf[:, :3].contiguous(), want[:, :3]),
                    ((2, 2), buf.reshape(-1, 2, 2), want.reshape(-1, 2, 2))):
                for run in runs:
                    check(same_raw_bits(run(b, st, ln, op), w),
                          f"long segment reduce {op} {unit} {dtype}")
                    cases += 1
    # 256 int32: the vector-rows pass; 300 float32: the ordered route's
    # unit tiles (rows wider than a CTA)
    for dtype, op, width in (("int32", "max", 256), ("float32", "sum", 300)):
        buf, st, ln = long_case(dtype, op, rng, dev, width=width)
        want = sf_unpack.segment_reduce_plain(buf, st, ln, op)
        for run in runs:
            check(same_raw_bits(run(buf, st, ln, op), want),
                  f"long segment reduce {op} ({width},) {dtype}")
            cases += 1
    return cases


# pack's sweep: row widths (multiples of 16, 2 / 4 / 6 bytes past one,
# the MoE path's 8,194 / 14,338 / 16,388-byte fused rows), source views at
# these byte offsets past a 16-byte boundary (those the dtype allows),
# dtypes, and row counts (one row, a decode step's 31 / 32 rows, 4,097)
PACK_SWEEP_ROW_BYTES = (256, 258, 1020, 1024, 1030, 8192, 8194, 14338,
                        16388)
PACK_SWEEP_OFFSETS = (0, 1, 2, 4, 8)
PACK_SWEEP_DTYPES = ("int8", "bool", "bfloat16", "float32", "float64")
PACK_SWEEP_ROWS = (1, 31, 32, 4097)
PACK_SWEEP_SOURCE_ROWS = 64


def pack_sweep_width(rb: int, dev, rng) -> int:
    """``pack`` on rows of ``rb`` bytes bitwise (as bytes) against
    ``pack_plain``: every dtype of PACK_SWEEP_DTYPES whose element divides
    ``rb``, sources at each offset of PACK_SWEEP_OFFSETS that the element
    allows, each row count of PACK_SWEEP_ROWS, the unchecked and the
    checked (``dynamic=True``) instance; and into an output one element
    off the 16-byte alignment (``wide_variant(out=...)``).  Returns the
    number of cases."""
    import torch
    from repro_torch.kernels import sf_pack
    N, cases = PACK_SWEEP_SOURCE_ROWS, 0
    raw = torch.as_tensor(rng.integers(0, 256, N * rb + 16), device=dev
                          ).to(torch.uint8)
    for name in PACK_SWEEP_DTYPES:
        dt = getattr(torch, name)
        es = torch.empty(0, dtype=dt).element_size()
        if rb % es:
            continue
        buf = raw & 1 if dt == torch.bool else raw
        for off in PACK_SWEEP_OFFSETS:
            if off % es:
                continue
            data = buf[off: off + N * rb].view(dt).view(N, rb // es)
            check(data.data_ptr() % 16 == off, "sweep source offset")
            for M in PACK_SWEEP_ROWS:
                idx = torch.as_tensor(rng.integers(0, N, M), device=dev,
                                      dtype=torch.int32)
                want = sf_pack.pack_plain(data, idx).view(torch.uint8)
                for dynamic in (False, True):
                    got = sf_pack.pack(data, idx, dynamic=dynamic)
                    check(torch.equal(got.view(torch.uint8), want),
                          f"pack {rb} B {name} +{off} M={M} "
                          f"dynamic={dynamic}")
                    cases += 1
                if off == 0:
                    obuf = torch.zeros(M * rb + 16, dtype=torch.uint8,
                                       device=dev)
                    out = obuf[es: es + M * rb].view(dt).view(M, rb // es)
                    sf_pack.wide_variant(data, idx, out=out)
                    check(torch.equal(out.view(torch.uint8), want)
                          and not obuf[:es].any()
                          and not obuf[es + M * rb:].any(),
                          f"pack {rb} B {name} into an output +{es} M={M}")
                    cases += 1
    return cases


def pack_sweep(dev, rng) -> int:
    return sum(pack_sweep_width(rb, dev, rng) for rb in PACK_SWEEP_ROW_BYTES)


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
        root_g, leaf_g = root, leaf          # the (3,) pair, kept below
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
    want = plan_kernels(cu.backend._key)
    check(not on_card or (want <= moved and moved & set(PACK)
                          and moved & set(SEGRED)),
          f"general SF ops launched {sorted(moved)}, their winners name "
          f"{sorted(want)}")

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

    # wide rows: the kernels the winners name (the fixed rule: one row / one
    # segment per CTA)
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
    want = plan_kernels(wcu.backend._key)
    check(not on_card or moved == want, f"wide-row ops launched "
          f"{sorted(moved)}, their winners name {sorted(want)}")
    out["wide_row_kernels"] = sorted(moved)
    # the fixed_rule path: the same calls with REPRO_SF_AUTOTUNE=0 (the
    # winners set aside), the same bits, through one row / one segment per
    # CTA; its launches are counted from 0 and reported as a path of their
    # own (out["fixed_rule_launches"]), the sf path's counts put back
    tuned = (wcu.bcast(root, leaf), wcu.reduce(leaf, root, "sum"),
             cu.reduce(leaf_g, root_g, "sum"))
    saved = kops._saved_counts()
    kops.reset_launch_counts()
    with fixed_rule():
        fixed = (wcu.bcast(root, leaf), wcu.reduce(leaf, root, "sum"),
                 cu.reduce(leaf_g, root_g, "sum"))
    out["fixed_rule_launches"] = kops.launch_counts()
    kops._restore_counts(saved)
    moved = {k for k, v in out["fixed_rule_launches"].items() if v}
    for a, b, what in zip(tuned, fixed, ("wide bcast", "wide reduce sum",
                                         "general reduce sum (3,)")):
        check(same_raw_bits(a, b), f"{what}: tuned != fixed rule")
    check(not on_card or {"pack", "segment_reduce_sorted"} <= moved,
          f"the fixed rule's wide-row ops launched {sorted(moved)}")
    out["fixed_rule_equals_tuned"] = ["wide bcast", "wide reduce sum",
                                      "general reduce sum (3,)"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["checks"] = "bitwise except float sums (max|d| <= 1e-6 max|y|)"
    return out


# ---------------------------------------------------------------- spmv_cg
def phase_spmv_cg(objs, sz: Sizes, dev) -> dict:
    import scipy.sparse as sp
    import torch
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
    loops = cg_loops(A, S, bh, sz, dev)
    host, graph = loops["cg"], loops["cg_async_graph"]
    return {"phase": "spmv_cg", "backend": A.comm.backend_name,
            "unknowns": n, "spmv_max_abs_err": errs,
            "cg_iters": host["iters"],
            "cg_true_rel_residual": host["true_rel_residual"],
            "cg_ms_per_iter": host["ms_per_iter"],
            "cg_launches_per_iter": host["launches_per_iter"],
            "cg_async_iters": graph["iters"],
            "cg_async_ms_per_iter": graph["ms_per_iter"],
            "cg_async_launches_per_iter": graph["launches_per_iter"],
            **loops}


def cg_solve(run, S, bh, dev) -> dict:
    """One CG solve by ``run()``: iterations, true relative residual (float64,
    scipy), host ms per iteration (synchronized) and kernel launches per
    iteration from the launch counters."""
    import torch
    from repro_torch.kernels import ops as kops
    before = kops.launch_counts()
    gc.collect()
    sync(dev)
    t0 = time.perf_counter()
    res = run()
    sync(dev)
    dt = time.perf_counter() - t0
    it = max(res.iters, 1)
    xs = res.x.double().cpu().numpy()
    check(bool(torch.isfinite(res.x).all()), "CG x not finite")
    return {"iters": res.iters, "converged": res.converged,
            "true_rel_residual": float(np.linalg.norm(bh - S @ xs)
                                       / np.linalg.norm(bh)),
            "ms_per_iter": dt * 1e3 / it, "graph_replays": res.graph_replays,
            "launches_per_iter": {k: (v - before[k]) / it for k, v in
                                  kops.launch_counts().items()
                                  if v != before[k]}, "x": res.x}


def cg_window(run, dev, iters: int, A=None, strict: bool = True) -> dict:
    """A profiled window of ``iters`` CG iterations made by ``run()``: wall
    and device ms, idle share, the top kernels, and (given the operator
    ``A`` whose blocks are every ELL launch) ``spmv_ell`` on the main path
    against the byte bound of the SpMV blocks it streams.  The window
    is taken again until the profiler saw every spmv_ell launch the launch
    counter counted in it (a graph replay counts its captured launches);
    if no try is whole, the run fails, or with ``strict=False`` the last
    try is reported with ``whole`` false (its times are lower bounds)."""
    from repro_torch.kernels import ops as kops
    for wait in (0.0,) + RETAKE_WAITS_S:
        ell0 = kops.spmv_ell.launches
        if dev.type != "cuda":
            by_name, wall = profiled(run, dev)
            ell_launches = kops.spmv_ell.launches - ell0
            break
        time.sleep(wait)
        by_name, counts, wall = _profile(run, dev)
        ell_launches = kops.spmv_ell.launches - ell0
        seen = sum(c for k, c in counts.items() if "spmv_ell_kernel" in k)
        if ell_launches and seen == ell_launches:
            break
        PROFILER_WINDOWS["retaken"] += 1
    else:
        check(not strict, "torch.profiler missed spmv_ell launches of a "
              "profiled CG window in every try")
    busy = sum(by_name.values())
    ell_ms = sum(v for k, v in by_name.items() if "spmv_ell_kernel" in k)
    short = {}                 # kernels summed by the first 60 characters
    for k, v in by_name.items():
        short[k[:60]] = short.get(k[:60], 0.0) + v
    top = sorted(short.items(), key=lambda kv: -kv[1])[:8]
    out = {"iters": iters, "wall_ms": wall, "device_ms": busy,
           "wall_ms_per_iter": wall / iters,
           "device_ms_per_iter": busy / iters,
           "device_idle_share": 1.0 - busy / wall if wall else None,
           "spmv_ell_launches": ell_launches, "spmv_ell_ms": ell_ms,
           "top_kernels_ms": dict(top)}
    if dev.type == "cuda":
        # a window short of its counted launches (strict=False only): its
        # device times are lower bounds
        out["spmv_ell_launches_profiled"] = seen
    if A is not None:          # every ELL launch one of A's blocks
        blocks = A._diag_ell + A._offd_ell
        spmv_bytes = sum(blk.data.numel() * 8 + (blk.n + 1) * 4
                         + blk.data.shape[0] * 4 for blk in blocks)
        out["spmv_ell_bound_ms"] = bound(spmv_bytes)[0] * ell_launches \
            / len(blocks)
    return out


def cg_loops(A, S, bh, sz: Sizes, dev, tol: float = 1e-5) -> dict:
    """Both CG loops on ``A`` to ``tol``: the host-stepped ``cg`` and
    ``cg_async`` (check_every=1), a CUDA graph on the card, each solve
    timed twice in turns (cg, graph, graph, cg); the graph's stages timed
    apart (warm-up and first residual, capture, replays); the graph against
    the same guarded chunks run eagerly (iterations equal, x compared);
    ``check_every=0`` running exactly 50 iterations; a profiled 20-iteration
    window of each loop (the graph's: replays of a chunk captured before
    the window)."""
    import torch
    from repro_torch.solvers import cg, cg_async
    from repro_torch.solvers.cg import (GRAPH_ITERS, _capture, _cg_async,
                                        _prepare, _replay)
    b = torch.as_tensor(bh, device=dev)
    mv = lambda v: A.spmv(v, use_kernel=True)
    host = lambda: cg(mv, b, tol=tol, maxiter=sz.cg_maxiter)
    graph = lambda: cg_async(mv, b, tol=tol, maxiter=sz.cg_maxiter)
    runs = [cg_solve(f, S, bh, dev) for f in (host, graph, graph, host)]
    for r in runs:
        check(r["converged"], f"CG did not converge in {r['iters']}")
        check(r["true_rel_residual"] <= 1e-4,
              f"CG true relative residual {r['true_rel_residual']}")
    check(runs[1]["iters"] == runs[2]["iters"], "graph CG iterations differ "
          "from run to run")
    check(same_bits(runs[1]["x"], runs[2]["x"]), "graph CG x differs from "
          "run to run")
    check(dev.type != "cuda" or runs[1]["graph_replays"] > 0,
          "cg_async did not replay a CUDA graph")
    eager = cg_solve(lambda: _cg_async(mv, b, None, tol,
                                              sz.cg_maxiter, 1, graph=False),
                     S, bh, dev)
    check(eager["iters"] == runs[1]["iters"],
          f"graph CG ran {runs[1]['iters']} iterations, the eager guarded "
          f"chunks {eager['iters']}")
    x_diff = max_abs(eager["x"], runs[1]["x"])
    # the graph's stages, timed apart
    sync(dev)
    t0 = time.perf_counter()
    loop = _prepare(mv, b, None, tol, sz.cg_maxiter, 1)
    sync(dev)
    t1 = time.perf_counter()
    stages = {"prepare_ms": (t1 - t0) * 1e3}
    if dev.type == "cuda":
        g, captured = _capture(loop)
        # the graph launches the routes its eager chunks' winners named
        routes = {k for k, c in captured.items() if c and k in TUNED_NAMES}
        want = plan_kernels(A.comm.backend._key)
        check(routes <= want, f"the graph CG captured "
              f"{sorted(routes)}, its eager chunks' winners name "
              f"{sorted(want)}")
        stages["captured_tuned_routes"] = sorted(routes)
        sync(dev)
        t2 = time.perf_counter()
        replays = _replay(loop, g, captured)
        sync(dev)
        t3 = time.perf_counter()
        it = int(loop.it)
        stages.update({"capture_ms": (t2 - t1) * 1e3,
                       "replay_ms": (t3 - t2) * 1e3, "replays": replays,
                       "iters": it, "replay_ms_per_iter": (t3 - t2) * 1e3
                       / it, "captured_launches_per_chunk": captured,
                       "iters_per_graph": GRAPH_ITERS})
        check(it == runs[1]["iters"], "staged graph CG iterations differ")
    a0 = cg_async(mv, b, tol=tol, maxiter=50, check_every=0)
    check(a0.iters == 50, f"cg_async(check_every=0) ran {a0.iters}")
    check(bool(torch.isfinite(a0.x).all()), "cg_async x not finite")
    # profiled windows of 20 iterations: the host loop, and two replays of
    # a chunk of GRAPH_ITERS guarded iterations captured outside the window
    windows = {"cg": cg_window(lambda: cg(mv, b, tol=0.0, maxiter=20), dev,
                               20, A)}
    if dev.type == "cuda":
        check(20 % GRAPH_ITERS == 0, "window is not whole chunks")
        win = _prepare(mv, b, None, 0.0, 20, 0)
        g, captured = _capture(win)

        def replays():
            win.it.zero_()
            win.go.fill_(True)
            _replay(win, g, captured)
        windows["cg_async_graph"] = cg_window(replays, dev, 20, A)
    for r in runs + [eager]:
        del r["x"]
    return {"cg": runs[0], "cg_async_graph": runs[1],
            "in_turns_ms_per_iter": {"cg": [runs[0]["ms_per_iter"],
                                            runs[3]["ms_per_iter"]],
                                     "cg_async_graph": [
                                         runs[1]["ms_per_iter"],
                                         runs[2]["ms_per_iter"]]},
            "cg_async_eager_chunks": eager,
            "graph_vs_eager_x_max_abs_diff": x_diff,
            "graph_stages": stages,
            "cg_async_check_every_0_iters": a0.iters,
            "profiled_20_iters": windows}


# ------------------------------------------------------------------- dmda
def dmda_fields(n: int, g, dev) -> list:
    """The halo configuration's five fields on ``n`` cells, from the seeded
    generator ``g``: velocity f32 (3,), pressure f32, temperature f32,
    material id int32, density bf16; some float entries carry NaN payload
    bits (quiet and signalling, both signs)."""
    import torch
    f = [torch.randn(n, 3, generator=g, device=dev),
         torch.randn(n, generator=g, device=dev),
         300 + torch.randn(n, generator=g, device=dev),
         torch.randint(0, 64, (n,), generator=g, device=dev,
                       dtype=torch.int32),
         (1 + 0.1 * torch.randn(n, generator=g, device=dev)).to(
             torch.bfloat16)]
    f[0].view(torch.int32)[::997, 1] = 0x7FC01234
    f[1].view(torch.int32)[::1009] = -0x003FFFFF        # 0xFFC00001
    f[2].view(torch.int32)[5::1013] = 0x7F800123         # signalling
    f[4].view(torch.int16)[::991] = 0x7FC1
    return f


def _int_view(t):
    """A tensor's bits as a numpy integer array of its width."""
    import torch
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    return t.contiguous().view(view).cpu().numpy()


def dmda_leaf_map(da, skip: bool):
    """(local positions, global cells) of every local array entry that
    DMGlobalToLocal fills, from the grid's geometry alone: the ghosted box
    of each rank, wrapped, off-domain cells and star corners left as holes,
    and (pure halo, ``skip``) the owned box left out."""
    pos, gid = [], []
    for r in range(da.nranks):
        nat = da.box_coords(da.ghosted_box(r))
        wrapped, valid = da.wrap_coords(nat)
        outside = np.zeros(nat.shape[0], dtype=np.int64)
        for d, (lo, hi) in enumerate(da.owned_box(r)):
            outside += (nat[:, d] < lo) | (nat[:, d] >= hi)
        if da.stencil == "star":
            valid &= outside <= 1
        if skip:
            valid &= outside > 0
        p = np.flatnonzero(valid)
        pos.append(da.local_offsets[r] + p)
        gid.append(da.natural_to_global(wrapped[p]))
    return np.concatenate(pos), np.concatenate(gid)


def exchange_bytes(fields, nglobal: int, nlocal: int, pos, gid) -> float:
    """The least bytes of a functional replace bcast of ``fields``: each
    root cell it reads once, each leaf it keeps read once, the whole leaf
    array written once, and a 4-byte index per edge each way."""
    row = sum(f[:1].numel() * f.element_size() for f in fields)
    return float(row * (np.unique(gid).size + (nlocal - pos.size) + nlocal)
                 + 8 * pos.size)


def halo_variant(da, fields_g, sz: Sizes, dev, g) -> dict:
    """One DMDA halo variant: ``bcast_multi`` of the five fields on the
    kernel backend held bit for bit against the geometry's oracle, the
    fused exchange count and launches per group, ``reduce_multi`` sum
    against an ``np.add.at`` float64 oracle (and bitwise run to run and
    against the global backend), and the fused bundle against five
    sequential bcasts in turns."""
    import torch
    from repro_torch.core import sflog
    from repro_torch.kernels import ops as kops, sf_pack
    it = sz.timing_iters
    skip = da.interior == "skip"
    t0 = time.perf_counter()
    comm = da.comm("cuda", device=dev)
    t_plan = time.perf_counter() - t0
    nl = da.nlocal_total
    pos, gid = dmda_leaf_map(da, skip)
    check(pos.size == da.sf.nedges_total,
          f"geometry fills {pos.size} leaves, the SF has "
          f"{da.sf.nedges_total} edges")
    leaves = dmda_fields(nl, g, dev)
    bundle = comm._bundle(fields_g)
    groups = [{"fields": list(grp.members), "width": grp.width,
               "carrier": str(grp.carrier)[6:]}
              for grp in bundle._byte_groups]
    counters0, launches0 = sflog.counters(), kops.launch_counts()
    outs = comm.bcast_multi(fields_g, leaves)
    counters1, launches1 = sflog.counters(), kops.launch_counts()
    for k, (o, f, lf) in enumerate(zip(outs, fields_g, leaves)):
        want = _int_view(lf)
        want[pos] = _int_view(f)[gid]
        check(np.array_equal(_int_view(o), want),
              f"bcast_multi field {k} != the grid oracle ({da.interior})")
    exch = counters1["fields.fused_exchanges"] \
        - counters0.get("fields.fused_exchanges", 0)
    check(exch == bundle.ngroups("replace") == 2,
          f"bcast_multi ran {exch} exchanges for 2 groups")
    launched = {k: v - launches0[k] for k, v in launches1.items()
                if v != launches0[k]}
    packs = sum(launched.get(k, 0) for k in ("pack", "pack_blocked",
                                             "pack_strided"))
    check(dev.type != "cuda" or packs == 2,
          f"bcast_multi launched {launched}, not one pack per group")
    # the route each fused payload's pack takes
    plans = []
    for grp in bundle._byte_groups:
        payload = bundle._fused(grp, fields_g, da.nglobal)
        plans.append(dataclasses.asdict(sf_pack.gather_plan(
            payload, comm.backend._k_gr,
            torch.empty((pos.size,) + payload.shape[1:],
                        dtype=payload.dtype, device=dev),
            kops.PACK_BLOCK_ROWS)))
    out = {"interior": da.interior, "leaves": nl,
           "edges": int(da.sf.nedges_total), "plan_setup_s": t_plan,
           "replace_groups": groups, "reduce_groups": bundle.ngroups("sum"),
           "bcast_launches": launched, "pack_plans": plans}
    # reduce_multi sum: all five fields, the f32 ones as one 5-column group
    lv = dmda_fields(nl, g, dev)
    lv[0].copy_(torch.nan_to_num(lv[0]))
    lv[1].copy_(torch.nan_to_num(lv[1]))
    lv[2].copy_(torch.nan_to_num(lv[2]))
    lv[4].copy_(torch.nan_to_num(lv[4]))
    gz = [torch.zeros_like(f) for f in fields_g]
    launches0 = kops.launch_counts()
    sums = comm.reduce_multi(lv, gz, "sum")
    launched = {k: v - launches0[k] for k, v in kops.launch_counts().items()
                if v != launches0[k]}
    check(dev.type != "cuda" or (
        launched.get("segment_reduce_blocked", 0) == 3
        and sum(launched.get(k, 0) for k in ("pack", "pack_blocked",
                                             "pack_strided")) == 3),
        f"reduce_multi launched {launched}, not one pack and one segment "
        f"reduce per group")
    again = comm.reduce_multi(lv, gz, "sum")
    glob = da.comm("global", device=dev).reduce_multi(lv, gz, "sum")
    errs = []
    for k, (s_, a_, gl_, f) in enumerate(zip(sums, again, glob, lv)):
        check(same_bits(s_, a_), f"reduce_multi field {k} differs run to run")
        check(same_bits(s_, gl_), f"reduce_multi field {k}: cuda != global")
        leaf = f.double().cpu().numpy()
        want = np.zeros((da.nglobal,) + leaf.shape[1:])
        np.add.at(want, gid, leaf[pos])
        got = s_.double().cpu().numpy()
        err = float(np.abs(got - want).max()) if got.size else 0.0
        scale = float(np.abs(want).max())
        # f32: 1e-6 of the largest sum; bf16 rounds every step to 8 bits
        # (at most 8 contributions a cell: 8 * 2^-8); int32 exact
        tol = {torch.float32: 1e-6, torch.bfloat16: 8 * 2 ** -8,
               torch.int32: 0.0}[f.dtype]
        check(err <= tol * scale, f"reduce_multi field {k} ({f.dtype}): "
              f"max|d| {err} > {tol} * {scale}")
        errs.append({"dtype": str(f.dtype)[6:], "max_abs_err": err,
                     "scale": scale, "tol_rel": tol})
    out["reduce_launches"] = launched
    out["reduce_errors"] = errs
    # fused against five sequential bcasts, in turns.  Device time is a
    # CUDA graph's replay of the call: on the H100 torch.profiler dropped
    # one of the fused bundle's concat kernels in every window of 10 or 20
    # calls (7 tries each, PERF.md §6), so its windows cannot be held whole
    fused = lambda: comm.bcast_multi(fields_g, leaves)
    seq = lambda: [comm.bcast(f, lf) for f, lf in zip(fields_g, leaves)]
    ms, call = {"fused": [], "sequential": []}, {"fused": [],
                                                 "sequential": []}
    for name, fn in (("fused", fused), ("sequential", seq),
                     ("sequential", seq), ("fused", fused)):
        ms[name].append(graph_ms(fn, dev, it))
        call[name].append(call_ms(fn, dev, it))
    bms, _ = bound(exchange_bytes(fields_g, da.nglobal, nl, pos, gid))
    out.update({"device_ms": ms, "device_ms_method": "CUDA-graph replay",
                "call_ms": call, "bound_ms": bms, "bound_by": "bytes"})
    if dev.type == "cuda":
        # where each formulation's device time goes, per call: one profiled
        # window each (not held whole, see above)
        for name, fn in (("fused", fused), ("sequential", seq)):
            def many(fn=fn):
                for _ in range(it):
                    fn()
            by_name, _ = profiled(many, dev)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            out[f"{name}_top_kernels_ms"] = {k[:70]: v / it for k, v in top}
    return out


def phase_dmda(sz: Sizes, dev) -> dict:
    """The structured-grid path (PETSc's DMDA tutorials) through the user
    entry points: a 5-field halo on a box-stencil DMDA in both interior
    modes (after ``src/snes/tutorials/ex19.c``'s multi-dof exchange, in
    3D), then the star-stencil Laplacian as ``ParCSR.from_dmda_stencil``
    and both CG loops on it (after ``src/ksp/ksp/tutorials/ex45.c``)."""
    import scipy.sparse as sp
    import torch
    from repro_torch.meshdist import DMDA
    from repro_torch.sparse import ParCSR
    shape = (sz.dmda_grid,) * 3
    g = torch.Generator(device=dev).manual_seed(4)
    out = {"phase": "dmda", "shape": list(shape), "nranks": sz.nranks}
    halo = {}
    for interior in ("connect", "skip"):
        t0 = time.perf_counter()
        da = DMDA(shape, sz.nranks, stencil="box", width=1, periodic=False,
                  interior=interior)
        t_da = time.perf_counter() - t0
        check(da.proc_grid == (2, 2, 2) or sz.nranks != 8,
              f"proc grid {da.proc_grid}")
        fields_g = dmda_fields(da.nglobal, g, dev)
        halo[interior] = {"dmda_setup_s": t_da,
                          **halo_variant(da, fields_g, sz, dev, g)}
        del da, fields_g
    out["halo"] = halo
    # the CG configuration
    t0 = time.perf_counter()
    da = DMDA(shape, sz.nranks, stencil="star", width=1, periodic=False)
    t_da = time.perf_counter() - t0
    A = ParCSR.from_dmda_stencil(da, device=dev, backend=None
                                 if dev.type == "cuda" else "cuda")
    t_mat = time.perf_counter() - t0 - t_da
    check(A.comm.backend_name == "cuda", f"select_backend picked "
          f"{A.comm.backend_name!r} for the stencil's ghost SF")
    n, rows, cols, vals = poisson_coo(sz.dmda_grid)
    nnz = sum(c.nnz for c in A.diag + A.offd)
    check(A.shape == (n, n) and nnz == rows.size,
          f"stencil matrix {A.shape}, {nnz} nonzeros")
    # the natural-order Laplacian in the DMDA's ordering: an oracle that
    # does not go through from_dmda_stencil
    idx = np.arange(n, dtype=np.int64)
    gg = sz.dmda_grid
    perm = da.natural_to_global(np.stack([idx // (gg * gg), (idx // gg) % gg,
                                          idx % gg], axis=1))
    S = sp.csr_matrix((vals, (perm[rows], perm[cols])), shape=(n, n))
    diag = A.diagonal()
    check(bool((diag == 6).all()), "diagonal() is not 6 everywhere")
    rng = np.random.default_rng(5)
    xh = rng.standard_normal(n).astype(np.float32)
    want = S @ xh.astype(np.float64)
    got = A.spmv(torch.as_tensor(xh, device=dev), use_kernel=True)
    err = float(np.abs(got.double().cpu().numpy() - want).max())
    check(err <= 1e-5 * np.abs(want).max(), f"stencil spmv max|d| {err}")
    bh = rng.standard_normal(n).astype(np.float32)
    out["cg"] = {"dmda_setup_s": t_da, "from_dmda_stencil_s": t_mat,
                 "unknowns": n, "nnz": nnz, "spmv_max_abs_err": err,
                 "ghost_edges": int(A.sf.nedges_total),
                 **cg_loops(A, S, bh, sz, dev)}
    return out


# -------------------------------------------------- mg, assembly, plex
def edge_element_triplets(da):
    """The star-stencil Laplacian of a non-periodic ``da`` as edge elements
    (the ``assembly`` phase's insertion pattern), per rank: for every grid
    edge (p, p + e_d) whose lower end p the rank owns, ``[[1, -1], [-1,
    1]]`` at (p, p), (p, q), (q, p), (q, q); and ``2 ndim - deg(p)`` at (p,
    p) of every owned boundary point, so every diagonal sums to the
    stencil's centre.  Rows of q owned by another rank are the stash.
    Small integers only: every sum is exact in float32."""
    out = []
    nd = da.ndim
    for r in range(da.nranks):
        nat = da.box_coords(da.owned_box(r))
        p = da.owned_offsets[r] + np.arange(nat.shape[0], dtype=np.int64)
        deg = np.zeros(p.size, dtype=np.int64)
        rows, cols, vals = [], [], []
        for d in range(nd):
            deg += (nat[:, d] > 0).astype(np.int64) \
                + (nat[:, d] < da.shape[d] - 1)
            up = nat[:, d] < da.shape[d] - 1
            q = nat[up].copy()
            q[:, d] += 1
            pe, qe = p[up], da.natural_to_global(q)
            rows += [pe, pe, qe, qe]
            cols += [pe, qe, pe, qe]
            vals += [np.ones(pe.size), -np.ones(pe.size), -np.ones(pe.size),
                     np.ones(pe.size)]
        bd = deg < 2 * nd
        rows.append(p[bd])
        cols.append(p[bd])
        vals.append((2 * nd - deg[bd]).astype(np.float64))
        out.append((np.concatenate(rows), np.concatenate(cols),
                    np.concatenate(vals).astype(np.float32)))
    return out


@contextlib.contextmanager
def stage_times(patches):
    """Time every call of the functions ``getattr(owner, attr)`` for each
    ``(owner, attr, name)`` while the block runs; yields the list of
    ``(name, host seconds)`` in the order the calls return (a nested call
    before its caller)."""
    log, saved = [], []
    for owner, attr, name in patches:
        real = getattr(owner, attr)

        def timed(*a, _real=real, _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                log.append((_name, time.perf_counter() - t0))
        saved.append((owner, attr, real))
        setattr(owner, attr, timed)
    try:
        yield log
    finally:
        for owner, attr, real in saved:
            setattr(owner, attr, real)


def parcsr_scipy(A):
    """A ParCSR's host blocks as one scipy CSR matrix in float64."""
    import scipy.sparse as sp
    rows, cols, vals = [], [], []
    for r in range(A.nranks):
        for blk, colmap in ((A.diag[r], None), (A.offd[r], A.garray[r])):
            rr = np.repeat(np.arange(blk.shape[0]), np.diff(blk.indptr))
            rows.append(rr + int(A.row_offsets[r]))
            cols.append(blk.indices + int(A.col_offsets[r]) if colmap is None
                        else colmap[blk.indices])
            vals.append(blk.data.astype(np.float64))
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=A.shape)


def natural_perm(da) -> np.ndarray:
    """Global id of every point of ``da`` in natural (row-major) order."""
    return da.natural_to_global(da.box_coords([(0, e) for e in da.shape]))


def interpolation_matrix(fine, coarse):
    """P (fine x coarse, both in their DMDA's global ordering) of
    vertex-centred linear interpolation, built apart from ``Transfer``: the
    Kronecker product of the 1-D matrices (even fine index: its coarse
    point, weight 1; odd: both neighbours, 1/2 each) in natural order,
    then permuted."""
    import scipy.sparse as sp
    P = None
    for nf, nc in zip(fine.shape, coarse.shape):
        f = np.arange(nf)
        odd = f[f % 2 == 1]
        m = sp.csr_matrix((np.concatenate([np.where(f % 2, 0.5, 1.0),
                                           np.full(odd.size, 0.5)]),
                           (np.concatenate([f, odd]),
                            np.concatenate([f // 2, odd // 2 + 1]))),
                          shape=(nf, nc))
        P = m if P is None else sp.kron(P, m, format="csr")
    P = P.tocoo()
    return sp.csr_matrix((P.data, (natural_perm(fine)[P.row],
                                   natural_perm(coarse)[P.col])),
                         shape=P.shape)


def close_sparse(got, want, rtol: float, atol: float) -> float:
    """Largest |got - want| over the union of both patterns; fails where
    an entry differs by more than ``atol + rtol |want|``."""
    d = (got - want).tocoo()
    w = want.tocsr()
    w.sum_duplicates()
    wrow = np.repeat(np.arange(w.shape[0]), np.diff(w.indptr))
    wkey = wrow * w.shape[1] + w.indices       # sorted: canonical CSR
    dkey = d.row.astype(np.int64) * w.shape[1] + d.col
    at = np.minimum(np.searchsorted(wkey, dkey), max(wkey.size - 1, 0))
    w = np.where(wkey[at] == dkey, np.abs(w.data[at]), 0.0) if wkey.size \
        else np.zeros(d.nnz)
    bad = np.abs(d.data) > atol + rtol * w
    check(not bad.any(), f"{int(bad.sum())} entries off by more than "
          f"{atol} + {rtol}|want|")
    return float(np.abs(d.data).max()) if d.nnz else 0.0


def multigrid_twin(mg, device):
    """``mg``'s hierarchy on another device, from the same level operators
    (their host blocks) and grids, without computing the Galerkin products
    again: the CPU twin the card's V-cycle is held against."""
    import torch
    from repro_torch.solvers import Multigrid, Transfer
    from repro_torch.sparse import ParCSR
    tw = Multigrid.__new__(Multigrid)
    tw.device = torch.device(device)
    tw.das, tw.nu_pre, tw.nu_post = mg.das, mg.nu_pre, mg.nu_post
    tw.omega = mg.omega
    tw.ops = [ParCSR(A.nranks, A.row_offsets, A.col_offsets, A.diag, A.offd,
                     A.garray, dtype=A.dtype, device=device) for A in mg.ops]
    tw.transfers = [Transfer(t.fine, t.coarse, device=device)
                    for t in mg.transfers]
    tw.diags = [d.to(device) for d in mg.diags]
    tw._coarse_inv = mg._coarse_inv.to(device)
    return tw


def mg_setup(da, sz: Sizes, dev):
    """``Multigrid(da, nlevels)`` with the host seconds of each stage:
    ``from_dmda_stencil``, the hierarchy, per level the ``Transfer`` and
    the ``ptap`` (its ``spmm``, which holds ``fetch_rows`` and part of the
    ``spgemm`` time, and its ``assemble_coo``), and the pinv."""
    from repro_torch.solvers import multigrid as mgmod
    from repro_torch.sparse import ParCSR, parmat
    t0 = time.perf_counter()
    A = ParCSR.from_dmda_stencil(da, device=dev)
    t_a = time.perf_counter() - t0
    patches = [(mgmod, "build_hierarchy", "hierarchy"),
               (mgmod, "Transfer", "transfer"), (ParCSR, "ptap", "ptap"),
               (ParCSR, "spmm", "spmm"), (ParCSR, "fetch_rows", "fetch_rows"),
               (parmat, "spgemm", "spgemm"),
               (parmat, "assemble_coo", "assemble_coo"),
               (np.linalg, "pinv", "pinv")]
    t0 = time.perf_counter()
    with stage_times(patches) as log:
        mg = mgmod.Multigrid(da, A=A, nlevels=sz.mg_levels, device=dev)
    total = time.perf_counter() - t0
    levels, cur, rest = [], {}, {}
    for name, sec in log:
        if name in ("hierarchy", "pinv"):
            rest[f"{name}_s"] = sec
            continue
        cur[f"{name}_s"] = cur.get(f"{name}_s", 0.0) + sec
        if name == "ptap":
            levels.append(cur)
            cur = {}
    return A, mg, {"from_dmda_stencil_s": t_a, "multigrid_s": total, **rest,
                   "per_level": levels}


def pcg_loops(A, mg, S, bh, sz: Sizes, dev, tol: float = 1e-5) -> dict:
    """The V(1,1)-preconditioned CG loops on ``A``: host ``cg(M=)`` and
    graph ``cg_async(M=)`` in turns (host, graph, graph, host), plain CG,
    the graph against its guarded chunks run eagerly, the graph's stages,
    and a profiled 10-iteration window of each loop."""
    import torch
    from repro_torch.solvers import cg, cg_async
    from repro_torch.solvers.cg import (GRAPH_ITERS, _capture, _cg_async,
                                        _prepare, _replay)
    b = torch.as_tensor(bh, device=dev)
    mv = lambda v: A.spmv(v, use_kernel=True)
    M = mg.vcycle
    host = lambda: cg(mv, b, tol=tol, maxiter=sz.mg_maxiter, M=M)
    graph = lambda: cg_async(mv, b, tol=tol, maxiter=sz.mg_maxiter, M=M)
    runs = [cg_solve(f, S, bh, dev) for f in (host, graph, graph, host)]
    for r in runs:
        check(r["converged"], f"MG-PCG did not converge in {r['iters']}")
        check(r["true_rel_residual"] <= 1e-4,
              f"MG-PCG true relative residual {r['true_rel_residual']}")
    check(len({r["iters"] for r in runs}) == 1, "host and graph MG-PCG "
          f"iterations differ: {[r['iters'] for r in runs]}")
    check(same_bits(runs[1]["x"], runs[2]["x"]), "graph MG-PCG x differs "
          "from run to run")
    check(dev.type != "cuda" or runs[1]["graph_replays"] > 0,
          "cg_async(M=) did not replay a CUDA graph")
    plain = cg_solve(lambda: cg(mv, b, tol=tol, maxiter=sz.cg_maxiter),
                     S, bh, dev)
    check(plain["converged"], "plain CG did not converge")
    check(2 * runs[0]["iters"] <= plain["iters"], f"MG-PCG took "
          f"{runs[0]['iters']} iterations, plain CG {plain['iters']}")
    eager = cg_solve(lambda: _cg_async(mv, b, None, tol, sz.mg_maxiter, 1,
                                       graph=False, M=M), S, bh, dev)
    check(eager["iters"] == runs[1]["iters"], f"graph MG-PCG ran "
          f"{runs[1]['iters']} iterations, its eager chunks "
          f"{eager['iters']}")
    check(same_bits(eager["x"], runs[1]["x"]), "graph MG-PCG x differs "
          "from its eager chunks")
    sync(dev)
    t0 = time.perf_counter()
    loop = _prepare(mv, b, None, tol, sz.mg_maxiter, 1, M)
    sync(dev)
    t1 = time.perf_counter()
    stages = {"prepare_ms": (t1 - t0) * 1e3}
    # a PCG iteration is ~13 SpMVs and ~1,000 kernels: 2-iteration windows
    # (torch.profiler drops events of longer ones; a window that stays
    # short of its counted ELL launches reports no time)
    windows = {"cg": cg_window(lambda: cg(mv, b, tol=0.0, maxiter=2, M=M),
                               dev, 2, strict=False)}
    if dev.type == "cuda":
        g, captured = _capture(loop)
        sync(dev)
        t2 = time.perf_counter()
        replays = _replay(loop, g, captured)
        sync(dev)
        t3 = time.perf_counter()
        stages.update({"capture_ms": (t2 - t1) * 1e3,
                       "replay_ms": (t3 - t2) * 1e3, "replays": replays,
                       "iters": int(loop.it),
                       "captured_launches_per_chunk": captured,
                       "iters_per_graph": GRAPH_ITERS})
        check(int(loop.it) == runs[1]["iters"], "staged graph MG-PCG "
              "iterations differ")
        del g
        win = _prepare(mv, b, None, 0.0, GRAPH_ITERS, 0, M)
        sync(dev)
        t4 = time.perf_counter()
        g, captured = _capture(win)
        sync(dev)
        stages["capture_again_ms"] = (time.perf_counter() - t4) * 1e3

        def replay():
            win.it.zero_()
            win.go.fill_(True)
            _replay(win, g, captured)
        windows["cg_async_graph"] = cg_window(replay, dev, GRAPH_ITERS,
                                              strict=False)
    for r in runs + [eager, plain]:
        del r["x"]
    return {"pcg": runs[0], "pcg_async_graph": runs[1],
            "in_turns_ms_per_iter": {
                "pcg": [runs[0]["ms_per_iter"], runs[3]["ms_per_iter"]],
                "pcg_async_graph": [runs[1]["ms_per_iter"],
                                    runs[2]["ms_per_iter"]]},
            "pcg_async_eager_chunks": eager, "plain_cg": plain,
            "graph_stages": stages, "profiled_windows": windows}


def phase_mg(sz: Sizes, dev) -> dict:
    """Geometric-multigrid-preconditioned CG (PETSc's
    ``ksp/tutorials/ex45.c`` with ``-pc_type mg`` and Galerkin coarse
    operators): a 129^3 star-stencil DMDA over 2x2x2 ranks, five levels
    (129 -> 65 -> 33 -> 17 -> 9, the coarsest through a dense pinv),
    V(1,1) weighted Jacobi.  Holds every Galerkin operator against scipy's
    P^T A P (P built apart from Transfer), the transfers against P x, P^T x
    and the injection, one V-cycle on the card against the CPU twin of the
    hierarchy and against itself, then both PCG loops (``pcg_loops``)."""
    import torch
    from repro_torch.core import sflog
    from repro_torch.meshdist import DMDA
    shape = (sz.mg_grid,) * 3
    t0 = time.perf_counter()
    da = DMDA(shape, sz.nranks, stencil="star", width=1, periodic=False)
    t_da = time.perf_counter() - t0
    out = {"phase": "mg", "shape": list(shape), "nranks": sz.nranks,
           "unknowns": da.nglobal}
    A, mg, setup = mg_setup(da, sz, dev)
    out["setup"] = {"dmda_s": t_da, **setup}
    out["levels"] = [{"shape": list(d.shape), "unknowns": d.nglobal,
                      "nnz": sum(c.nnz for c in Al.diag + Al.offd),
                      "ell_width": max(b.data.shape[1] for b in
                                       Al._diag_ell + Al._offd_ell),
                      "ghost_edges": int(Al.sf.nedges_total)}
                     for d, Al in zip(mg.das, mg.ops)]
    # the Galerkin operators and the transfers against scipy (float64)
    rng = np.random.default_rng(11)
    galerkin, transfers = [], []
    for l, t in enumerate(mg.transfers):
        P = interpolation_matrix(t.fine, t.coarse)
        Al, Ac = parcsr_scipy(mg.ops[l]), parcsr_scipy(mg.ops[l + 1])
        galerkin.append(close_sparse(Ac, (P.T @ Al @ P).tocsr(), 1e-4, 1e-4))
        xc = rng.standard_normal(t.ncoarse).astype(np.float32)
        xf = rng.standard_normal(t.nfine).astype(np.float32)
        errs = {}
        for name, got, want in [
                ("prolong", t.prolong(torch.as_tensor(xc, device=dev)),
                 P @ xc.astype(np.float64)),
                ("restrict", t.restrict(torch.as_tensor(xf, device=dev)),
                 P.T @ xf.astype(np.float64))]:
            err = float(np.abs(got.double().cpu().numpy() - want).max())
            check(err <= 1e-5 * np.abs(want).max(), f"level {l} {name}: "
                  f"max|d| {err}")
            errs[name] = err
        inj = t.inject(torch.as_tensor(xc, device=dev)).cpu().numpy()
        want = (P.multiply(P == 1.0)) @ xc
        check(np.array_equal(inj, want.astype(np.float32)),
              f"level {l} inject differs from P[P == 1] x")
        transfers.append({"slots": int(t.sf.nedges_total),
                          "injection_edges": int(t.injection_sf.nedges_total),
                          **errs})
    out["galerkin_max_abs_err"] = galerkin
    out["transfers"] = transfers
    # one V-cycle: on the card against the CPU twin, and against itself
    n, rows, cols, vals = poisson_coo(sz.mg_grid)
    perm = natural_perm(da)
    import scipy.sparse as sp
    S = sp.csr_matrix((vals, (perm[rows], perm[cols])), shape=(n, n))
    check(close_sparse(parcsr_scipy(A), S, 0.0, 0.0) == 0.0,
          "from_dmda_stencil differs from the natural-order Laplacian")
    bnat = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    bh = np.empty(n, np.float32)
    bh[perm] = bnat                    # the RHS drawn in natural order
    b = torch.as_tensor(bh, device=dev)
    v = mg.vcycle(b)
    check(same_bits(mg.vcycle(b), v), "two V-cycles differ on the card")
    t0 = time.perf_counter()
    twin = multigrid_twin(mg, "cpu")
    t_twin = time.perf_counter() - t0
    want = twin.vcycle(b.cpu())
    err = max_abs(v.cpu(), want)
    check(err <= 1e-4 * float(want.abs().max()), f"V-cycle on the card "
          f"against the CPU: max|d| {err}")
    del twin
    it = sz.timing_iters
    old = sflog.set_mode("on")
    sflog.reset()
    mg.vcycle(b)
    sync(dev)
    events = sflog.events_snapshot()
    sflog.set_mode(old)
    sflog.reset()
    out["vcycle"] = {
        "card_vs_cpu_max_abs_err": err, "tolerance": "1e-4 max|v|",
        "cpu_twin_setup_s": t_twin,
        "graph_device_ms": graph_ms(lambda: mg.vcycle(b), dev, it),
        "call_ms": call_ms(lambda: mg.vcycle(b), dev, it),
        "profiled": cg_window(lambda: mg.vcycle(b), dev, 1, strict=False),
        "sf_events": events}
    out.update(pcg_loops(A, mg, S, bh, sz, dev))
    return out


def phase_assembly(sz: Sizes, dev) -> dict:
    """Stash assembly (PETSc ``MatSetValues`` with off-process rows, then
    ``MatAssemblyBegin/End``; paper §6.4 step 3): every rank of the 129^3
    DMDA adds the 7-point operator as edge elements
    (``edge_element_triplets``), rows owned elsewhere going to its stash.
    The assembled matrix must equal ``from_dmda_stencil`` and an
    ``np.add.at`` oracle bit for bit, each ``assemble()`` must be exactly
    one SFReduce (the port's sflog), a second one must reuse the flush SF;
    then ``assemble_coo``'s stash and fetch paths on the same triplets."""
    import torch
    from repro_torch.core import sflog
    from repro_torch.meshdist import DMDA
    from repro_torch.kernels import ops as kops
    from repro_torch.sparse import MatAssembler, ParCSR, Sparsity, parmat
    from repro_torch.sparse.parmat import assemble_coo
    shape = (sz.mg_grid,) * 3
    da = DMDA(shape, sz.nranks, stencil="star", width=1, periodic=False)
    n = da.nglobal
    t0 = time.perf_counter()
    trips = edge_element_triplets(da)
    t_trips = time.perf_counter() - t0
    rows = np.concatenate([t[0] for t in trips])
    cols = np.concatenate([t[1] for t in trips])
    vals = np.concatenate([t[2] for t in trips])
    edges = sum((e - 1) * int(np.prod(shape)) // e for e in shape)
    check(int((vals == -1).sum()) == 2 * edges, "edge count")
    t0 = time.perf_counter()
    sp_ = Sparsity(sz.nranks, n, n, rows, cols, row_offsets=da.owned_offsets,
                   col_offsets=da.owned_offsets)
    t_sp = time.perf_counter() - t0
    asm = MatAssembler(sp_, device=dev)
    want = ParCSR.from_dmda_stencil(da, device=dev)
    # the np.add.at oracle, in (row, col) order
    keys, inv = np.unique(rows * n + cols, return_inverse=True)
    oracle = np.zeros(keys.size)
    np.add.at(oracle, inv, vals.astype(np.float64))

    def same_as_want(got, what):
        for a, b in zip(got.diag + got.offd, want.diag + want.offd):
            check(np.array_equal(a.indptr, b.indptr)
                  and np.array_equal(a.indices, b.indices)
                  and np.array_equal(a.data, b.data),
                  f"{what}: a block differs from from_dmda_stencil")
        for a, b in zip(got.garray, want.garray):
            check(np.array_equal(a, b), f"{what}: garray differs")
        for a, b in zip(got._diag_ell + got._offd_ell,
                        want._diag_ell + want._offd_ell):
            check(same_bits(a.data, b.data) and torch.equal(a.cols, b.cols),
                  f"{what}: ELL differs from from_dmda_stencil")

    runs = []
    old = sflog.set_mode("on")
    sflog.reset()
    try:
        with stage_times([(parmat, "compose_inverse", "compose_inverse")]) \
                as built:
            for i in range(2):
                t0 = time.perf_counter()
                for q, (r, c, v) in enumerate(trips):
                    asm.add_values(q, r, c, v)
                t1 = time.perf_counter()
                before = sflog.events_snapshot()
                got = asm.assemble()
                sync(dev)
                t2 = time.perf_counter()
                delta = sflog.events_delta(before)
                check(delta.get("SFReduce", {}).get("count") == 1 and not [
                    k for k in delta if k.startswith("SFReduce")
                    and k != "SFReduce"], f"assemble() {i} recorded "
                    f"{delta}, not one SFReduce")
                check(i == 0 or set(delta) == {"SFReduce"}, "a repeated "
                      f"assemble() exchanged more than its flush: {delta}")
                same_as_want(got, f"assemble() {i}")
                C = parcsr_scipy(got)
                C.sum_duplicates()             # canonical: sorted rows
                C = C.tocoo()
                check(np.array_equal(C.row.astype(np.int64) * n + C.col,
                                     keys)
                      and np.array_equal(C.data, oracle),
                      f"assemble() {i} differs from np.add.at")
                runs.append({"add_values_s": t1 - t0, "assemble_s": t2 - t1,
                             "sf_events": delta})
        check(len(built) == 1, f"compose_inverse ran {len(built)} times for "
              "one stash pattern")
    finally:
        sflog.set_mode(old)
        sflog.reset()
    sig, flush_sf, comms = asm._flush_cache
    flush = comms[None]
    leaf = torch.zeros(flush_sf.nleafspace_total, device=dev)
    root = torch.zeros(sp_.nnz_total, device=dev)
    it = sz.timing_iters
    out = {"phase": "assembly", "shape": list(shape), "nranks": sz.nranks,
           "edges": edges, "contributions": int(rows.size),
           "stashed_per_assemble": asm.stats["stashed_inserts"] // 2,
           "flush_edges": int(flush_sf.nedges_total),
           "flush_max_segment": int(flush.backend.plan.red.max_valid_seg_len),
           "flush_backend": flush.backend_name,
           "edge_elements_s": t_trips, "sparsity_s": t_sp,
           "compose_inverse_s": built[0][1], "assemble": runs,
           "flush_device_ms": graph_ms(lambda: flush.reduce(leaf, root),
                                       dev, it)}
    # the two assemble_coo paths on the same triplets
    for method in ("stash", "fetch"):
        run = lambda: assemble_coo(sz.nranks, n, n, trips,
                                   row_offsets=da.owned_offsets,
                                   col_offsets=da.owned_offsets,
                                   method=method, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        made = []
        if method == "fetch" and dev.type == "cuda":
            by_name, _ = profiled(lambda: made.append(run()), dev)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            out["fetch_top_kernels_ms"] = {k[:60]: v for k, v in top}
        else:
            made.append(run())
        got = made.pop()
        sync(dev)
        out[f"assemble_coo_{method}_s"] = time.perf_counter() - t0
        same_as_want(got, f"assemble_coo({method})")
        del got
    # the fetch path's counting fold alone, its launches taken back (the
    # path's own count is that of the drive above)
    before = kops.launch_counts()
    out["fetch_fold"] = fetch_fold_record(rows, da.owned_offsets, dev,
                                          hub_rows=sz.hub_rows)
    kops.add_launches({k: v - before[k]
                       for k, v in kops.launch_counts().items()}, -1)
    return out


def fetch_fold_record(rows, row_offsets, dev, iters: int = 2,
                      hub_rows: int = 1 << 22) -> dict:
    """``segment_reduce_blocked`` at the shape of ``assemble_coo(method=
    "fetch")``'s counting fold: one int32 1 per triplet summed into its
    owner rank's counter, a segment of ~3.2 M rows a rank on the 129^3
    DMDA (the long route's order-free split); the same ones in float32 (its
    order-dependent route); and one segment of ``hub_rows`` (2^22) float32
    rows under max / min (against numpy) and sum.  Each sum against the
    segment lengths (the plain version folds in a Python loop of 3.2 M
    steps: not timed).  ``ms``: CUDA events around replays of a CUDA graph
    of calls (``graph_ms``); ``prev_ms``: the short route alone on the same
    input (the one-thread-a-segment kernel, ``short_route_alone``), CUDA
    events around ``iters`` calls, as for the two library calls for the
    same sums:
    ``index_add_`` over the segment ids (int32) and ``segment_reduce`` (on
    a float32 copy, exact below 2^24).  The 102 MB input is twice L2, so no
    scrubbed reading.  ``bound_ms``: bytes (rows, metadata and output,
    the split's partials written and read once); the float sums' also the
    chain of dependent adds of the longest segment (``chain_ms``: 4
    cycles an add at the card's top SM clock)."""
    import torch
    from repro_torch.kernels import ops as kops, sf_unpack
    owner = np.searchsorted(row_offsets, rows, side="right") - 1
    lens = np.bincount(owner, minlength=len(row_offsets) - 1)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    M, S = int(lens.sum()), int(lens.size)
    st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    ln = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    clock_hz = sm_clock_hz() if dev.type == "cuda" else None

    def fold(buf, op, st, ln, seg_rows, it, prev_it=iters):
        run = lambda: sf_unpack.segment_reduce_blocked(
            buf, st, ln, segs_per_block=kops.SEG_BLOCK, op=op)
        prev = lambda: short_route_alone(buf, st, ln, op)
        got = run()
        check(same_raw_bits(got, prev()), f"fetch fold {buf.dtype} {op}: "
              f"the long route != the short route")
        rb = buf.element_size()
        split = sf_unpack.order_free(buf.dtype, op)
        nbytes = buf.numel() * rb + st.numel() * (8 + rb) + \
            (2 * chunks_of(seg_rows) * rb if split else 0)
        bms, by = bound(nbytes)
        rec = {"dtype": str(buf.dtype)[6:], "op": op,
               "route": sf_unpack.reduce_route(int(max(seg_rows)),
                                               buf.dtype, op),
               "ms": graph_ms(run, dev, it), "ms_by": "CUDA events (graph)",
               "prev_ms": call_ms(prev, dev, prev_it),
               "prev_ms_by": "CUDA events", "bound_ms": bms, "bound_by": by}
        if not split and clock_hz:
            chain = max(seg_rows) * 4 / clock_hz * 1e3
            rec["chain_ms"] = chain
            if chain > bms:
                rec["bound_ms"], rec["bound_by"] = chain, "dependent adds"
        return got, rec

    sv = torch.ones(M, dtype=torch.int32, device=dev)
    got, rec = fold(sv, "sum", st, ln, lens, 20)
    check(np.array_equal(got.cpu().numpy(), lens),
          "segment_reduce_blocked: the fetch fold's sums != its lengths")
    seg_ids = torch.repeat_interleave(torch.arange(S, device=dev),
                                      ln.long())
    index_add = lambda: torch.zeros(S, dtype=torch.int32,
                                    device=dev).index_add_(0, seg_ids, sv)
    svf, ln64 = sv.float(), ln.long()
    seg_reduce = lambda: torch.segment_reduce(svf, "sum", lengths=ln64)
    check(np.array_equal(index_add().cpu().numpy(), lens)
          and np.array_equal(seg_reduce().cpu().numpy(), lens),
          "a library call's fetch-fold sums != the lengths")
    out = {"rows": M, "segments": S, "segment_rows": lens.tolist(),
           "long_seg": sf_unpack.LONG_SEG,
           "chunk_rows": sf_unpack.LONG_CHUNK_ROWS,
           "chunks": chunks_of(lens),
           "segs_per_block": kops.SEG_BLOCK, **rec, "plain_ms": None,
           "library": "torch.zeros().index_add_ (int32)",
           "library_ms": call_ms(index_add, dev, 10),
           "segment_reduce_f32_ms": call_ms(seg_reduce, dev, 10),
           "sm_clock_hz": clock_hz}
    got, out["float32"] = fold(svf, "sum", st, ln, lens, 3)
    check(np.array_equal(got.cpu().numpy(), lens),
          "segment_reduce_blocked: the float32 fetch fold's sums != lengths")
    out["float32"]["library"] = "torch.segment_reduce"
    out["float32"]["library_ms"] = out["segment_reduce_f32_ms"]
    del sv, svf, seg_ids
    # one segment of 2^22 float32 rows (a hub root): max / min against
    # numpy, sums of ones against the length
    n = hub_rows
    x = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    xs = torch.as_tensor(x, device=dev)
    st1 = torch.zeros(1, dtype=torch.int32, device=dev)
    ln1 = torch.full((1,), n, dtype=torch.int32, device=dev)
    hub = []
    for op, want in (("max", x.max()), ("min", x.min())):
        got, r = fold(xs, op, st1, ln1, [n], 20)
        check(got.cpu().numpy()[0] == want, f"2^22-row {op}: "
              f"{got.cpu().numpy()[0]} != numpy's {want}")
        hub.append(r)
    for dt, it in ((torch.int32, 20), (torch.float32, 3)):
        got, r = fold(torch.ones(n, dtype=dt, device=dev), "sum", st1, ln1,
                      [n], it)
        check(int(got.cpu().numpy()[0]) == n, f"2^22-row {dt} sum != {n}")
        hub.append(r)
    out["hub"] = hub
    return out


def short_route_alone(buf, st, ln, op: str):
    """The one-thread-a-segment kernel on every segment, however long (the
    cut disabled; ``SEG_BLOCK`` segments a CTA), through the internal
    launcher: the long route's yardstick (the plain version on the CPU).
    ``st`` / ``ln``: int32 metadata on ``buf``'s device."""
    import torch
    from repro_torch.kernels import ops as kops, sf_unpack
    if buf.device.type != "cuda":
        return sf_unpack.segment_reduce_plain(buf, st, ln, op)
    out = torch.empty((st.numel(),) + tuple(buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    sf_unpack._launch_short(buf, out, st, ln, op, kops.SEG_BLOCK,
                            2 ** 31 - 1)
    return out


def chunks_of(seg_rows) -> int:
    """The long route's chunks over segments of these row counts."""
    from repro_torch.kernels import sf_unpack
    C = sf_unpack.LONG_CHUNK_ROWS
    return int(sum(-(-int(n) // C) for n in seg_rows
                   if n > sf_unpack.LONG_SEG))


def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.splitlines()[0]) * 1e6


LONG_CUT_SWEEP = (64, 128, 256, 512, 1024, 2048, 4096)


def long_cut_sweep(dev, it: int) -> list:
    """Where the long route starts to pay: a segment of L rows alone and
    beside 262,144 segments of 4 rows, int32 and float32 sums, in the short
    route alone and with that segment on the long route (the plan's cut
    forced to L - 1), device ms from graph replays.  ``LONG_SEG`` is picked
    from this table."""
    import torch
    from repro_torch.kernels import sf_unpack
    out = []
    if dev.type != "cuda":      # the routes exist only on the card
        return out
    for L in LONG_CUT_SWEEP:
        for crowd in (0, 1 << 18):
            lens = np.concatenate([np.full(crowd, 4), [L]]).astype(np.int32)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
            ln = torch.as_tensor(lens, dtype=torch.int32, device=dev)
            plan = sf_unpack.build_long_plan(st, ln, cut=L - 1)
            for dt in (torch.int32, torch.float32):
                buf = torch.ones(int(lens.sum()), dtype=dt, device=dev)
                out_t = torch.empty(lens.size, dtype=dt, device=dev)

                def routed():
                    if crowd:
                        sf_unpack._launch_short(buf, out_t, st, ln, "sum",
                                                64, L - 1)
                    sf_unpack._launch_long(buf, out_t, plan, "sum")

                short = lambda: short_route_alone(buf, st, ln, "sum")
                routed()
                check(same_raw_bits(out_t, short()),
                      f"long_cut_sweep L={L}: routes differ")
                out.append({"rows": L, "beside": crowd,
                            "dtype": str(dt)[6:],
                            "short_ms": graph_ms(short, dev, it),
                            "long_ms": graph_ms(routed, dev, it)})
    return out


def overlap_oracle(mesh, cells_per_rank, levels: int) -> list:
    """Per rank, the halo cells at each level of a breadth-first search
    over "cells sharing a vertex", from the whole mesh's cones."""
    cones = mesh.cell_cone(np.arange(mesh.ncells, dtype=np.int64))
    flat = cones.reshape(-1)
    order = np.argsort(flat, kind="stable")
    cell_of = order // cones.shape[1]
    ptr = np.searchsorted(flat[order], np.arange(mesh.nvertices + 1))
    out = []
    for own in cells_per_rank:
        known = np.zeros(mesh.ncells, dtype=bool)
        known[own] = True
        frontier, per_level = own, []
        for _ in range(levels):
            verts = np.unique(cones[frontier])
            lens = ptr[verts + 1] - ptr[verts]
            at = np.repeat(ptr[verts] - np.cumsum(lens) + lens, lens) \
                + np.arange(int(lens.sum()))
            near = np.unique(cell_of[at])
            fresh = near[~known[near]]
            known[fresh] = True
            per_level.append(fresh)
            frontier = fresh
        out.append(per_level)
    return out


def phase_plex(sz: Sizes, dev) -> dict:
    """Mesh distribution and overlap growth (PETSc ``DMPlexDistribute`` /
    ``DMPlexDistributeOverlap``, paper §6.3): a periodic 64^3 hex mesh
    over 8 ranks from the paper's ``seq`` and ``rand`` layouts, migrated to
    balanced blocks by SF bcasts; the vertex SF and the ghost assembly
    (every vertex of the periodic mesh belongs to 8 cells); one- and
    two-level overlaps against a breadth-first oracle; the overlap
    ``DMGlobalToLocal`` of the cells' ids."""
    import torch
    from repro_torch.core import SFComm
    from repro_torch.meshdist import plex
    R, it = sz.nranks, sz.timing_iters
    mesh = plex.HexMesh(*(sz.plex_mesh,) * 3)
    out = {"phase": "plex", "mesh": [mesh.nx, mesh.ny, mesh.nz],
           "cells": mesh.ncells, "vertices": mesh.nvertices, "nranks": R,
           "distribute": {}}
    dms = {}
    for kind, seed in (("seq", 0), ("rand", 7)):
        t0 = time.perf_counter()
        dm0 = plex.initial_distribution(mesh, R, kind, seed=seed)
        t_init = time.perf_counter() - t0
        dm, times = plex.distribute(dm0, time_phases=True, device=dev)
        sizes = [c.size for c in dm.cells]
        check(max(sizes) - min(sizes) <= 1, f"{kind}: unbalanced {sizes}")
        check(np.array_equal(np.sort(np.concatenate(dm.cells)),
                             np.arange(mesh.ncells)),
              f"{kind}: a cell is not on exactly one rank")
        for r in range(R):
            check(np.array_equal(dm.cones[r], mesh.cell_cone(dm.cells[r]))
                  and np.array_equal(dm.labels[r], dm.cells[r] % 7),
                  f"{kind}: rank {r}'s cones or labels differ")
        # the migration's bcasts alone, on the card
        sf = plex.migration_sf(dm0, plex._partition_balanced(mesh, R))
        comm = SFComm(sf, device=dev)
        cones = torch.as_tensor(np.concatenate(dm0.cones).astype(np.int32),
                                device=dev)
        labels = torch.as_tensor(np.concatenate(dm0.labels).astype(np.int32)
                                 .reshape(-1, 1), device=dev)
        z8 = cones.new_zeros((sf.nleafspace_total, 8))
        z1 = labels.new_zeros((sf.nleafspace_total, 1))
        out["distribute"][kind] = {
            "initial_s": t_init, **{f"{k}_s": v for k, v in times.items()},
            "backend": comm.backend_name,
            "cones_bcast_device_ms": graph_ms(
                lambda: comm.bcast(cones, z8), dev, it),
            "labels_bcast_device_ms": graph_ms(
                lambda: comm.bcast(labels, z1), dev, it)}
        dms[kind] = dm
    for f in ("cells", "cones", "labels", "local_verts", "vertex_owner"):
        check(all(np.array_equal(a, b) for a, b in
                  zip(getattr(dms["seq"], f), getattr(dms["rand"], f))),
              f"seq and rand distribute to different {f}")
    dm = dms["rand"]
    t0 = time.perf_counter()
    vsf = plex.make_vertex_sf(dm)
    t_vsf = time.perf_counter() - t0
    nl = [v.size for v in dm.local_verts]
    local = torch.as_tensor(np.concatenate(
        [np.bincount(dm.cone_local[r].reshape(-1), minlength=nl[r])
         for r in range(R)]).astype(np.float32), device=dev)
    t0 = time.perf_counter()
    summed = plex.local_to_global(vsf, 1, local, device=dev).cpu().numpy()
    t_l2g = time.perf_counter() - t0
    lo = vsf.leaf_offsets()
    for r in range(R):
        own = dm.vertex_owner[r] == r
        check((summed[lo[r]: lo[r] + nl[r]][own] == 8).all(),
              f"rank {r}: an owned vertex does not assemble to 8 cells")
    t0 = time.perf_counter()
    filled = plex.global_to_local(vsf, 1, torch.as_tensor(summed, device=dev),
                                  device=dev).cpu().numpy()
    t_g2l = time.perf_counter() - t0
    check((filled == 8).all(), "global_to_local did not fill every vertex")
    out["vertex_sf"] = {"make_vertex_sf_s": t_vsf,
                        "ghost_edges": int(vsf.nedges_total),
                        "local_to_global_s": t_l2g,
                        "global_to_local_s": t_g2l}
    out["overlap"] = {}
    for levels in (1, 2):
        t0 = time.perf_counter()
        ov = plex.grow_overlap(dm, vsf, levels=levels, device=dev)
        t_ov = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = overlap_oracle(mesh, dm.cells, levels)
        t_or = time.perf_counter() - t0
        for q in range(R):
            own = dm.cells[q]
            check(np.array_equal(ov.cells[q][: own.size], own)
                  and (ov.level[q][: own.size] == 0).all(),
                  f"rank {q}: owned cells are not first")
            for k in range(levels):
                check(np.array_equal(np.sort(ov.cells[q][ov.level[q]
                                                          == k + 1]),
                                     want[q][k]),
                      f"rank {q} level {k + 1} differs from the BFS oracle")
        root = torch.as_tensor(np.concatenate(dm.cells).astype(np.int32),
                               device=dev)
        got = ov.global_to_local(root, device=dev).cpu().numpy()
        olo = ov.cell_offsets()
        for q in range(R):
            check(np.array_equal(got[olo[q]: olo[q] + ov.cells[q].size],
                                 ov.cells[q]),
                  f"rank {q}: the overlap bcast delivered other cell ids")
        out["overlap"][f"levels_{levels}"] = {
            "grow_overlap_s": t_ov, "oracle_s": t_or,
            "halo_cells": [int((lv > 0).sum()) for lv in ov.level],
            "composed_edges": [int(s.nedges_total)
                               for s in ov.adjacency_sfs]}
    return out


# ------------------------------------------------------------------ serve
# ------------------------------------------------------------------- dist
DIST_OPS = (("bcast", "replace"), ("bcast", "sum"), ("reduce", "sum"),
            ("reduce", "max"), ("reduce", "min"), ("reduce", "replace"))


def column_gather_sf(g: int):
    """The g^3 Poisson matrix's column-gather SF on one rank, the SF of
    MatMult's gather and of MatMultTranspose's SFReduce: one leaf per
    nonzero in CSR order, its root the nonzero's column.  ``(sf, csr)``."""
    from repro_torch.core import StarForest
    from repro_torch.sparse.csr import csr_from_coo
    n, rows, cols, vals = poisson_coo(g)
    csr = csr_from_coo(n, n, rows, cols, vals)
    sf = StarForest(1)
    sf.set_graph(0, n, None, np.stack([np.zeros(csr.nnz, np.int64),
                                       csr.indices], 1), nleafspace=csr.nnz)
    return sf.setup(), csr


@contextlib.contextmanager
def world1_group(dev):
    """A process group of one rank in this process — NCCL on the card,
    gloo on the CPU — through a ``file://`` store in a temporary directory;
    destroyed, and the directory removed, on exit."""
    import shutil
    import tempfile
    from datetime import timedelta
    import torch.distributed as dist
    import torch
    d = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    kw = {}
    if dev.type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device()
                                       if dev.index is None else dev.index)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{d}/store", rank=0,
                            world_size=1, timeout=timedelta(seconds=300),
                            **kw)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


def padded(t, rows: int):
    """``t`` with zero rows appended up to ``rows`` (a DistSF shard)."""
    import torch
    return torch.cat([t, t.new_zeros((rows - t.shape[0],)
                                     + tuple(t.shape[1:]))])


def dist_op(obj, kind: str, op: str, root, leaf):
    """One bcast / reduce through ``SFComm`` (global tensors) or ``DistSF``
    (padded shards; the result trimmed to the real rows) — split form."""
    from repro_torch.core import DistSF
    if not isinstance(obj, DistSF):
        if kind == "bcast":
            return obj.bcast_begin(root, op).end(leaf)
        return obj.reduce_end(obj.reduce_begin(leaf, op), root)
    if kind == "bcast":
        out = obj.bcast_end(obj.bcast_begin(root, op), leaf)
        return out[: obj.plan.nleafspace[0]]
    out = obj.reduce_end(obj.reduce_begin(leaf, op), root)
    return out[: obj.plan.nroots[0]]


def phase_dist(sz: Sizes, dev):
    """The ``"dist"`` backend on one rank: every op bitwise against
    ``"cuda"`` and against the plain versions, through ``SFComm`` and
    ``DistSF``, under the SF's ``local_only`` lowering and ``"general"``
    (an all-to-all); then the times.  Returns (record, launches)."""
    import torch
    from repro_torch.core import DistSF, SFComm, build_padded_plan
    from repro_torch.kernels import ops as kops
    on_card = dev.type == "cuda"
    it = sz.timing_iters
    t0 = time.perf_counter()
    sf, csr = column_gather_sf(sz.dist_grid)
    n, E = sf.nroots_total, sf.nleafspace_total
    out = {"phase": "dist", "roots": n, "leaves": E,
           "Lmax": int(np.bincount(csr.indices).max()),
           "sf_setup_s": time.perf_counter() - t0}
    g = torch.Generator(device=dev).manual_seed(11)
    cu = SFComm(sf, backend="cuda", device=dev)
    x = torch.randn(n, generator=g, device=dev)
    row_of = torch.as_tensor(np.repeat(np.arange(n), np.diff(csr.indptr)),
                             device=dev)
    a = torch.as_tensor(csr.data.astype(np.float32), device=dev)
    # unit (): x and MatMultTranspose's terms a_ij x_i; unit (3,): random
    data = {(): (x, a * x[row_of]),
            (3,): (torch.randn(n, 3, generator=g, device=dev),
                   torch.randn(E, 3, generator=g, device=dev))}
    ri = torch.randint(0, 100, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    li = torch.randint(0, 100, (E,), generator=g, device=dev,
                       dtype=torch.int32)
    want = {(u, k, op): dist_op(cu, k, op, *data[u])
            for u in data for k, op in DIST_OPS}
    want_fetch = cu.fetch_and_op(ri, li)
    out["payload_mb"] = {str(u): data[u][1].numel() * 4 / 1e6 for u in data}

    with world1_group(dev) as group:
        t1 = time.perf_counter()
        plan = build_padded_plan(sf)
        out["padded_plan_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        comms = {low: SFComm(sf, backend="dist", device=dev, group=group,
                             lowering=low, plan=plan)
                 for low in ("auto", "general")}
        out["dist_setup_s"] = time.perf_counter() - t1
        out["lowerings"] = {k: c.backend.dist.lowering
                            for k, c in comms.items()}
        check(out["lowerings"] == {"auto": "local_only",
                                   "general": "general"},
              f"lowerings {out['lowerings']}")
        check(comms["auto"].backend_name == "dist", "backend name")
        shards = {u: (padded(r, plan.root_pad), padded(lf, plan.leaf_pad))
                  for u, (r, lf) in data.items()}
        fetch_shards = (padded(ri, plan.root_pad), padded(li, plan.leaf_pad))

        # the dist path: counters from 0, driven through the entry points
        kops.reset_launch_counts()
        checked = 0
        for low, comm in comms.items():
            sfo = comm.backend.dist
            for u in data:
                for kind, op in DIST_OPS:
                    w = want[(u, kind, op)]
                    for obj, args in ((comm, data[u]), (sfo, shards[u])):
                        got = dist_op(obj, kind, op, *args)
                        check(same_bits(got, w), f"dist {low} "
                              f"{type(obj).__name__} {kind} {op} {u} != "
                              f"cuda")
                        checked += 1
            for got in (comm.fetch_and_op(ri, li),
                        sfo.fetch_and_op(*fetch_shards)):
                for gt, wt, m in zip(got, want_fetch, (n, E)):
                    check(same_bits(gt[:m], wt), f"dist {low} fetch_and_op")
                checked += 1
        if on_card:
            torch.cuda.synchronize()
        launches = kops.launch_counts()
        missing = missing_kernels(DIST_PATH, launches)
        check(not missing or not on_card, f"the dist path never launched "
              f"{missing}")
        named = plan_kernels(plan.comm_signature())
        check(not on_card or named <= {k for k, v in launches.items() if v},
              f"the dist path launched {launches}, its winners name "
              f"{sorted(named)}")
        # the plain versions (index_select, the plain fold): not counted
        for low in ("auto", "general"):
            plain = DistSF(sf, group=group, device=dev, lowering=low,
                           plan=plan, use_kernels=False)
            for u in data:
                for kind, op in DIST_OPS:
                    check(same_bits(dist_op(plain, kind, op, *shards[u]),
                                    want[(u, kind, op)]),
                          f"dist {low} plain {kind} {op} {u}")
                    checked += 1
        out["bitwise_checks"] = checked
        out["launches"] = {k: v for k, v in launches.items() if v}
        del want
        out.update(dist_times(sf, csr, plan, comms, cu, data[()],
                              shards[()], group, dev, it))
    gc.collect()
    return out, launches


def dist_child(device: str, grid: int, iters: int) -> int:
    """``chip_smoke.py --dist DEVICE GRID ITERS``: :func:`phase_dist` in
    this process (the kernels built already), its record and launch counts
    printed as one ``DIST_RESULT`` JSON line."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import tuning
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.build_all()          # loads the parent's build
        dev = torch.device("cuda", torch.cuda.current_device())
    tuning.on_sweep, TUNING["path"] = on_sweep, "dist"
    res, launches = phase_dist(Sizes(dist_grid=grid, timing_iters=iters),
                               dev)
    print("DIST_RESULT " + json.dumps({"record": res, "launches": launches,
                                       "tuning": TUNING["records"]}),
          flush=True)
    return 0


def dist_in_child(sz: Sizes, dev):
    """(record, launches, tuning records) of the ``dist`` phase, run by
    :func:`dist_child` in a process of its own; fails if the child
    does."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--dist", dev.type,
         str(sz.dist_grid), str(sz.timing_iters)], capture_output=True,
        text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("DIST_RESULT ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"the dist phase's child exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    out = json.loads(lines[0][len("DIST_RESULT "):])
    return out["record"], out["launches"], out["tuning"]


def dist_times(sf, csr, plan, comms, cu, data, shards, group, dev,
               it: int) -> dict:
    """Device and call ms of each op on "cuda" and "dist" (the facade and
    DistSF under both lowerings; unit () f32), of the world-1 collectives
    alone, and of bcast_begin / spmv_ell / bcast_end against sync_mode."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import DistSF
    from repro_torch.kernels import spmv_ell as ell_mod
    root, leaf = data
    rs, ls = shards
    sfo = {low: c.backend.dist for low, c in comms.items()}
    variants = {"cuda": (cu, data), "dist": (comms["auto"], data),
                "dist_general": (comms["general"], data),
                "dist_sf": (sfo["auto"], shards),
                "dist_sf_general": (sfo["general"], shards)}
    times = {}
    for kind, op in DIST_OPS:
        row = {}
        for name, (obj, args) in variants.items():
            fn = lambda: dist_op(obj, kind, op, *args)
            row[name] = {"device_ms": device_ms(fn, dev, it),
                         "call_ms": call_ms(fn, dev, it)}
        times[f"{kind}_{op}"] = row
    ri, li = (torch.randint(0, 100, (m,), device=dev, dtype=torch.int32)
              for m in (sf.nroots_total, sf.nleafspace_total))
    fri, fli = padded(ri, plan.root_pad), padded(li, plan.leaf_pad)
    row = {}
    for name, fn in (("cuda", lambda: cu.fetch_and_op(ri, li)),
                     ("dist", lambda: comms["auto"].fetch_and_op(ri, li)),
                     ("dist_sf", lambda: sfo["auto"].fetch_and_op(fri, fli)),
                     ("dist_sf_general",
                      lambda: sfo["general"].fetch_and_op(fri, fli))):
        row[name] = {"device_ms": device_ms(fn, dev, it),
                     "call_ms": call_ms(fn, dev, it)}
    times["fetch_and_op_sum"] = row
    ratio = {name: times["reduce_sum"][name]["device_ms"]
             / times["reduce_sum"]["cuda"]["device_ms"]
             for name in variants if name != "cuda"}
    # the collectives alone: the general lowering's (R*P = 1)-row
    # all-to-all, an all-to-all of the whole leaf payload, and the facade's
    # all-gather of a padded root shard
    one, one_out = rs[:1].clone(), torch.empty_like(rs[:1])
    big_out, ag_out = torch.empty_like(leaf), torch.empty_like(rs)
    colls = {}
    for name, fn, nbytes in (
            ("all_to_all_single_general", lambda: dist.all_to_all_single(
                one_out, one, group=group), one.numel() * 4),
            ("all_to_all_single_leaf_payload", lambda: dist.all_to_all_single(
                big_out, leaf, group=group), leaf.numel() * 4),
            ("all_gather_into_tensor_root_shard",
             lambda: dist.all_gather_into_tensor(ag_out, rs, group=group),
             rs.numel() * 4)):
        colls[name] = {"bytes": nbytes, "device_ms": device_ms(fn, dev, it),
                       "call_ms": call_ms(fn, dev, it)}
    # the paper's §4.1 overlap: the bcast in flight over the local SpMV
    ell_data, ell_cols, _ = csr.to_ell(np.float32)
    ed = torch.as_tensor(ell_data, device=dev)
    ec = torch.as_tensor(ell_cols, device=dev)
    xz = torch.cat([root, root.new_zeros(1)])
    sync = DistSF(sf, group=group, device=dev, lowering="general",
                  plan=plan, sync_mode=True)

    def split(obj):
        def run():
            pend = obj.bcast_begin(rs)
            y = ell_mod.spmv_ell(ed, ec, xz)
            return obj.bcast_end(pend, ls), y
        return run
    lv_a, y_a = split(sfo["general"])()
    lv_s, y_s = split(sync)()
    check(same_bits(lv_a, lv_s) and same_bits(y_a, y_s),
          "sync_mode changed the bits")
    check(same_bits(lv_a[: sf.nleafspace_total],
                    cu.bcast(root, torch.zeros_like(leaf))), "bcast + spmv")
    overlap = {"begin_spmv_end_ms": [], "sync_mode_ms": []}
    for name in ("begin_spmv_end_ms", "sync_mode_ms", "sync_mode_ms",
                 "begin_spmv_end_ms"):
        obj = sfo["general"] if name == "begin_spmv_end_ms" else sync
        overlap[name].append(call_ms(split(obj), dev, it))
    overlap["spmv_alone_ms"] = call_ms(lambda: ell_mod.spmv_ell(ed, ec, xz),
                                       dev, it)
    overlap["bcast_alone_ms"] = call_ms(
        lambda: dist_op(sfo["general"], "bcast", "replace", rs, ls), dev, it)
    return {"times": times, "reduce_sum_device_ratio_to_cuda": ratio,
            "collectives": colls, "overlap": overlap}


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


# -------------------------------------------------------------------- moe
def moe_config(sz: Sizes, arch: str = None):
    from repro_torch.configs import get_config
    cfg = get_config(arch or sz.moe_arch)
    return cfg.smoke_config() if sz.moe_smoke else cfg


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the SF entry points that ``DynPlan`` (and so the
    MoE layer) calls, ``kops.pack_rows`` and ``kops.segment_reduce_rows``,
    are their plain PyTorch versions: the yardstick a run with the
    kernels is held against, bit for bit."""
    from repro_torch.kernels import ops as kops, sf_pack, sf_unpack
    real = kops.pack_rows, kops.segment_reduce_rows

    def pack_rows(data, idx, *, dynamic=False, key=None):
        return sf_pack.pack_plain(data, idx)

    def segment_reduce_rows(sv, first, length, *, op="sum", key=None,
                            dynamic=False):
        return sf_unpack.segment_reduce_plain(sv, first, length, op)
    kops.pack_rows, kops.segment_reduce_rows = pack_rows, segment_reduce_rows
    try:
        yield
    finally:
        kops.pack_rows, kops.segment_reduce_rows = real


@contextlib.contextmanager
def recorded_gathers(log: list):
    """Within the block, every ``kops.pack_rows`` call appends its
    ``(data, idx)`` to ``log`` and runs as it does."""
    from repro_torch.kernels import ops as kops
    real = kops.pack_rows

    def pack_rows(data, idx, *, dynamic=False, key=None):
        log.append((data, idx))
        return real(data, idx, dynamic=dynamic, key=key)
    kops.pack_rows = pack_rows
    try:
        yield
    finally:
        kops.pack_rows = real


@contextlib.contextmanager
def no_host_sync(dev):
    """Within the block any synchronising CUDA call raises (on the card)."""
    import torch
    if dev.type != "cuda":
        yield
        return
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


GATHER_CALLS = 20      # gathers a timing graph holds, back to back


def burst_ms(fn, dev, it: int) -> float:
    """Device ms per ``fn()`` from CUDA events around replays of a CUDA
    graph of ``GATHER_CALLS`` back-to-back calls (no profiler: in the long
    run torch.profiler returned windows of such calls without any kernel);
    the gaps between the kernels are in the time (the host's time per call
    on the CPU)."""
    return graph_ms(lambda: [fn() for _ in range(GATHER_CALLS)], dev,
                    it) / GATHER_CALLS


def gather_record(what: str, data, idx, dev, it: int) -> dict:
    """One gather of the MoE path on its own inputs: the kernel (through
    ``pack_rows``' runtime-index route, on the int32 index it launches
    with) bitwise against the plain version, and device ms of the kernel,
    the plain version and ``index_select`` (:func:`burst_ms`) beside its
    bound; for ``pack`` rows also its first kernel (``prev_ms``: the
    checked generic loop, one row per CTA) and its variants
    (``variants_ms``: each chunk size forced, plain stores)."""
    import torch
    from repro_torch.kernels import ops as kops, sf_pack
    i32 = idx.to(torch.int32)
    got = kops.pack_rows(data, i32, dynamic=True)
    want = data[idx.long()]
    check(same_bits(got, want), f"{what}: gather differs from plain")
    rb = math.prod(data.shape[1:]) * data.element_size()
    M = int(idx.numel())
    # each source row this index reads, once; each output row and index
    # entry, once
    b, by = bound((int(torch.unique(idx).numel()) + M) * rb + 4.0 * M)
    wide = math.prod(data.shape[1:]) >= kops.WIDE_ROW
    i64 = idx.long()
    rec = {"what": what, "kernel": "pack" if wide else "pack_blocked",
           "rows": M, "source_rows": int(data.shape[0]), "row_bytes": rb,
           "dtype": str(data.dtype).split(".")[-1],
           "ms": burst_ms(
               lambda: kops.pack_rows(data, i32, dynamic=True), dev, it),
           "plain_ms": burst_ms(lambda: data[i64], dev, it),
           "library_ms": burst_ms(
               lambda: torch.index_select(data, 0, i64), dev, it),
           "bound_ms": b, "bound_by": by}
    if wide:
        prev = lambda: sf_pack.gather_generic(data, i32, rows_per_cta=1,
                                              dynamic=True)
        check(same_bits(prev(), got), f"{what}: generic gather differs")
        rec["prev_ms"] = burst_ms(prev, dev, it)
        rec["variants_ms"] = wide_variants(data, i32, dev, it, dynamic=True,
                                           timer=burst_ms)
        rec["plan"] = dataclasses.asdict(sf_pack.pack_plan(data, i32, got))
    return rec


def moe_gathers(label: str, x, p, cfg, dev, it: int) -> list:
    """The gathers one ``moe_layer(x, dispatch="sf")`` call makes, each
    timed on its own inputs (:func:`gather_record`)."""
    from repro_torch.models import moe as M
    log = []
    with recorded_gathers(log):
        M.moe_layer(x, p, cfg, dispatch="sf")
    shape = "x".join(str(d) for d in x.shape[:2])
    names = (["dispatch", "combine"] if len(log) == 2
             else ["dispatch", "weights", "combine"])
    return [gather_record(f"{label} {shape} {n}", d, i, dev, it)
            for n, (d, i) in zip(names, log)]


def fuse_switch(x, p, cfg, dev, it: int) -> dict:
    """``moe_layer(x)`` with each dispatch lowering forced (the fused
    two-field reduce, and the leaf_rep gather), in turns: ms per call
    (CUDA events, host included) against the reference's switch
    ``_FUSE_MAX_LEAVES``, which picks one of them by the number of picks."""
    from repro_torch.models import moe as M
    switch = M._FUSE_MAX_LEAVES
    picks = x.shape[0] * x.shape[1] * cfg.moe_topk
    runs = {"fused": 1 << 62, "leaf_rep": 0}
    ms = {k: [] for k in runs}
    try:
        for name in ("fused", "leaf_rep", "leaf_rep", "fused"):
            M._FUSE_MAX_LEAVES = runs[name]
            ms[name].append(call_ms(lambda: M.moe_layer(x, p, cfg), dev, it))
    finally:
        M._FUSE_MAX_LEAVES = switch
    return {"shape": list(x.shape[:2]), "picks": picks,
            "switch_takes": "fused" if picks <= switch else "leaf_rep",
            "call_ms": ms}


def routing_stats(x, p, cfg) -> dict:
    """Groups, capacity and kept picks of ``moe_layer``'s routing of x."""
    import torch
    from repro_torch.models import moe as M
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_topk
    G = B if S > 1 else 1
    T = B * S // G
    logits = torch.einsum("gtd,de->gte", x.reshape(G, T, D).float(),
                          p["router"])
    _, eidx = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    C = max(int(np.ceil(T * k * cfg.moe_capacity / E)), 1)
    _, keep = M._capacity_slots(eidx, C, E)
    return {"groups": G, "tokens_per_group": T, "capacity": C,
            "roots": G * E * C, "picks": G * T * k,
            "kept": int(keep.sum())}


def dyn_routing(nroots: int, nleaves: int, gen, dev, unique=False):
    """A random routing on the device: duplicate writers, unrouted roots
    and 10% drops; ``unique``: each root written at most once (the rest
    dropped)."""
    import torch
    if unique:
        perm = torch.randperm(nleaves, generator=gen, device=dev)
        return torch.where(perm < nroots, perm, nroots)
    lr = torch.randint(0, nroots, (nleaves,), generator=gen, device=dev)
    drop = torch.rand(nleaves, generator=gen, device=dev) < 0.1
    return torch.where(drop, nroots, lr)


# bcast: rows of 4 f32 (the narrow gather), bcast_wide: rows of 300 f32
# (the wide gather), unique: scatter_, general: _assert_async; pack_odd:
# ``pack(dynamic=True)`` itself on 8,194-byte bf16 rows from data[1:] (the
# wide gather's checked instance with a source skew)
OUT_OF_RANGE_ROUTES = ("bcast", "bcast_wide", "unique", "general",
                       "pack_odd")


def out_of_range_child(route: str, device: str) -> int:
    """``chip_smoke.py --out-of-range ROUTE DEVICE``: one DynPlan operation
    whose leaf_root holds nroots + 1.  It must fail (on the card: the
    gather kernel's trap, ``scatter_``'s or ``_assert_async``'s device
    assert); returning 0 means the bad index went through."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.core import DynPlan
    from repro_torch.kernels import sf_pack
    dev = torch.device(device)
    plan = DynPlan(8, 16)
    lr = torch.arange(16, device=dev) % 9
    lr[5] = 9
    data = torch.ones(16, 4, device=dev)
    if route.startswith("bcast"):
        width = 300 if route == "bcast_wide" else 4
        plan.bcast(torch.ones(8, width, device=dev), lr)
    elif route == "pack_odd":
        rows = torch.ones(9, 4097, dtype=torch.bfloat16, device=dev)[1:]
        sf_pack.pack(rows, lr, dynamic=True)
    elif route == "unique":
        plan.reduce(data, lr, unique=True)
    else:
        plan.reduce(data, lr, op="sum")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print("an out-of-range leaf_root went through", flush=True)
    return 0


def out_of_range_checks(dev) -> dict:
    """Each DynPlan route in a child process of its own (a device-side
    failure ends the CUDA context): each must exit non-zero."""
    procs = {r: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--out-of-range", r,
         dev.type], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in OUT_OF_RANGE_ROUTES}
    out = {}
    for r, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        lines = [ln for ln in log.strip().splitlines() if ln.strip()]
        out[r] = {"exit": proc.returncode,
                  "message": [ln[:160] for ln in lines
                              if "outside" in ln or "Error" in ln
                              or "assert" in ln][:3]}
        check(proc.returncode != 0 and "went through" not in log,
              f"an out-of-range leaf_root went through DynPlan's {r} "
              f"route: {log[-2000:]}")
        check(out[r]["message"], f"the {r} route failed without a "
              f"message: {log[-2000:]}")
    return out


def fresh_bcast_gather(root, lr, dev, iters: int = 5) -> dict:
    """The gather of ``DynPlan.bcast(root, lr)`` alone: ``pack`` on the
    padded roots (the call's ``cat`` of a zero drop row, made once here)
    through the runtime-index route, bitwise against ``index_select``;
    ms per call of both from CUDA events around ``iters`` calls (each
    writes a fresh 2 GB output; torch.profiler returned no events for such
    windows in this phase) beside the gather's bound (each root row read
    once, each leaf row and index entry written once)."""
    import torch
    from repro_torch.kernels import ops as kops
    rootpad = torch.cat([root, root.new_zeros((1,) + tuple(root.shape[1:]))])
    i32, i64 = lr.to(torch.int32), lr.long()
    run = lambda: kops.pack_rows(rootpad, i32, dynamic=True)
    check(same_bits(run(), torch.index_select(rootpad, 0, i64)),
          "DynPlan's fresh bcast gather != index_select")
    rb = math.prod(root.shape[1:]) * root.element_size()
    L = int(lr.numel())
    bms, by = bound((int(torch.unique(lr).numel()) + L) * rb + 4.0 * L)
    return {"rows": L, "row_bytes": rb, "ms": call_ms(run, dev, iters),
            "library_ms": call_ms(
                lambda: torch.index_select(rootpad, 0, i64), dev, iters),
            "ms_by": "CUDA events", "bound_ms": bms, "bound_by": by}


def moe_dynplan(sz: Sizes, dev) -> dict:
    """(a) DynPlan at dispatch scale: every operation bitwise against its
    plain version on the card, the general reduce against SFComm on the
    routing's SF, an out-of-range leaf_root failing."""
    import torch
    from repro_torch.core import DynPlan, SFComm, star_forest_from_assignment
    R, L = sz.dyn_roots, sz.dyn_leaves
    g = torch.Generator(device=dev).manual_seed(11)
    plan = DynPlan(R, L)
    lr = dyn_routing(R, L, g, dev)
    lru = dyn_routing(R, L, g, dev, unique=True)
    comm = SFComm(star_forest_from_assignment(lr.cpu(), R), backend="cuda",
                  device=dev)
    out = {"roots": R, "leaves": L, "dropped": int((lr == R).sum()),
           "unique_dropped": int((lru == R).sum()), "units": {}}
    for unit, dtype in (((sz.dyn_width,), torch.bfloat16),
                        ((), torch.float32)):
        root = torch.randn((R,) + unit, generator=g, device=dev).to(dtype)
        leaf = torch.randn((L,) + unit, generator=g, device=dev).to(dtype)
        cases = {
            "bcast_fresh": lambda: plan.bcast(root, lr),
            "bcast_keep_prior": lambda: plan.bcast(root, lr, leaf),
            "reduce_unique": lambda: plan.reduce(leaf, lru, unique=True),
            "reduce_unique_rootdata": lambda: plan.reduce(
                leaf, lru, root, unique=True),
            "leaf_rep_2": lambda: plan.reduce(leaf[:L // 2], lru,
                                              unique=True, leaf_rep=2),
            "leaf_rep_8": lambda: plan.reduce(leaf[:L // 8], lru,
                                              unique=True, leaf_rep=8),
            "reduce_sum": lambda: plan.reduce(leaf, lr, root, op="sum"),
            "reduce_max": lambda: plan.reduce(leaf, lr, root, op="max"),
        }
        rec = {}
        for name, fn in cases.items():
            got = fn()
            with plain_kernels():
                want = fn()
            check(same_bits(got, want), f"DynPlan {name} {unit} {dtype}: "
                  f"kernels differ from the plain version")
            rec[name] = {"bitwise": True}
            if name in ("bcast_fresh", "reduce_unique", "reduce_sum"):
                # whole calls (CUDA events): torch.profiler drops the
                # events of windows this long
                rec[name]["call_ms"] = call_ms(fn, dev, 5)
                with plain_kernels():
                    rec[name]["plain_call_ms"] = call_ms(fn, dev, 5)
        if unit:
            rec["bcast_fresh_gather"] = fresh_bcast_gather(root, lr, dev)
        for op in ("sum", "max"):
            check(same_bits(plan.reduce(leaf, lr, root, op=op),
                            comm.reduce(leaf, root, op=op)),
                  f"DynPlan general {op} != SFComm on the routing's SF")
        rec["general_equals_sfcomm"] = ["sum", "max"]
        out["units"][f"{unit} {str(dtype).split('.')[-1]}"] = rec
        del root, leaf
    out["out_of_range"] = out_of_range_checks(dev)
    return out


def moe_layer_checks(sz: Sizes, dev) -> dict:
    """(b) phi3.5-moe, one MoE layer at full width in float32: SF against
    dense at the reference's tolerance at decode, prefill and a starved
    prefill; SF with kernels against SF with plain gathers, bitwise; both
    SF lowerings with no host synchronisation; each gather timed."""
    import torch
    from repro_torch.models import moe as M
    cfg = moe_config(sz).scaled(dtype="float32")
    g = torch.Generator(device=dev).manual_seed(21)
    p = {k: v[0] for k, v in M.init_moe(cfg, 1, generator=g,
                                        device=dev).items()}
    D = cfg.d_model
    out = {"arch": cfg.name, "dtype": "float32", "d_model": D,
           "experts": cfg.moe_experts, "topk": cfg.moe_topk,
           "d_ff": cfg.moe_dff, "cases": {}, "gathers": []}
    for name, shape, c in (
            ("decode", (sz.moe_decode_batch, 1), cfg),
            ("prefill", (1, sz.moe_prefill), cfg),
            ("prefill_starved", (1, sz.moe_prefill),
             cfg.scaled(moe_capacity=0.3))):
        x = torch.randn(shape + (D,), generator=g, device=dev)
        y_sf, a_sf = M.moe_layer(x, p, c, dispatch="sf")
        y_d, a_d = M.moe_layer(x, p, c, dispatch="dense")
        err = max_abs(y_sf, y_d)
        check(bool(torch.allclose(y_sf, y_d, rtol=MOE_RTOL, atol=MOE_ATOL)),
              f"moe {name}: sf vs dense max|d| {err}")
        check(abs(float(a_sf) - float(a_d)) <= MOE_AUX_RTOL * abs(float(a_d)),
              f"moe {name}: aux {float(a_sf)} vs {float(a_d)}")
        with plain_kernels():
            y_p, _ = M.moe_layer(x, p, c, dispatch="sf")
        check(same_bits(y_sf, y_p), f"moe {name}: kernels != plain gathers")
        with no_host_sync(dev):
            y_s, _ = M.moe_layer(x, p, c, dispatch="sf")
        check(same_bits(y_s, y_sf), f"moe {name}: not repeatable")
        r = routing_stats(x, p, c)
        if name == "prefill_starved":
            check(r["kept"] < r["picks"], "the starved prefill dropped "
                  "no pick")
        lowering = "fused" if r["picks"] <= M._FUSE_MAX_LEAVES else \
            "leaf_rep"
        out["cases"][name] = {"shape": list(shape), "lowering": lowering,
                              "routing": r, "sf_vs_dense_max_abs": err,
                              "aux": float(a_sf),
                              "kernels_equal_plain_gathers": True,
                              "no_host_sync": dev.type == "cuda"}
        if name != "prefill_starved":
            out["gathers"] += moe_gathers("phi f32", x, p, c, dev, 10)
    out["tolerance"] = {"rtol": MOE_RTOL, "atol": MOE_ATOL,
                        "aux_rtol": MOE_AUX_RTOL}
    del p
    return out


def moe_wide(sz: Sizes, dev) -> dict:
    """(c) kimi-k2, one MoE layer with its shared expert at full width in
    bf16 (the 384-way fan): kernels against plain gathers bitwise at
    decode and prefill, each gather timed."""
    import torch
    from repro_torch.models import moe as M
    cfg = moe_config(sz, sz.moe_wide_arch)
    g = torch.Generator(device=dev).manual_seed(31)
    t0 = time.perf_counter()
    p = {k: v[0] for k, v in M.init_moe(cfg, 1, generator=g,
                                        device=dev).items()}
    sync(dev)
    out = {"arch": cfg.name, "dtype": cfg.dtype, "d_model": cfg.d_model,
           "experts": cfg.moe_experts, "topk": cfg.moe_topk,
           "d_ff": cfg.moe_dff, "shared_ff": cfg.moe_shared_ff,
           "param_bytes": sum(v.numel() * v.element_size()
                              for v in p.values()),
           "init_s": time.perf_counter() - t0, "cases": {}, "gathers": []}
    for name, shape in (("decode", (sz.moe_decode_batch, 1)),
                        ("prefill", (1, sz.moe_prefill))):
        x = torch.randn(shape + (cfg.d_model,), generator=g,
                        device=dev).to(torch.bfloat16)
        y, _ = M.moe_layer(x, p, cfg, dispatch="sf")
        with plain_kernels():
            y_p, _ = M.moe_layer(x, p, cfg, dispatch="sf")
        check(same_bits(y, y_p), f"kimi {name}: kernels != plain gathers")
        check(bool(torch.isfinite(y).all()), f"kimi {name}: not finite")
        out["cases"][name] = {"shape": list(shape),
                              "routing": routing_stats(x, p, cfg),
                              "kernels_equal_plain_gathers": True}
        out["gathers"] += moe_gathers("kimi bf16", x, p, cfg, dev, 10)
    del p
    return out


def grouped_kernels(by_name: dict) -> dict:
    """Device ms of a profiled window by ``KERNEL_GROUPS``."""
    out = {}
    for name, ms in by_name.items():
        group = next((gname for gname, words in KERNEL_GROUPS
                      if any(w in name for w in words)), "other")
        out[group] = out.get(group, 0.0) + ms
    return out


def moe_engine_check(cfg, sz: Sizes, dev, rng) -> dict:
    """One request through ``ServeEngine(batch=1, bucket_prompts=False)``
    equals direct greedy prefill + decode_step: at batch 1 both route each
    token alone.  In float32 at two layers of the full width, as the serve
    phase: the engine's decode keeps the reference engine's unrounded
    attention probabilities where ``decode_step`` rounds them to the cache
    dtype, so only float32 makes the two decodes round alike."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine
    cfg32 = cfg.scaled(dtype="float32", n_layers=2)
    g = torch.Generator(device=dev).manual_seed(1)
    p32 = T.init_params(cfg32, generator=g, device=dev)
    toks = rng.integers(0, cfg.vocab, 64).tolist()
    req = Request(0, toks, max_new=8)
    ServeEngine(cfg32, p32, batch=1, s_max=256, bucket_prompts=False,
                device=dev).run([req])
    lg, cache = T.prefill(p32, cfg32, tokens=[toks], s_max=256)
    tok = torch.argmax(lg, -1)
    want = [int(tok[0])]
    for _ in range(7):
        lg, cache = T.decode_step(p32, cfg32, tok, cache)
        tok = torch.argmax(lg, -1)
        want.append(int(tok[0]))
    check(req.out == want, f"moe engine stream {req.out} != direct "
          f"greedy {want}")
    del p32, cache
    return {"layers": 2, "dtype": "float32", "batch": 1, "tokens": len(want)}


def moe_serve(sz: Sizes, dev) -> dict:
    """(d) phi3.5-moe served in bf16 at full width, ``moe_layers`` layers,
    random weights from a seeded generator: the batch-1 engine check, the
    gathers timed at the serving shapes (layer 0), then the serve phase's
    trace through ``ServeEngine(batch=8, s_max=2048)`` + ``loadgen.drive``
    with the launch counters from 0, and profiled windows of one prefill
    and of five decode steps."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops as kops
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine, drive, \
        trace_fingerprint
    rng = np.random.default_rng(6)
    base = moe_config(sz)
    cfg = base.scaled(n_layers=min(sz.moe_layers, base.n_layers))
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "of_layers": base.n_layers, "d_model": cfg.d_model}
    out["engine_equals_direct_greedy"] = moe_engine_check(cfg, sz, dev, rng)
    gc.collect()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, generator=g, device=dev)
    sync(dev)
    leaves = [params["embed"], params["final_norm"],
              *params["blocks"].values()] + \
        ([] if cfg.tie_embeddings else [params["lm_head"]])
    out.update({"params": sum(t.numel() for t in leaves),
                "param_bytes": sum(t.numel() * t.element_size()
                                   for t in leaves),
                "init_s": time.perf_counter() - t0})
    # the gathers at the serving shapes, on layer 0's leaves
    bp = T.layer(params["blocks"], 0)
    gathers = []
    for shape in ((sz.serve_batch, 1), (1, sz.moe_prefill)):
        x = torch.randn(shape + (cfg.d_model,), generator=g,
                        device=dev).to(torch.bfloat16)
        gathers += moe_gathers("phi bf16", x, bp, cfg, dev,
                               sz.timing_iters)
        out.setdefault("fuse_switch", []).append(
            fuse_switch(x, bp, cfg, dev, sz.timing_iters))
    out["gathers"] = gathers

    trace = serve_trace(sz, cfg)
    eng = ServeEngine(cfg, params, batch=sz.serve_batch, s_max=sz.serve_s_max,
                      device=dev)
    M.plan_cache().clear()
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
    sm90 = fa.flash_attention.launches_sm90
    reqs = [r for _, r in trace]
    check(all(r.done and len(r.out) == r.max_new for r in reqs),
          "a MoE request did not finish with its budget of tokens")
    check(counts["flash_attention"] == cfg.n_layers * len(reqs) or
          dev.type != "cuda", f"moe flash launches "
          f"{counts['flash_attention']} != {cfg.n_layers} x {len(reqs)}")
    check(sm90 == counts["flash_attention"], f"only {sm90} of "
          f"{counts['flash_attention']} moe flash launches took the wgmma "
          f"route")
    out.update({"trace_fingerprint": trace_fingerprint(trace),
                "requests": len(reqs),
                "prompt_tokens": sum(r.prompt_len for r in reqs),
                "drive_wall_s": wall, "metrics": metrics,
                "plan_cache": M.plan_cache().stats(),
                "launches": counts, "flash_launches_sm90": sm90,
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None})

    # where the time goes: a prefill of the largest bucket alone, and five
    # decode steps of all slots after 8 requests were admitted
    for i in range(sz.serve_batch):
        eng.submit(Request(300 + i, rng.integers(
            0, cfg.vocab, sum(sz.serve_prompt) // 2).tolist(), max_new=64))
    eng.step()
    big = rng.integers(0, cfg.vocab, (1, max(serve_buckets(trace, sz))))
    windows = {f"prefill_{big.shape[1]}": lambda: T.prefill(
                   params, cfg, tokens=big, s_max=sz.serve_s_max),
               "5_decode_steps": lambda: [eng.step() for _ in range(5)]}
    for name, fn in windows.items():
        # taken again while the profiler returns no device event
        for wait in (0.0,) + RETAKE_WAITS_S:
            time.sleep(wait)
            by_name, wall_ms = profiled(fn, dev)
            if by_name or dev.type != "cuda":
                break
            PROFILER_WINDOWS["retaken"] += 1
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        out[f"profiled_{name}"] = {
            "wall_ms": wall_ms, "device_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "by_group_ms": grouped_kernels(by_name),
            "top_kernels_ms": {k[:60]: v for k, v in top}}
    del eng, params, bp
    gc.collect()
    return out


def phase_moe(sz: Sizes, dev) -> dict:
    """The MoE slice: (a) DynPlan, (b) phi's layer in float32, (c) kimi's
    layer, (d) phi served; only (d)'s drive is the counted path."""
    import torch
    t0 = time.perf_counter()
    out = {"phase": "moe"}
    for key, part in (("dynplan", moe_dynplan), ("layer", moe_layer_checks),
                      ("wide_layer", moe_wide), ("serve", moe_serve)):
        t1 = time.perf_counter()
        out[key] = part(sz, dev)
        out[key]["seconds"] = time.perf_counter() - t1
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["launches"] = out["serve"].pop("launches")
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------- families
# the families phase's sizes for a rehearsal on the CPU (smoke configs)
FAMILIES_SMOKE = dict(
    hymba_batch=4, hymba_s_max=64, hymba_requests=4, hymba_prompt=(4, 40),
    hymba_new=(2, 6), hymba_check_prompt=24, hymba_short_scan=10,
    hymba_stream_prompt=24,
    whisper_batch=2, whisper_frames=24, whisper_s_max=32, whisper_steps=4,
    xlstm_batch=2, xlstm_prefill=16, xlstm_steps=3, xlstm_check=20,
    llava_layers=2, llava_tokens=16, timing_iters=2)


def family_config(arch: str, sz: Sizes):
    """``arch``'s published config (its smoke config with
    ``families_smoke``, for rehearsals on the CPU)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.smoke_config() if sz.families_smoke else cfg


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def family_flash(dev, what: str, B: int, Sq: int, Skv: int, H: int,
                 Hkv: int, D: int, causal: bool, window, it: int) -> dict:
    """Row 8 at a family's shape, bf16: the kernel against its plain
    version within FLASH_TOL, device ms (CUDA-graph replays between CUDA
    events: torch.profiler drops events in this process's late windows)
    beside the bound and SDPA on the same inputs (with the boolean mask
    where one is needed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(7 * Sq + Skv)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).bfloat16()
    run = lambda: fa.flash_attention(q, k, v, causal=causal, window=window)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
    err = flash_check(run(), plain(), f"flash at {what}")
    mask = None
    if causal or window is not None:
        qpos = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=dev)[None, :]
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    nops = 4.0 * visible_pairs(Sq, Skv, causal, window) * H * D * B
    bms, by = bound(nbytes, nops, BF16_OPS_PER_S)
    rec = {"what": what, "B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hkv": Hkv,
           "D": D, "causal": causal, "window": window,
           "route": fa.route(q.dtype, D), "max_abs_err": err,
           "ms": graph_ms(run, dev, it), "plain_ms": graph_ms(plain, dev, it),
           "library_ms": graph_ms(library, dev, it),
           "bound_ms": bms, "bound_by": by}
    rec["share_of_bound"] = bms / rec["ms"]
    return rec


@contextlib.contextmanager
def checked_attention_core(log: list):
    """Within the block, every prefill attention core call (the flash
    kernel) is held against its plain version within FLASH_TOL; ``log``
    gets each call's shape and max|d|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    real = kops.flash_attention

    def core(q, k, v, **kw):
        out = real(q, k, v, **kw)
        what = f"{tuple(q.shape)} over {tuple(k.shape)} {kw}"
        log.append({"q": list(q.shape), "k": list(k.shape),
                    "causal": kw.get("causal", True),
                    "max_abs_err": flash_check(
                        out, fa.flash_attention_plain(q, k, v, **kw), what)})
        return out
    kops.flash_attention = core
    try:
        yield
    finally:
        kops.flash_attention = real


def prefill_vs_decode(T, params, cfg, inputs: dict, s_max: int) -> dict:
    """prefill(prompt)'s last logits against prefill(prompt[:-1]) +
    decode_step(prompt[-1]), ||d|| / ||y|| within PREFILL_DECODE_REL_TOL
    (``inputs``: tokens, and enc_embeds where the model has an encoder)."""
    import torch
    toks = inputs["tokens"]
    full, _ = T.prefill(params, cfg, s_max=s_max, **inputs)
    _, cache = T.prefill(params, cfg, s_max=s_max,
                         **{**inputs, "tokens": toks[:, :-1]})
    step, _ = T.decode_step(params, cfg, toks[:, -1], cache)
    a, b = full.float(), step.float()
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          f"{cfg.name}: prefill / decode logits are not finite")
    rel = float((a - b).norm() / b.norm())
    check(rel <= PREFILL_DECODE_REL_TOL, f"{cfg.name} prefill vs decode "
          f"logits: ||d||/||y|| {rel} > {PREFILL_DECODE_REL_TOL}")
    return {"prompt": int(toks.shape[1]), "rel_l2": rel,
            "tol": PREFILL_DECODE_REL_TOL, "max_abs": max_abs(a, b),
            "same_argmax": bool((a.argmax(-1) == b.argmax(-1)).all())}


def counted(run, acc: dict):
    """``run()`` with the launch counters from 0; its counts are added to
    ``acc``.  Returns (result, seconds)."""
    from repro_torch.kernels import ops as kops
    sync_all()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    sync_all()
    secs = time.perf_counter() - t0
    for k, v in kops.launch_counts().items():
        acc[k] = acc.get(k, 0) + v
    return res, secs


def sync_all() -> None:
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profiled_groups(fn, dev) -> dict:
    """A profiled window of ``fn()``: wall and device ms, idle share and
    device ms by kernel group (taken again while the profiler returns no
    device event)."""
    for wait in (0.0,) + RETAKE_WAITS_S:
        time.sleep(wait)
        by_name, wall_ms = profiled(fn, dev)
        if by_name or dev.type != "cuda":
            break
        PROFILER_WINDOWS["retaken"] += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "by_group_ms": grouped_kernels(by_name),
            "top_kernels_ms": {k[:60]: v for k, v in top}}


def families_hymba(sz: Sizes, dev, rng, acc: dict) -> dict:
    """hymba-1.5b at its published width and depth in bf16, served: the
    checks, then ``hymba_requests`` requests through ``ServeEngine`` +
    ``loadgen.drive`` (counted), profiled windows, row 8 at its shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.serving import (LoadSpec, Request, ServeEngine, drive,
                                     synthesize, trace_fingerprint)
    cfg = family_config("hymba-1.5b", sz)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, generator=g, device=dev)
    sync(dev)
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "window": cfg.attn_window,
           "global_layers": [int(i) for i in np.flatnonzero(
               T.hymba_windows(cfg, sz.hymba_s_max) == sz.hymba_s_max)],
           "param_bytes": tree_bytes(params),
           "init_s": time.perf_counter() - t0}
    stages = out["stage_s"] = {}
    t1 = time.perf_counter()
    n = sz.hymba_check_prompt
    out["prefill_vs_decode"] = prefill_vs_decode(
        T, params, cfg, {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (1, n)), device=dev)}, n)
    stages["prefill_vs_decode"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    # one request through the engine at batch 1 equals direct greedy
    # decoding: float32, two layers of the full width (layer 0 global,
    # layer 1 sliding), a prompt past the window
    cfg32 = cfg.scaled(dtype="float32", n_layers=2)
    p32 = T.init_params(cfg32, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    toks = rng.integers(0, cfg.vocab, sz.hymba_stream_prompt).tolist()
    s32 = sz.hymba_stream_prompt + 16
    req = Request(0, toks, max_new=8)
    ServeEngine(cfg32, p32, batch=1, s_max=s32, device=dev).run([req])
    lg, cache = T.prefill(p32, cfg32, tokens=[toks], s_max=s32)
    want = [int(lg.argmax(-1)[0])]
    for _ in range(7):
        lg, cache = T.decode_step(p32, cfg32, [want[-1]], cache)
        want.append(int(lg.argmax(-1)[0]))
    check(req.out == want, f"hymba engine stream {req.out} != direct "
          f"greedy {want}")
    out["engine_equals_direct_greedy"] = {
        "layers": 2, "dtype": "float32", "prompt": len(toks),
        "tokens": len(want)}
    del p32, cache
    gc.collect()
    stages["engine_stream"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["ssm_scan"] = ssm_scan_record(params, cfg, sz, dev, rng)
    stages["ssm_scan"] = time.perf_counter() - t1

    trace = synthesize(LoadSpec(rate_rps=1000.0,
                                n_requests=sz.hymba_requests,
                                prompt_len=sz.hymba_prompt,
                                max_new=sz.hymba_new, vocab=cfg.vocab,
                                seed=0))
    eng = ServeEngine(cfg, params, batch=sz.hymba_batch,
                      s_max=sz.hymba_s_max, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    drive_counts = {}
    metrics, wall = counted(lambda: drive(eng, trace), drive_counts)
    for k, v in drive_counts.items():
        acc[k] = acc.get(k, 0) + v
    reqs = [r for _, r in trace]
    check(all(r.done and len(r.out) == r.max_new for r in reqs),
          "a hymba request did not finish with its budget of tokens")
    sm90 = fa.flash_attention.launches_sm90
    check(drive_counts["flash_attention"] == cfg.n_layers * len(reqs)
          or dev.type != "cuda", f"hymba flash launches "
          f"{drive_counts['flash_attention']} != {cfg.n_layers} x "
          f"{len(reqs)} prefills")
    check(sm90 == drive_counts["flash_attention"], f"only {sm90} of "
          f"{drive_counts['flash_attention']} hymba flash launches took "
          f"the wgmma route")
    longest = max(r.prompt_len for r in reqs)
    out.update({"trace_fingerprint": trace_fingerprint(trace),
                "requests": len(reqs), "longest_prompt": longest,
                "prompt_tokens": sum(r.prompt_len for r in reqs),
                "prompts_past_window": sum(r.prompt_len > (cfg.attn_window
                                                           or 0)
                                           for r in reqs),
                "drive_wall_s": wall, "metrics": metrics,
                "launches": drive_counts,
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None,
                "ssm_graphs_after_drive": ssm_graphs()})
    # where the time goes: the longest prompt's prefill alone, and five
    # decode steps of all slots
    for i in range(sz.hymba_batch):
        eng.submit(Request(300 + i, rng.integers(
            0, cfg.vocab, sum(sz.hymba_prompt) // 2).tolist(), max_new=64))
    eng.step()
    big = torch.as_tensor(rng.integers(0, cfg.vocab, (1, longest)),
                          device=dev)
    t1 = time.perf_counter()
    out[f"profiled_prefill_{longest}"] = profiled_groups(
        lambda: T.prefill(params, cfg, tokens=big, s_max=sz.hymba_s_max), dev)
    out["profiled_5_decode_steps"] = profiled_groups(
        lambda: [eng.step() for _ in range(5)], dev)
    stages["profiled_windows"] = time.perf_counter() - t1
    del eng, params
    gc.collect()
    t1 = time.perf_counter()
    out["flash"] = [
        family_flash(dev, f"hymba sliding layer, prefill {longest}", 1,
                     longest, longest, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                     True, cfg.attn_window, sz.timing_iters),
        family_flash(dev, f"hymba global layer, prefill {longest}", 1,
                     longest, longest, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                     True, None, sz.timing_iters)]
    stages["flash"] = time.perf_counter() - t1
    return out


def ssm_scan_record(params, cfg, sz: Sizes, dev, rng) -> dict:
    """hymba layer 0's SSM scan over ``hymba_check_prompt`` tokens and over
    ``hymba_short_scan`` (less than a chunk): chunks replayed as one
    captured CUDA graph each (``models/ssm.py``, the path; the last chunk
    padded) against the same steps launched one by one, bitwise, with the
    call ms of each (host and device: the graph is there to cut the
    host's launches)."""
    import torch
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    bp = T.layer(params["blocks"], 0)
    out = {}
    for n in (sz.hymba_check_prompt, sz.hymba_short_scan):
        x = (torch.randn(1, n, cfg.d_model,
                         generator=torch.Generator(device=dev).manual_seed(3),
                         device=dev) * 0.5).to(torch.bfloat16)
        graph = lambda: S.ssm_scan(x, bp, cfg)  # noqa: E731
        real = S._chunk_graph
        S._chunk_graph = lambda *a: None     # the steps launched one by one
        try:
            eager = lambda: S.ssm_scan(x, bp, cfg)  # noqa: E731
            y_e, h_e = eager()
            eager_ms = call_ms(eager, dev, 2)
        finally:
            S._chunk_graph = real
        y_g, h_g = graph()
        check(same_raw_bits(y_g, y_e) and same_raw_bits(h_g, h_e),
              f"ssm_scan over {n} tokens: the graph chunks != the steps "
              f"launched one by one")
        out[f"tokens_{n}"] = {"bitwise_graph_vs_steps": True,
                              "graph_call_ms": call_ms(graph, dev, 2),
                              "steps_call_ms": eager_ms}
    return out


def ssm_graphs() -> dict:
    """The SSM chunk graphs this process holds, and their static buffers'
    bytes."""
    from repro_torch.models import ssm as S
    return {"count": len(S._GRAPHS),
            "bytes": sum(g.nbytes for g in S._GRAPHS.values())}


def families_whisper(sz: Sizes, dev, rng, acc: dict) -> dict:
    """whisper-base at full size in bf16: the encoder's and the cross-
    attention's flash calls against the plain version, prefill against
    decode, then prefill of a batch and ``whisper_steps`` greedy decode
    steps (counted), row 8 at its shapes."""
    import torch
    from repro_torch.models import transformer as T
    cfg = family_config("whisper-base", sz)
    g = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, generator=g, device=dev)
    B, F_, P = sz.whisper_batch, sz.whisper_frames, sz.whisper_prompt
    enc = (torch.randn(B, F_, cfg.d_model, generator=g, device=dev)
           * 0.02).to(torch.bfloat16)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), device=dev)
    out = {"arch": cfg.name, "dtype": cfg.dtype,
           "layers": [cfg.enc_layers, cfg.n_layers], "d_model": cfg.d_model,
           "batch": B, "frames": F_, "prompt": P,
           "s_max": sz.whisper_s_max, "param_bytes": tree_bytes(params)}
    log = []
    with checked_attention_core(log):
        T.prefill(params, cfg, tokens=toks, enc_embeds=enc,
                  s_max=sz.whisper_s_max)
    check(len(log) == cfg.enc_layers + 2 * cfg.n_layers,
          f"{len(log)} attention core calls in whisper's prefill")
    out["prefill_flash_checked"] = {
        "calls": len(log), "max_abs_err": max(r["max_abs_err"] for r in log),
        "encoder": log[0], "cross": log[-1]}
    out["prefill_vs_decode"] = prefill_vs_decode(
        T, params, cfg, {"tokens": toks, "enc_embeds": enc},
        sz.whisper_s_max)

    def serve():
        lg, cache = T.prefill(params, cfg, tokens=toks, enc_embeds=enc,
                              s_max=sz.whisper_s_max)
        tok = lg.argmax(-1)
        for _ in range(sz.whisper_steps):
            lg, cache = T.decode_step(params, cfg, tok, cache)
            tok = lg.argmax(-1)
        check(bool(torch.isfinite(lg).all()), "whisper logits not finite")
    counts = {}
    _, secs = counted(serve, counts)
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v
    calls = cfg.enc_layers + 2 * cfg.n_layers \
        + cfg.n_layers * sz.whisper_steps
    check(counts["flash_attention"] == calls or dev.type != "cuda",
          f"whisper flash launches {counts['flash_attention']} != {calls}")
    out["launches"] = counts
    out["prefill_and_decode_s"] = secs
    out["prefill_call_ms"] = call_ms(lambda: T.prefill(
        params, cfg, tokens=toks, enc_embeds=enc, s_max=sz.whisper_s_max),
        dev, 3)
    lg, cache = T.prefill(params, cfg, tokens=toks, enc_embeds=enc,
                          s_max=sz.whisper_s_max)
    tok = lg.argmax(-1)
    out["decode_step_call_ms"] = call_ms(
        lambda: T.decode_step(params, cfg, tok, {**cache, "pos": P}), dev,
        sz.timing_iters)
    out["flash"] = [
        family_flash(dev, "whisper encoder", B, F_, F_, cfg.n_heads,
                     cfg.n_kv_heads, cfg.hd, False, None, sz.timing_iters),
        family_flash(dev, "whisper cross-attention, prefill", B, P, F_,
                     cfg.n_heads, cfg.n_kv_heads, cfg.hd, False, None,
                     sz.timing_iters),
        family_flash(dev, "whisper cross-attention, decode", B, 1, F_,
                     cfg.n_heads, cfg.n_kv_heads, cfg.hd, False, None,
                     sz.timing_iters)]
    del params, cache
    return out


def families_xlstm(sz: Sizes, dev, rng, acc: dict) -> dict:
    """xlstm-350m at full size in bf16: decode after a prefill of
    ``xlstm_check`` tokens (not a multiple of 128) against forward of one
    more, then prefill of a batch and ``xlstm_steps`` decode steps timed.
    It runs no kernel, which the counts show."""
    import torch
    from repro_torch.models import transformer as T
    cfg = family_config("xlstm-350m", sz)
    g = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, generator=g, device=dev)
    n = sz.xlstm_check
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n + 1)),
                           device=dev)
    full, _ = T.forward(params, cfg, tokens=toks)
    _, cache = T.prefill(params, cfg, tokens=toks[:, :-1])
    step, _ = T.decode_step(params, cfg, toks[:, -1], cache)
    a, b = full[:, -1].float(), step.float()
    rel = float((a - b).norm() / a.norm())
    check(rel <= PREFILL_DECODE_REL_TOL, f"xlstm decode after {n} tokens "
          f"vs forward of {n + 1}: ||d||/||y|| {rel}")
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "param_bytes": tree_bytes(params),
           "decode_vs_forward": {"prefill": n, "rel_l2": rel,
                                 "tol": PREFILL_DECODE_REL_TOL,
                                 "max_abs": max_abs(a, b)}}
    B, S = sz.xlstm_batch, sz.xlstm_prefill
    batch = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    counts = {}

    def serve():
        lg, cache = T.prefill(params, cfg, tokens=batch)
        tok = lg.argmax(-1)
        for _ in range(sz.xlstm_steps):
            lg, cache = T.decode_step(params, cfg, tok, cache)
            tok = lg.argmax(-1)
    _, secs = counted(serve, counts)
    check(not any(counts.values()), f"xlstm launched {counts}")
    out.update({"batch": B, "prefill_tokens": S, "decode_steps":
                sz.xlstm_steps, "prefill_and_decode_s": secs})
    sync(dev)
    t0 = time.perf_counter()
    lg, cache = T.prefill(params, cfg, tokens=batch)
    sync(dev)
    out["prefill_s"] = time.perf_counter() - t0
    tok = lg.argmax(-1)
    out["decode_step_call_ms"] = call_ms(
        lambda: T.decode_step(params, cfg, tok, cache), dev, 5)
    del params, cache
    return out


def families_llava(sz: Sizes, dev, rng, acc: dict) -> dict:
    """llava-next-34b at full width, ``llava_layers`` of its 60 layers in
    bf16: prefill from ``embeds = embed[tokens]`` equals prefill from
    ``tokens`` bit for bit; then a prefill from ``llava_tokens`` visual
    embeddings (counted), timed."""
    import torch
    from repro_torch.models import transformer as T
    base = family_config("llava-next-34b", sz)
    cfg = base.scaled(n_layers=min(sz.llava_layers, base.n_layers))
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, generator=g, device=dev)
    sync(dev)
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "of_layers": base.n_layers, "d_model": cfg.d_model,
           "param_bytes": tree_bytes(params),
           "init_s": time.perf_counter() - t0}
    S = sz.llava_tokens
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)), device=dev)
    a, ca = T.prefill(params, cfg, tokens=toks)
    b, cb = T.prefill(params, cfg, embeds=params["embed"][toks])
    check(same_raw_bits(a, b) and same_raw_bits(ca["k"], cb["k"]),
          "llava prefill from embed[tokens] != prefill from tokens")
    del ca, cb
    out["embeds_equal_tokens"] = {"tokens": S, "bitwise": True}
    vis = (torch.randn(1, S, cfg.d_model, generator=g, device=dev)
           * 0.02).to(torch.bfloat16)
    counts = {}
    (lg, _), secs = counted(lambda: T.prefill(params, cfg, embeds=vis),
                            counts)
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v
    check(bool(torch.isfinite(lg).all()), "llava logits not finite")
    check(counts["flash_attention"] == cfg.n_layers or dev.type != "cuda",
          f"llava flash launches {counts['flash_attention']}")
    out.update({"visual_tokens": S, "launches": counts, "prefill_s": secs,
                "prefill_call_ms": call_ms(
                    lambda: T.prefill(params, cfg, embeds=vis), dev, 2),
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None})
    del params, lg
    return out


def phase_families(sz: Sizes, dev):
    """hymba-1.5b served, whisper-base, xlstm-350m and llava-next-34b's
    ``embeds`` path, each freed before the next.  Returns (record,
    launches): the counted drives' launches summed, the families path."""
    import torch
    rng = np.random.default_rng(9)
    t0 = time.perf_counter()
    out, acc = {"phase": "families"}, {}
    for name, part in (("hymba", families_hymba),
                       ("whisper", families_whisper),
                       ("xlstm", families_xlstm), ("llava", families_llava)):
        t1 = time.perf_counter()
        out[name] = part(sz, dev, rng, acc)
        out[name]["seconds"] = time.perf_counter() - t1
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    from repro_torch.kernels import ops as kops
    launches = {k: acc.get(k, 0) for k in kops.kernel_wrappers()}
    out["launches"] = launches
    return out, launches


def families_child(device: str, smoke: bool) -> int:
    """``chip_smoke.py --families DEVICE [smoke]``: :func:`phase_families`
    in this process (the kernels built already), its record and launches
    printed as one ``FAMILIES_RESULT`` JSON line."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.kernels import _build
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.build_all()          # loads the parent's build
        dev = torch.device("cuda", torch.cuda.current_device())
    sz = Sizes(families_smoke=True, **FAMILIES_SMOKE) if smoke else Sizes()
    res, launches = phase_families(sz, dev)
    print("FAMILIES_RESULT " + json.dumps({"record": res,
                                           "launches": launches}),
          flush=True)
    return 0


def families_in_child(sz: Sizes, dev):
    """(record, launches) of the ``families`` phase, run by
    :func:`families_child` in a process of its own (its models, CUDA graphs
    and profiler windows leave this process as they found it); fails if
    the child does."""
    cmd = [sys.executable, os.path.abspath(__file__), "--families",
           dev.type] + (["smoke"] if sz.families_smoke else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("FAMILIES_RESULT ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"the families phase's child exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    out = json.loads(lines[0][len("FAMILIES_RESULT "):])
    return out["record"], out["launches"]


# ----------------------------------------------------------------- tuning
# a tuned kind's candidate (the name up to its ':') -> the kernel it runs
TUNED_KERNELS = {("pack", "row"): "pack", ("pack", "block"): "pack_blocked",
                 ("segred", "row"): "segment_reduce_sorted",
                 ("segred", "block"): "segment_reduce_blocked",
                 ("localbcast", "fused"): "bcast_fused",
                 ("localbcast", "generic"): "bcast_fused"}
TUNED_NAMES = set(TUNED_KERNELS.values())
# every sweep of this process, tagged with the path that made it
TUNING = {"path": "setup", "records": []}


@contextlib.contextmanager
def fixed_rule():
    """Within the block the tuned entry points take the fixed rule
    (``REPRO_SF_AUTOTUNE=0``) on every signature: the winners are set
    aside and put back after it."""
    from repro_torch.kernels import ops as kops, tuning
    saved = dict(tuning._WINNERS), dict(kops._DISPATCH)
    mode = os.environ.get("REPRO_SF_AUTOTUNE")
    os.environ["REPRO_SF_AUTOTUNE"] = "0"
    tuning._WINNERS.clear()
    kops._DISPATCH.clear()
    try:
        yield
    finally:
        if mode is None:
            os.environ.pop("REPRO_SF_AUTOTUNE")
        else:
            os.environ["REPRO_SF_AUTOTUNE"] = mode
        for live, kept in zip((tuning._WINNERS, kops._DISPATCH), saved):
            live.clear()
            live.update(kept)


def winner_kernel(kind: str, name: str) -> str:
    return TUNED_KERNELS[(kind, name.split(":")[0])]


def plan_kernels(key) -> set:
    """The kernels the tuner's winners name for the signatures scoped by
    the plan key ``key`` (a plan's ``comm_signature()``)."""
    from repro_torch.kernels import tuning
    return {winner_kernel(k[0], w) for k, w in tuning.winners().items()
            if k[-1] == key}


def tuning_shape(full_key) -> dict:
    """A swept signature's shapes by name."""
    kind = full_key[0]
    if kind == "pack":
        names = ("rows", "gathered", "unit", "dtype")
    elif kind == "segred":
        names = ("rows", "segments", "lmax", "unit", "dtype", "op")
    else:
        names = ("roots", "leaves", "root_dtype", "leaf_dtype")
    out = dict(zip(names, full_key[1:]))
    for k in ("unit", "roots", "leaves"):
        if k in out:
            out[k] = list(out[k])
    plan = full_key[-1]
    out["plan"] = None if plan is None else str(plan[0])
    return out


def on_sweep(full_key, candidates, args, times, default, winner) -> None:
    """``tuning.on_sweep``: every candidate of the swept signature bitwise
    against the plain version on the call's own inputs (NaN payloads
    included), then one record in ``TUNING``.  The tuner puts the launch
    counters back after the sweep, so these launches count on no path.
    (The plain fold takes a few launches a row of the longest segment;
    the paths' swept segments have at most a few dozen rows.)"""
    from repro_torch.kernels import _index, sf_pack, sf_unpack
    kind = full_key[0]
    if kind == "pack":
        data, idx = args
        want = sf_pack.pack_plain(
            data, _index.device_index(idx, data.device, "idx")[0])
    elif kind == "segred":
        vals, first, length = args
        st, ln, _, lmax = _index.segment_meta(first, length, vals.device)
        want = sf_unpack.segment_reduce_plain(vals, st, ln, full_key[6],
                                              lmax)
    else:
        root, leaf, src = args
        want = sf_pack.bcast_fused_plain(
            root, leaf, _index.device_index(src, leaf.device,
                                            "src_of_leaf")[0])
    shape = tuning_shape(full_key)
    for name, fn in candidates.items():
        check(same_raw_bits(fn(*args), want), f"tuning {kind} {shape}: "
              f"candidate {name} != the plain version")
    TUNING["records"].append({
        "path": TUNING["path"], "kind": kind, **shape,
        "candidates_ms": times, "default": default,
        "default_ms": times[default], "winner": winner,
        "winner_ms": times[winner],
        "winner_speedup": times[default] / times[winner],
        "winner_kernel": winner_kernel(kind, winner),
        "checked_against": "plain", "candidates_checked": len(candidates)})


def tuning_warm(objs, dev) -> None:
    """The sf_ops and spmv_cg paths' SF calls once each, on the setup
    objects through the user entry points, so that their signatures sweep
    here (the paths' own calls then take the winners)."""
    import torch
    from repro_torch.core import SFComm
    from repro_torch.kernels import ops as kops
    g = torch.Generator(device=dev).manual_seed(12)

    def rand(rows, unit=()):
        return torch.randn((rows,) + unit, generator=g, device=dev)
    TUNING["path"] = "sf_ops"
    sf = objs["gen"]
    cu = SFComm(sf, backend="cuda", device=dev, plan=objs["gen_plan"])
    for unit in [(), (3,)]:
        root, leaf = rand(sf.nroots_total, unit), rand(sf.nleafspace_total,
                                                       unit)
        cu.bcast(root, leaf, "sum")
        for op in ("sum", "max", "replace"):
            cu.reduce(leaf, root, op)
        cu.scatter(cu.gather(leaf), leaf)
    cu.fetch_and_op(rand(sf.nroots_total).to(torch.int32),
                    rand(sf.nleafspace_total).to(torch.int32))
    for name, unit in (("local", (3,)), ("box", ()), ("box", (3,)),
                       ("wide", (kops.WIDE_ROW,))):
        sfo = objs[name]
        comm = SFComm(sfo, backend="cuda", device=dev)
        root = rand(sfo.nroots_total, unit)
        leaf = rand(sfo.nleafspace_total, unit)
        comm.bcast(root, leaf)
        if name == "local":
            comm.bcast(root, leaf.to(torch.bfloat16))
        else:
            comm.reduce(leaf, root, "sum")
    TUNING["path"] = "spmv_cg"
    A = objs["A"]
    x = rand(objs["coo"][0])
    A.spmv(x, use_kernel=True)
    A.spmv_transpose(x)
    sync(dev)


def tuning_record(dist_tuning: list) -> dict:
    """The ``tuning`` line: every sweep of the SF paths (this process's and
    the dist child's), each candidate's best-round device ms, the
    default's, the winner and its speed-up over the default."""
    from repro_torch.kernels import tuning
    recs = dist_tuning + TUNING["records"]
    return {"phase": "tuning", "sweeps": len(recs),
            "winners_not_default": sum(r["winner"] != r["default"]
                                       for r in recs),
            "by_path": {p: sum(r["path"] == p for r in recs)
                        for p in dict.fromkeys(r["path"] for r in recs)},
            "stats": tuning.stats(), "records": recs}


# ------------------------------------------------------------------- main
def run(dev, sz: Sizes) -> list:
    """All phases on ``dev``; returns the kernel records."""
    import torch
    from repro_torch.kernels import ops as kops
    on_card = dev.type == "cuda"
    # the distributed backend in a child process of its own (a rank's
    # process; phase_dist zeroes the counters before its drive): run late
    # in this process, after the other paths' windows, its torch.profiler
    # windows came back without all their device events
    dist_res, dist_launches, dist_tuning = dist_in_child(sz, dev)
    emit(dist_res)

    rng = np.random.default_rng(0)
    objs = phase_setup(sz, dev, rng)
    emit(objs["setup"])

    # the tuner: every sweep from here on is checked and recorded
    # (on_sweep), the sf_ops and spmv_cg signatures sweep now; the line
    # comes after the SF paths, with their sweeps and the dist child's
    from repro_torch.kernels import tuning
    tuning.on_sweep = on_sweep
    t0 = time.perf_counter()
    tuning_warm(objs, dev)
    tuning_warm_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    TUNING["path"] = "kernels"
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
    kops.reset_launch_counts()
    TUNING["path"] = "sf_ops"
    sf_ops = phase_sf_ops(objs, dev)
    emit(sf_ops)
    TUNING["path"] = "spmv_cg"
    emit(phase_spmv_cg(objs, sz, dev))
    by_path = {"sf": kops.launch_counts(),
               "fixed_rule": sf_ops.pop("fixed_rule_launches")}
    missing = missing_kernels(SF_PATH, by_path["sf"])
    check(not missing or not on_card, f"SF path never launched {missing}")
    del objs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the structured-grid path: counters from 0 again
    kops.reset_launch_counts()
    TUNING["path"] = "dmda"
    emit(phase_dmda(sz, dev))
    by_path["dmda"] = kops.launch_counts()
    missing = missing_kernels(DMDA_PATH, by_path["dmda"])
    check(not missing or not on_card, f"DMDA path never launched {missing}")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the composed-SF paths (multigrid, assembly, mesh distribution): the
    # counters from 0 before each
    for name, phase, needed in (("mg", phase_mg, MG_PATH),
                                ("assembly", phase_assembly, ASSEMBLY_PATH),
                                ("plex", phase_plex, PLEX_PATH)):
        kops.reset_launch_counts()
        TUNING["path"] = name
        res = phase(sz, dev)
        emit(res)
        by_path[name] = kops.launch_counts()
        if name == "assembly":
            recs["segment_reduce_blocked"]["fetch_fold_shape"] = \
                res["fetch_fold"]
        missing = missing_kernels(needed, by_path[name])
        check(not missing or not on_card,
              f"the {name} path never launched {missing}")
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    by_path["dist"] = dist_launches
    emit({**tuning_record(dist_tuning), "warm_s": tuning_warm_s})

    # the serving path: phase_serve zeroes the counters before its drive
    TUNING["path"] = "serve"
    serve = phase_serve(sz, dev)
    emit(serve)
    by_path["serve"] = serve["launches"]
    missing = missing_kernels(SERVE_PATH, by_path["serve"])
    check(not missing or not on_card, f"serving never launched {missing}")
    del serve
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the MoE path: qwen3-4b is freed; moe_serve zeroes the counters
    # before its drive
    TUNING["path"] = "moe"
    moe = phase_moe(sz, dev)
    emit(moe)
    by_path["moe"] = moe["launches"]
    missing = missing_kernels(MOE_PATH, by_path["moe"])
    check(not missing or not on_card, f"MoE serving never launched "
          f"{missing}")
    for part in ("layer", "wide_layer", "serve"):
        for gr in moe[part]["gathers"]:
            recs[gr["kernel"]].setdefault("moe_shapes", []).append(gr)
    del moe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the families path (hymba served, whisper, xlstm, llava's embeds) in
    # a child process: its counted drives' launches are the path's
    fam, by_path["families"] = families_in_child(sz, dev)
    emit(fam)
    missing = missing_kernels(FAMILIES_PATH, by_path["families"])
    check(not missing or not on_card, f"the families path never launched "
          f"{missing}")
    recs["flash_attention"]["family_shapes"] = \
        fam["hymba"]["flash"] + fam["whisper"]["flash"]
    del fam

    # the long segment reduce's sweep comes after the last profiled window:
    # its plain folds launch ~4 M small kernels, and after them torch.profiler
    # on the card returns windows without all their device events
    t0 = time.perf_counter()
    emit({"phase": "long_sweep",
          "cases": long_sweep(dev, np.random.default_rng(7)),
          "seconds": time.perf_counter() - t0})
    for name, rec in recs.items():
        rec["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        check(rec["launches"] or not on_card, f"{name} launched on no path")
    return [recs[k] for k in REPLACES]


def main() -> int:
    if sys.argv[1:2] == ["--out-of-range"]:
        return out_of_range_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--dist"]:
        return dist_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    if sys.argv[1:2] == ["--families"]:
        return families_child(sys.argv[2], sys.argv[3:4] == ["smoke"])
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
                                                  "gather_rows_kernel"))],
          "sf_pack_wide_ptxas": [
              r for r in _build.ptxas_report("sf_pack")
              if "wide_gather" in r["function"]],
          "sf_unpack_long_ptxas": [
              r for r in _build.ptxas_report("sf_unpack")
              if "long_" in r["function"]]})
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
