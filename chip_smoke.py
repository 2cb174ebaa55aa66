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
           causal) and over a sweep (float32 / bf16, head sizes 16, 32,
           64, 112 and 128, GQA 1/4/8, windows, Sq < Skv, Sq > Skv with
           fully masked rows exactly 0, ragged tails, a batch; for the wgmma kernel's ring also S = 4096
           with a window of 1000, Skv off the tile, Sq = 1 against 2048 keys
           (the split-KV route: at most ``SPLIT_ROWS`` query rows a KV head)
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
  priors   measured backend selection (``core/priors.py``): the
           reference's ping-pong (2 ranks, n contiguous leaves, one bcast
           + one reduce of float32, 1 KiB to 64 MiB in steps of 4x) and
           halo sweep (periodic 2D star DMDAs over 4 ranks, interior
           "skip", grids 8^2-64^2 and 1024^2, units 1-16, one bcast) on
           ``"global"`` and ``"cuda"``, us per call (the best of
           ``PRIORS_TRIALS`` ``call_ms`` means, launches included); at every
           point ``select_backend(priors=)`` with that point's (or grid's)
           table must pick the argmin.  Both sweeps are then written,
           stamped with ``priors.current_env()``, into a temporary
           directory and loaded through ``REPRO_SF_PRIORS`` /
           ``default_priors()``: copies stamped with another device count
           or card are refused, ``SFComm`` with no backend takes the
           table's choice on each side of a crossover (or at the smallest
           and largest sizes), bitwise both fixed backends, and a CPU
           ``SFComm`` keeps ``"global"``.  The variable and the memo are
           put back after, and ``default_priors()`` must be None again:
           every other phase runs with ``REPRO_SF_PRIORS=0``, the static
           rule its launch checks are written for, whatever artifacts the
           checkout holds.  The line has both curves,
           the crossovers, every choice, the kernels launched and the
           phase's seconds beside ``nvidia-smi``.
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
           ``torch.cuda.set_sync_debug_mode("error")``; (c) phi3.5-moe at
           full width, 8 of its 32 layers in bf16: one engine stream at
           batch 1 against direct greedy decoding (float32, 2 layers), then
           the serve phase's trace through ``ServeEngine(batch=8,
           s_max=2048)`` + ``loadgen.drive``: metrics, the plan cache's hit
           rate, launches, profiled windows of a prefill and of five
           decode steps with device ms by kernel group; (d) kimi-k2 served
           after phi3.5-moe is freed: at full width (d_model 7,168, 64 / 8
           heads of 112, 384 experts top-8 and the shared expert, vocab
           163,840), 1 of its 61 layers in bf16 (38.9 GB): one engine
           stream at batch 1 against direct greedy decoding on a narrow
           kimi config that keeps its heads of 112 (float32, 2 layers),
           its layer 0's MoE kernels against plain gathers bitwise at
           decode and prefill (the 384-way fan), row 8 at each prefill
           bucket of the trace and at 1,024 tokens (bf16 q (S, 64, 112)
           over 8 KV heads, causal, the 2,048-key window the path passes:
           the wgmma kernel on its 128-wide tiles against the plain
           version, bitwise repeats, the LSE, device ms in turns with the
           mma.sync kernel at 112, SDPA, cold L2 at 1,024), then the serve
           phase's trace through ``ServeEngine(batch=8, s_max=2048)``,
           every flash launch on the wgmma route and at a checked shape,
           and profiled windows as (c)'s.  Each part records the device
           memory that earlier ones leave allocated.
           Every gather of (b)-(d) is timed on its own inputs beside
           ``index_select`` and its bound, ``pack``'s also beside its first
           kernel (``prev_ms``) and each chunk size (``moe_shapes`` of the
           ``pack`` / ``pack_blocked`` rows), and both dispatch lowerings
           at phi3.5-moe's serving shapes (``fuse_switch``).  The drives of
           (c) and (d) are the moe path.

  families (in a child process: ``chip_smoke.py --families DEVICE``, which
           prints one ``FAMILIES_RESULT`` JSON line) the model families of
           the twelfth slice, bf16, random weights from seeded generators,
           each freed before the next: hymba-1.5b at its published width
           and depth (32 layers) through ``ServeEngine(batch=8,
           s_max=4096)`` + ``loadgen.drive`` on 8 requests (prompts
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
           Row 8 at hymba's and whisper's shapes (encoder, cross-attention
           at its 4-token prefill and at decode, the decoder's prefill
           self-attention) and at a GQA decode step
           (Sq = 1, 32 / 8 heads of 128, 4,096 keys), each on the route the
           rule gives it (the split-KV kernels for short queries, the wgmma
           kernel's head-size-64 tiles for the others): against the plain
           version (the split route also against its plain split-and-
           combine version) within FLASH_TOL, two calls bitwise, o bitwise
           with and without the LSE and the LSE within FLASH_LSE_ATOL,
           device ms in turns with the kernel the route replaces
           (``prev_ms``: the parent's head-size-64 wgmma build, 64-key
           tiles and 2 slots, made by ``flash_variants.variant_source``
           and built by nvcc in the background from the env phase on; the
           wgmma kernel at 128), the wgmma kernel now on the split shapes
           (``sm90_ms``), beside SDPA (``family_shapes`` on the kernels
           line; the decode shape is the ``flash_attention_split`` row).
           Whisper's drive must take the split route at every call the
           rule sends there (``launch_counts()["flash_attention_split"]``).
           The counted drives
           (hymba's engine, whisper's prefill and decode, xlstm's,
           llava's prefill) are the families path.
  train    (in a child process: ``chip_smoke.py --train DEVICE``, which
           prints one ``TRAIN_RESULT`` JSON line; the card's memory to
           itself) the training path, bf16, random weights from seeded
           generators, each part freed before the next: row 8's
           backward kernels (``flash_attention_bwd.cu``) at qwen3-4b's
           heads (q (1024, 32, 128), causal), hymba's (25 / 5 heads of
           64, window 2,048, S = 3,000) and kimi-k2's (64 / 8 heads of
           112, causal: the mma.sync route), then at whisper's cross shape:
           the Function's gradients against ``flash_attention_backward_
           plain`` and autograd through the plain version within
           FLASH_BWD_REL, float32 within FLASH_BWD_F32_REL, two calls
           bitwise, the forward's o bitwise with and without its saved
           log-sum-exp and that LSE within FLASH_LSE_ATOL of the plain
           version's, the kernels' device ms in turns with the mma.sync
           route's kernels on the same bf16 inputs (``prev_ms``), cold
           L2, the bound, SDPA's forward + backward, SDPA's backward
           kernels alone and the Function's call ms
           (``flash_bwd_record``);
           every drive after them runs with ``flash_attention_plain``
           raising on CUDA tensors and each ``FlashAttention.backward``
           call held to one launch of the kernels
           (``attention_backward_audit``; the launch phase too);
           qwen3-4b at full width and depth (36 layers,
           4.41 B parameters, float32 moments, remat per block), 4 steps of
           ``make_train_step`` (the launcher's path, updated in place) on
           ``SyntheticLM`` batches of 4 x 1,024 — step ms on the host and
           between CUDA events, tokens/s, peak memory, a profiled step by
           kernel group — then 6 steps on one batch at lr 1e-4, whose loss
           must fall; the DDP step over the allreduce SF (qwen3-4b at full
           width, 4 of 36 layers, 4 grains, 25 MiB buckets): worlds 1 and 4
           bitwise, bucketed = per-tensor bitwise, grains = 1 against
           ``make_train_step`` (rtol / atol 1e-6), one bucket's reduce
           (device and call ms, its bound, ``torch.sum(dim=0)``) and the
           segment reduce alone on it, column-tiled against one CTA, both
           bitwise the plain version; phi3.5-moe at full width: one layer's
           gradients in float32 through the SF dispatch against the dense
           one (MOE_GRAD_RTOL / ATOL), the 2-layer model's in bf16 (per leaf
           within MOE_BF16_GRAD_REL), the DynPlan transpose bitwise across
           two runs, and 3 training steps.  The counted drives (the dense
           steps, the world-4 DDP step, the MoE steps) are the train path.
  launch   (in a child process: ``chip_smoke.py --launch DEVICE``, which
           prints one ``LAUNCH_RESULT`` JSON line) the launch tooling on a
           device mesh, over an NCCL group of one rank (``file://`` store):
           qwen3-4b at full size (36 layers, bf16, float32 moments, remat
           per block) through the launcher's sharded path
           (``launch.train.sharded_state``: each leaf made whole from seed
           0 and placed as a DTensor by ``param_specs`` / ``shardings`` on a
           (1, 1) mesh; ``make_train_step(param_shardings=)``), 4 counted
           steps of 4 x 1,024 tokens (``make_batch``, the launcher's
           stream): step ms, tokens/s, peak, a profiled step's idle share;
           at 4 of 36 layers one step through the mesh bitwise
           ``make_train_step`` without a mesh (loss, every parameter and
           moment), both timed in turns (the DTensor layer's cost), the
           mesh step's ``max_memory_allocated`` and FlopCounterMode's count
           of both; the dry run of that 4-layer cell under a fake group of
           one rank (``--launch-dryrun DEVICE``, a child of its own): FLOPs
           equal to the card's count, peak within ``LAUNCH_PEAK_REL`` of
           the card's, the roofline row from ``HW`` beside the measured
           step; the production 16 x 16 mesh's dry run of qwen3-4b and
           mistral-large-123b x {train_4k, prefill_32k, decode_32k}
           (``python -m repro_torch.launch.dryrun``, records under
           ``reports/torch_dryrun``): per cell the seconds, peak GiB
           a device, ``fits80G``, the collective counts.  The counted
           drives (the full steps, the 4-layer mesh steps) are the launch
           path.
  long_sweep  the long segment reduce (segments over ``LONG_SEG`` rows)
           of both wrappers bitwise, NaN payloads included, against the
           plain version: every dtype and op at units (), (3,) and (2, 2),
           256- and 300-element rows, segments at the cut and the chunk
           edges beside short, empty, overlapping and unsorted ones
           (``long_case``).  Last, because its plain folds' ~4 M small
           launches leave torch.profiler on the card returning windows
           without all their device events.

Twelve paths carry the kernels: ``sf_ops`` + ``spmv_cg`` (the SF kernels),
``fixed_rule`` (the fixed rule's wide gather and one-segment-a-CTA
reduce, which the tuned paths launch only where a sweep picks them),
``dmda`` (a gather, a segment reduce, ``spmv_ell``), ``mg`` (the same),
``assembly`` (a gather, a segment reduce), ``plex`` (a gather), ``dist``
(a gather, a segment reduce), the serve phase's drive
(``flash_attention``), the moe phase's drive (``pack``, ``pack_blocked``,
``flash_attention``), the families phase's drives
(``flash_attention``), the train phase's (``flash_attention`` and
``flash_attention_backward``, a gather, a segment reduce;
``pack_strided`` in the DDP buckets) and the launch phase's
(``flash_attention`` and ``flash_attention_backward`` on each rank's
shards under ``local_map``, the token lookup's gather and its
transpose's segment reduce).  The priors phase's sweeps are counted the
same way (path ``priors``): what they launch is recorded, not required
(``pack_blocked`` for the halo packs and ``pack_strided`` for the
ping-pong's contiguous leaves on ``"cuda"``, as the tuner's winners and
the plan name them).
A gather is ``pack`` or ``pack_blocked`` and a
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
    # row 8's short-query route: split KV and the combine
    "flash_attention_split": "src/repro/kernels/flash_attention.py:92",
    # no Pallas backward: the reference differentiates _chunked_attn
    "flash_attention_backward": "src/repro/models/layers.py:70",
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
    "flash_attention_split": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_backward":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
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
FAMILIES_PATH = ("flash_attention", "flash_attention_split")
# MoE layer, dispatch="sf" against dispatch="dense", float32: the
# reference's tests/test_models.py:127-159
MOE_RTOL, MOE_ATOL, MOE_AUX_RTOL = 1e-5, 1e-6, 1e-6
# profiled serving windows: a kernel's group is the first whose name holds
# one of its words; the rest are "other"
KERNEL_GROUPS = (
    ("flash_attention", ("flash_fwd", "flash_bwd")),
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
    # priors: the reference's ping-pong (2 ranks, n contiguous leaves, one
    # bcast + one reduce of float32, n = bytes // 8) from 1 KiB to 64 MiB
    # in steps of 4x, and its halo sweep (periodic 2D star DMDAs over 4
    # ranks, interior "skip") on these grids and units; us per call, best
    # of PRIORS_TRIALS means over timing_iters calls
    priors_pingpong: tuple = tuple(1024 * 4 ** k for k in range(9))
    priors_grids: tuple = ((8, 8), (16, 16), (32, 32), (64, 64),
                           (1024, 1024))
    priors_units: tuple = (1, 2, 4, 8, 16)
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
    # moe: phi3.5-moe at full width in bf16, 8 of its 32 layers (about 21 GB
    # of blocks; 32 layers, 84 GB, do not fit in 80 GB), kimi-k2 at full
    # width in bf16, kimi_layers of its 61 (38.9 GB of weights at 1; 2
    # layers, 73 GB, leave too little beside the capacity-padded expert
    # buffers), and DynPlan at dispatch scale (moe_smoke=True: the smoke
    # configs, kimi-k2's at its head size 112, for rehearsals on the CPU)
    moe_arch: str = "phi3.5-moe-42b-a6.6b"
    moe_wide_arch: str = "kimi-k2-1t-a32b"
    moe_smoke: bool = False
    moe_layers: int = 8
    kimi_layers: int = 1
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
    hymba_requests: int = 8
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
    gqa_decode_keys: int = 4096       # row 8's GQA short-query shape
    xlstm_batch: int = 8
    xlstm_prefill: int = 512
    xlstm_steps: int = 32
    xlstm_check: int = 300            # not a multiple of 128
    llava_layers: int = 16            # 19.6 GB of 60 layers' 68.8
    llava_tokens: int = 2880          # LLaVA-NeXT anyres: 5 x 576
    # train: qwen3-4b at full width and depth (4.41 B parameters), bf16,
    # float32 moments; the DDP step at full width, ddp_layers of 36; the
    # flash backward at qwen3-4b's and hymba's heads; phi3.5-moe at full
    # width, moe_train_layers of 32 (train_smoke=True: the smoke configs,
    # for rehearsals on the CPU)
    train_smoke: bool = False
    train_arch: str = "qwen3-4b"
    train_batch: int = 4
    train_seq: int = 1024
    train_steps: int = 4
    train_fixed_steps: int = 6
    ddp_layers: int = 4               # 1.18 B parameters
    ddp_grains: int = 4
    ddp_budget: int = 25 << 20        # torch DDP's default bucket size
    ddp_batch: int = 4
    ddp_seq: int = 1024
    moe_train_arch: str = "phi3.5-moe-42b-a6.6b"
    moe_train_layers: int = 2         # 2.86 B parameters
    moe_train_batch: int = 4
    moe_train_seq: int = 1024
    moe_train_steps: int = 3
    moe_grad_tokens: tuple = (2, 256)  # the float32 layer's gradient check
    flash_bwd_shapes: tuple = ((1024, 32, 8, 128, None),
                               (3000, 25, 5, 64, 2048),
                               (1024, 64, 8, 112, None))
    # train families: hymba-1.5b at full width and depth on 2 x 3,072
    # tokens (the sliding layers' 2,048-key window masks), xlstm-350m at
    # full size on 4 x 256 (two 128-step chunks: its eager cell loop is
    # launch-bound), whisper-base on 8 x (1,500 frames, 448 tokens); bf16,
    # float32 moments, remat per block.  Steps: (counted, on one batch).
    hymba_train: tuple = (2, 3072)
    hymba_train_steps: tuple = (2, 4)
    xlstm_train: tuple = (4, 256)
    xlstm_train_steps: tuple = (2, 3)
    whisper_train: tuple = (8, 448, 1500)   # batch, tokens, frames
    whisper_train_steps: tuple = (4, 6)
    scan_check: tuple = (2, 600)      # hymba's scan Function, one layer
    xlstm_check_train: tuple = (4, 300)   # one xlstm pair, graphs vs eager
    # launch: qwen3-4b at full size through the launcher's sharded path on a
    # (1, 1) mesh over an NCCL group of one rank (bf16, float32 moments,
    # remat per block), its launch_check_layers-layer step bitwise against
    # make_train_step, the dry run of that cell against the card, and the
    # production mesh's dry run of launch_cells x launch_shapes
    # (launch_smoke=True: the smoke config and a CPU dry run, for
    # rehearsals on the CPU)
    launch_smoke: bool = False
    launch_arch: str = "qwen3-4b"
    launch_batch: int = 4
    launch_seq: int = 1024
    launch_steps: int = 4
    launch_check_layers: int = 4
    # every arch, dealt round-robin among launch_dryrun_jobs children:
    # the six slowest (a train cell 45-80 s of host time) first
    launch_cells: tuple = ("hymba-1.5b", "xlstm-350m", "llava-next-34b",
                           "kimi-k2-1t-a32b", "qwen3-14b", "whisper-base",
                           "mistral-large-123b", "phi3.5-moe-42b-a6.6b",
                           "qwen3-4b", "starcoder2-3b")
    launch_shapes: tuple = ("train_4k", "prefill_32k", "decode_32k",
                            "long_500k")
    launch_dryrun_jobs: int = 6
    # the other families through the same path on the (1, 1) mesh: each
    # one's mesh step bitwise make_train_step at launch_family_check_layers
    # layers (xlstm: one pair), then launch_family_steps counted steps at
    # the train phase's sizes (phi3.5-moe at full width, moe_train_layers
    # of 32 layers; hymba-1.5b, xlstm-350m and whisper-base whole)
    launch_families: tuple = ("phi3.5-moe-42b-a6.6b", "hymba-1.5b",
                              "xlstm-350m", "whisper-base")
    launch_family_check_layers: int = 2
    launch_family_steps: int = 2


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


def cold_graph_ms(fn, dev, iters: int) -> float:
    """``cold_device_ms`` without torch.profiler (whose windows come back
    without device events in the train child): CUDA-graph replays of a
    256 MB read followed by ``fn()``, less those of the read alone, each
    timed twice in turns (the host's time per call on the CPU)."""
    import torch
    if dev.type != "cuda":
        return call_ms(fn, dev, iters)
    scrub = torch.ones(64 << 20, dtype=torch.int32, device=dev)
    flush = lambda: scrub.sum()

    def both():
        flush()
        fn()
    (cold, _), (read, _) = in_turns(both, flush, dev, iters, graph_ms)
    return max(0.0, cold - read)


def bound(nbytes: float, nops: float = 0.0, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's peak rate for their type (by default
    float32 outside the tensor cores)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def flash_ptxas() -> list:
    """Registers, spills and static shared memory of the flash sources'
    kernels (the forward's two and the backward's), from their ``nvcc
    -Xptxas=-v`` build logs, with the dynamic shared memory of each wgmma
    instance."""
    from repro_torch.kernels import _build, flash_attention as fa
    out = []
    for src in ("flash_attention_sm90", "flash_attention",
                "flash_attention_bwd"):
        for r in _build.ptxas_report(src):
            r = dict(r, source=src)
            # the instances are by tile width (head size 112 runs on 128)
            for D, br in fa.SM90_TILES:
                if src == fa.SM90 and f"ILi{D}ELi{br // 64}E" in r["function"]:
                    r.update(D=D, rows=br, dynamic_smem_bytes=fa
                             .sm90_smem_bytes(D, br))
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
    recs["segment_reduce_sorted"].update(short_route(sv, st, ln, 1,
                                                     "vector"))
    recs["segment_reduce_sorted"].update(scalar_in_turns(sv, st, ln, 1, dev,
                                                         it))

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
    recs["segment_reduce_blocked"].update(short_route(
        gsv, gst, gln, kops.SEG_BLOCK, "scalar"))
    recs["segment_reduce_blocked"].update(scalar_in_turns(
        gsv, gst, gln, kops.SEG_BLOCK, dev, it))
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


def short_route(sv, st, ln, segs_per_cta: int, kernel: str) -> dict:
    """The longest segment, route and short-route plan of a main-path
    segment reduce, which must take the short route and there ``kernel``
    (``"vector"`` or ``"scalar"``); the plan's numbers."""
    from repro_torch.kernels import sf_unpack
    from repro_torch.kernels._index import segment_meta
    lmax = segment_meta(st, ln, sv.device)[3]
    route = sf_unpack.reduce_route(lmax, sv.dtype, "sum")
    check(route == "short", f"a main-path segment reduce (Lmax {lmax}) "
          f"took the {route} route")
    plan = short_plan_of(sv, st, segs_per_cta)
    check(plan["route"] == kernel, f"a main-path segment reduce took the "
          f"{plan['route']} kernel, not the {kernel} one")
    return {"lmax": lmax, "route": route, "long_seg": sf_unpack.LONG_SEG,
            "short_plan": plan}


def short_plan_of(buf, st, segs_per_cta: int) -> dict:
    """The numbers of ``sf_unpack.short_plan`` for a reduce of ``buf`` into
    ``st.numel()`` segments (the output 16-byte aligned, as torch allocates
    it)."""
    from repro_torch.kernels import sf_unpack
    plan = sf_unpack.short_plan(
        st.numel(), max(1, math.prod(buf.shape[1:])), buf.element_size(),
        rows=buf.shape[0], buf_ptr=buf.data_ptr(), out_ptr=0,
        segs_per_cta=segs_per_cta, sms=sf_unpack._device_sms(buf))
    return {k: v for k, v in dataclasses.asdict(plan).items()
            if k not in ("S", "U", "elem", "buf_mod", "out_mod")}


def scalar_in_turns(buf, st, ln, segs_per_cta: int, dev, it: int,
                    graph: bool = False) -> dict:
    """A segment reduce (``segment_reduce_sorted`` at one segment a CTA,
    ``segment_reduce_blocked`` otherwise) against the scalar kernel on the
    same inputs (``short_variant(route="scalar")``: the short route before
    the vector kernel, column tiles and all), each bitwise the plain fold,
    timed in turns by torch.profiler (``graph``: CUDA events around graph
    replays), the scalar kernel also with L2 scrubbed."""
    from repro_torch.kernels import sf_unpack
    run = (lambda: sf_unpack.segment_reduce_sorted(buf, st, ln)) \
        if segs_per_cta == 1 else (lambda: sf_unpack.segment_reduce_blocked(
            buf, st, ln, segs_per_block=segs_per_cta))
    prev = lambda: sf_unpack.short_variant(
        buf, st, ln, segs_per_block=segs_per_cta, route="scalar")
    want = sf_unpack.segment_reduce_plain(buf, st, ln, "sum")
    check(same_raw_bits(run(), want) and same_raw_bits(prev(), want),
          "a segment reduce or its scalar kernel differs from plain")
    timer, cold = (graph_ms, cold_graph_ms) if graph else \
        (device_ms, cold_device_ms)
    (ms, ms_runs), (prev_ms, prev_runs) = in_turns(run, prev, dev, it, timer)
    return {"ms_in_turns": ms, "ms_runs": ms_runs, "prev_ms": prev_ms,
            "prev_ms_runs": prev_runs,
            "prev_ms_cold_l2": cold(prev, dev, it),
            "prev_source": "segment_reduce_kernel (the scalar kernel; "
                           "short_variant(route=\"scalar\"))",
            "bitwise_plain_and_scalar": True}


def segred_record(what: str, buf, st, ln, dev, it: int, library,
                  library_name: str, lib_tol: float = 5e-2) -> dict:
    """Row 5 (``segment_reduce_sorted``, sum) at one shape: the route and
    short-route plan it takes (segments over ``LONG_SEG`` rows on the long
    route in the same call, as on the path); bitwise the plain fold and the
    scalar kernel; device ms from CUDA-graph replays in turns with the scalar
    kernel's (``prev_ms``), both with L2 scrubbed (``cold_graph_ms``), the
    bound (the rows read once, (start, len), one row a segment written),
    the plain version's and one library call's ms (CUDA events around
    calls; ``library()`` within ``lib_tol`` of the largest plain element:
    a yardstick, not bitwise)."""
    import torch
    from repro_torch.kernels import sf_unpack
    from repro_torch.kernels._index import segment_meta
    lmax = segment_meta(st, ln, dev)[3]
    plain = lambda: sf_unpack.segment_reduce_plain(buf, st, ln, "sum", lmax)
    want = plain()
    lib = library()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = max_abs(lib.to(want.dtype), want)
    check(err <= lib_tol * scale, f"{what}: {library_name} max|d| {err}")
    del lib
    rec = {"what": what, "rows": int(buf.shape[0]),
           "unit": list(buf.shape[1:]), "dtype": str(buf.dtype)[6:],
           "segments": st.numel(), "empty_segments": int((ln == 0).sum()),
           "lmax": lmax, "route": sf_unpack.reduce_route(lmax, buf.dtype,
                                                         "sum"),
           "long_segments": int((ln > sf_unpack.LONG_SEG).sum()),
           "short_plan": short_plan_of(buf, st, 1),
           **scalar_in_turns(buf, st, ln, 1, dev, it, graph=True),
           "ms_by": "CUDA events (graph), in turns with prev_ms"}
    run = lambda: sf_unpack.segment_reduce_sorted(buf, st, ln)
    rb = buf[:1].numel() * buf.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(
        int(ln.sum()) * rb + st.numel() * (8 + rb))
    rec["ms"] = rec.pop("ms_in_turns")
    rec["ms_cold_l2"] = cold_graph_ms(run, dev, it)
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["plain_ms"] = call_ms(plain, dev, 2)
    rec["library"], rec["library_max_abs"] = library_name, err
    rec["library_ms"] = call_ms(library, dev, it)
    rec["library_ms_by"] = rec["plain_ms_by"] = "CUDA events around calls"
    return rec


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


def in_turns(run, prev, dev, it: int, timer=None):
    """(min, runs) of ``run`` and of ``prev``, each timed twice in turns:
    run, prev, prev, run (``timer``: ``device_ms`` by default)."""
    timer = timer or device_ms
    ms = [timer(run, dev, it)]
    prev_ms = [timer(prev, dev, it), timer(prev, dev, it)]
    ms.append(timer(run, dev, it))
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
    S = q.shape[0]
    kv_tile = fa.sm90_bc(q.shape[-1], fa.tile_height(1, S, q.shape[-2]))
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
    be exactly 0), ragged tails and a batched call, at head sizes 16, 32,
    64, 112 and 128, then the ring-stress shapes of the wgmma kernel in
    bf16 at head sizes 64, 112 and 128.  Each case
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
        before = (fa.flash_attention.launches_sm90,
                  fa.flash_attention.launches_split)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        took = "plain" if dev.type != "cuda" else fa.SM90 \
            if fa.flash_attention.launches_sm90 > before[0] else fa.SPLIT \
            if fa.flash_attention.launches_split > before[1] \
            else "flash_attention"
        check(took == fa.call_route(q, k) or dev.type != "cuda",
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
        for D in fa.HEAD_DIMS:
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
    rec = {"S": S, "route": fa.call_route(q, k),
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


# ------------------------------------------------------------------ priors
PRIORS_BACKENDS = ("global", "cuda")
PRIORS_TRIALS = 1           # a priors point is the best of this many means


def pingpong_sf(n: int):
    """The reference's ping-pong SF (``benchmarks/bench_pingpong.py``
    ``_pingpong_sf``): rank 0 owns ``n`` roots, rank 1 holds ``n``
    contiguous leaves, one a root."""
    from repro_torch.core import StarForest
    sf = StarForest(2)
    sf.set_graph(0, n, None, np.zeros((0, 2), np.int64), nleafspace=1)
    sf.set_graph(1, 0, None,
                 np.stack([np.zeros(n, np.int64),
                           np.arange(n, dtype=np.int64)], 1),
                 nleafspace=n)
    return sf.setup()


def argmin_backend(times: dict) -> str:
    """The fastest backend, ties broken as ``PriorsTable.best_backend``
    breaks them (by name)."""
    return min((us, bk) for bk, us in times.items())[1]


def crossovers(curves: dict) -> list:
    """Where the ping-pong's fastest backend changes between adjacent
    sizes: the bracket, the winners on each side, and the byte size at
    which the two curves, interpolated in log2 bytes as the table
    interpolates them, cross."""
    sizes = sorted(int(b) for b in curves["global"])
    out = []
    for lo, hi in zip(sizes, sizes[1:]):
        d0 = curves["global"][str(lo)] - curves["cuda"][str(lo)]
        d1 = curves["global"][str(hi)] - curves["cuda"][str(hi)]
        below = argmin_backend({bk: c[str(lo)] for bk, c in curves.items()})
        above = argmin_backend({bk: c[str(hi)] for bk, c in curves.items()})
        if below == above:
            continue
        x0, x1 = math.log2(lo), math.log2(hi)
        x = x0 + (x1 - x0) * d0 / (d0 - d1) if d0 != d1 else x0
        out.append({"between_bytes": [lo, hi], "below": below,
                    "above": above, "crossover_bytes": 2.0 ** x})
    return out


def priors_pingpong(sz: Sizes, dev) -> tuple:
    """The ping-pong sweep on both backends: (curves, choices, the SFs by
    size).  At every size ``select_backend`` with that size's own table
    must pick the argmin of the two times."""
    import torch
    from repro_torch.core import SFComm, select_backend
    from repro_torch.core.priors import PriorsTable
    curves = {bk: {} for bk in PRIORS_BACKENDS}
    choices, sfs = {}, {}
    for nbytes in sz.priors_pingpong:
        n = nbytes // 8            # float32 x 2 (send + bounce payload)
        sf = sfs[nbytes] = pingpong_sf(n)
        root = torch.arange(n, dtype=torch.float32, device=dev)
        leaf = torch.zeros(sf.nleafspace_total, dtype=torch.float32,
                           device=dev)
        zeros = torch.zeros_like(root)
        table = PriorsTable()
        for bk in PRIORS_BACKENDS:
            comm = SFComm(sf, backend=bk, device=dev)

            def call(comm=comm):
                return comm.reduce(comm.bcast(root, leaf, "replace"), zeros,
                                   "sum")
            us = min(call_ms(call, dev, sz.timing_iters)
                     for _ in range(PRIORS_TRIALS)) * 1e3
            curves[bk][str(nbytes)] = us
            table.record(bk, nbytes, us)
            del comm
        choice = select_backend(sf, device=dev, priors=table)
        want = argmin_backend({bk: c[str(nbytes)]
                               for bk, c in curves.items()})
        check(choice == want, f"priors: ping-pong {nbytes} B chose "
              f"{choice!r}, the argmin is {want!r}")
        choices[str(nbytes)] = choice
        del root, leaf, zeros
    return curves, choices, sfs


def priors_halo(sz: Sizes, dev) -> dict:
    """The reference's halo sweep on both backends: one bcast of ``(n, u)``
    per grid and unit, in its artifact schema.  Each grid's own table
    (distinct byte sizes per unit, so the lookup is exact) must send
    ``select_backend`` to the argmin at every unit."""
    import torch
    from repro_torch.core import select_backend
    from repro_torch.core.priors import PriorsTable
    from repro_torch.meshdist import DMDA
    g = torch.Generator(device=dev).manual_seed(27)
    grids = {}
    for grid in sz.priors_grids:
        da = DMDA(grid, 4, stencil="star", width=1, periodic=True,
                  interior="skip")
        n, nl = da.nglobal, da.nlocal_total
        edges = int(da.sf.nedges_total)
        comms = {bk: da.comm(backend=bk, device=dev)
                 for bk in PRIORS_BACKENDS}
        rec = {"grid": list(grid), "halo_edges": edges,
               "backends": {bk: {"unit_us": {}} for bk in PRIORS_BACKENDS}}
        choice_of = {}
        table = PriorsTable()
        for u in sz.priors_units:
            gv = torch.randn((n, u), generator=g, device=dev)
            lv = torch.zeros((nl, u), dtype=torch.float32, device=dev)
            times = {}
            for bk in PRIORS_BACKENDS:
                times[bk] = min(
                    call_ms(lambda c=comms[bk]: c.bcast(gv, lv, "replace"),
                            dev, sz.timing_iters)
                    for _ in range(PRIORS_TRIALS)) * 1e3
                rec["backends"][bk]["unit_us"][str(u)] = times[bk]
                table.record(bk, edges * u * 4, times[bk])
            choice = select_backend(da.sf, device=dev, unit=(u,),
                                    priors=table)
            check(choice == argmin_backend(times), f"priors: halo {grid} "
                  f"unit {u} chose {choice!r} against {times}")
            choice_of[str(u)] = choice
        rec["backends"]["auto"] = {"choice": choice_of}
        grids[f"{grid[0]}x{grid[1]}"] = rec
        del da, comms
    return grids


def priors_auto(dev, sfs: dict) -> dict:
    """The written table through ``default_priors()``: ``SFComm`` with no
    backend at ping-pong sizes on each side of a crossover (or the
    smallest and the largest) takes the table's choice, and its bcast and
    reduce are bitwise both fixed backends'.  A CPU SFComm keeps the
    static rule."""
    import torch
    from repro_torch.core import SFComm, UnitSpec, estimate_message_bytes
    from repro_torch.core import priors
    table = priors.default_priors()
    check(table is not None and len(table.sources) == 2,
          f"priors: default_priors() loaded "
          f"{None if table is None else table.sources}")
    unit = UnitSpec((), torch.float32)
    pick = {nb: table.best_backend(estimate_message_bytes(sfs[nb], unit),
                                   candidates=PRIORS_BACKENDS)
            for nb in sorted(sfs)}
    sizes = sorted(pick)
    flips = [(lo, hi) for lo, hi in zip(sizes, sizes[1:])
             if pick[lo] != pick[hi]]
    at = list(flips[0]) if flips else [sizes[0], sizes[-1]]
    g = torch.Generator(device=dev).manual_seed(28)
    out = {"table_choice": {str(k): v for k, v in pick.items()},
           "checked_bytes": at, "auto": {}}
    for nb in at:
        sf = sfs[nb]
        auto = SFComm(sf, device=dev, unit=unit)
        check(auto.backend_name == pick[nb], f"priors: SFComm at {nb} B "
              f"took {auto.backend_name!r}, the table says {pick[nb]!r}")
        root = torch.randn(sf.nroots_total, generator=g, device=dev)
        leaf = torch.randn(sf.nleafspace_total, generator=g, device=dev)
        got = (auto.bcast(root, leaf, "replace"), auto.reduce(leaf, root))
        for bk in PRIORS_BACKENDS:
            fixed = SFComm(sf, backend=bk, device=dev, unit=unit)
            want = (fixed.bcast(root, leaf, "replace"),
                    fixed.reduce(leaf, root))
            check(all(same_raw_bits(a, b) for a, b in zip(got, want)),
                  f"priors: SFComm({pick[nb]!r}) at {nb} B is not bitwise "
                  f"{bk!r}")
            del fixed
        out["auto"][str(nb)] = {"backend": auto.backend_name,
                                "bitwise": list(PRIORS_BACKENDS)}
        del auto, root, leaf, got
    if dev.type == "cuda":
        cpu = SFComm(sfs[at[0]], device="cpu", unit=unit).backend_name
        check(cpu == "global", f"priors: a CPU SFComm took {cpu!r} under "
              f"the card's table")
        out["cpu_sfcomm"] = cpu
    return out


def priors_refusals(payloads: dict, root: str) -> dict:
    """Copies of the written artifacts whose stamp names another device
    count or another card: ``PriorsTable.load`` must refuse them."""
    from repro_torch.core import priors
    out = {}
    for key, other in (("device_count", lambda v: int(v) + 1),
                       ("device_name", lambda v: f"{v} (another card)")):
        d = os.path.join(root, key)
        os.makedirs(d)
        for name, obj in payloads.items():
            meta = dict(obj["meta"], **{key: other(obj["meta"][key])})
            with open(os.path.join(d, name), "w") as f:
                json.dump(dict(obj, meta=meta), f)
        out[key] = priors.PriorsTable.load(root=d) is None
        check(out[key], f"priors: a stamp with another {key} was loaded")
    return out


def phase_priors(sz: Sizes, dev) -> dict:
    """Measured backend selection (``core/priors.py``): the reference's
    ping-pong and halo sweeps on both backends, ``select_backend`` against
    the argmin at every point, then both sweeps written as stamped
    artifacts into a temporary directory, loaded through
    ``REPRO_SF_PRIORS`` and ``default_priors()`` and followed by
    ``SFComm``; the variable and the memo are put back after, so that no
    later phase changes its route."""
    import tempfile
    from repro_torch.core import priors
    from repro_torch.kernels import ops as kops
    t_start = time.perf_counter()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    curves, pp_choice, sfs = priors_pingpong(sz, dev)
    t_pp = time.perf_counter() - t0
    t0 = time.perf_counter()
    grids = priors_halo(sz, dev)
    t_halo = time.perf_counter() - t0
    sweep_launches = {k: v for k, v in kops.launch_counts().items() if v}
    meta = priors.current_env()
    payloads = {
        "BENCH_torch_pingpong.json": {
            "bench": "pingpong", "unit": "us_per_call",
            "sizes_bytes": list(sz.priors_pingpong), "backends": curves,
            "meta": meta},
        "BENCH_torch_halo.json": {
            "bench": "halo", "unit": "us_per_call", "nranks": 4,
            "units": list(sz.priors_units), "grids": grids, "meta": meta}}
    saved = os.environ.get("REPRO_SF_PRIORS")
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_priors_") as d:
            for name, obj in payloads.items():
                with open(os.path.join(d, name), "w") as f:
                    json.dump(obj, f)
            os.environ["REPRO_SF_PRIORS"] = d
            priors.invalidate_priors_cache()
            auto = priors_auto(dev, sfs)
            auto["refused"] = priors_refusals(payloads, d)
    finally:
        if saved is None:
            os.environ.pop("REPRO_SF_PRIORS", None)
        else:
            os.environ["REPRO_SF_PRIORS"] = saved
        priors.invalidate_priors_cache()
    t_auto = time.perf_counter() - t0
    after = priors.default_priors()
    check(after is None, f"priors: default_priors() is {after} after the "
          f"phase")
    del sfs
    return {"phase": "priors", "meta": meta,
            "pingpong": {"us_per_call": curves, "choice": pp_choice,
                         "crossovers": crossovers(curves)},
            "halo": {gname: {"halo_edges": rec["halo_edges"],
                             "unit_us": {bk: rec["backends"][bk]["unit_us"]
                                         for bk in PRIORS_BACKENDS},
                             "choice": rec["backends"]["auto"]["choice"]}
                     for gname, rec in grids.items()},
            "choice_equals_argmin": True, **auto,
            "default_priors_after": None,
            "sweep_launches": sweep_launches,
            "launches": kops.launch_counts(),
            "seconds": time.perf_counter() - t_start,
            "pingpong_s": t_pp, "halo_s": t_halo,
            "auto_s": t_auto,
            "nvidia_smi": nvidia_smi() if dev.type == "cuda" else None}


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
def recorded_segreds(log: list, part: str):
    """Within the block, every ``kops.segment_reduce_rows`` call that
    launches row 5 (``segment_reduce_sorted``; on the CPU, a call whose
    fixed rule names it) appends its shape, dtype, op, whether it was
    runtime-routed, ``part`` and its (first, length) metadata (not its
    buffer) to ``log``, and runs as it does."""
    from repro_torch.kernels import ops as kops, sf_unpack
    real = kops.segment_reduce_rows

    def segment_reduce_rows(sorted_vals, seg_first, seg_len, *, op="sum",
                            key=None, dynamic=False):
        before = sf_unpack.segment_reduce_sorted.launches
        out = real(sorted_vals, seg_first, seg_len, op=op, key=key,
                   dynamic=dynamic)
        row5 = sf_unpack.segment_reduce_sorted.launches > before \
            if sorted_vals.is_cuda else \
            kops._segred_default(sorted_vals) == "row"
        if row5:
            log.append({"part": part, "shape": tuple(sorted_vals.shape),
                        "dtype": sorted_vals.dtype, "op": op,
                        "dynamic": dynamic, "first": seg_first,
                        "length": seg_len})
        return out
    kops.segment_reduce_rows = segment_reduce_rows
    try:
        yield
    finally:
        kops.segment_reduce_rows = real


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


def moe_wide(cfg, p, sz: Sizes, dev) -> dict:
    """kimi-k2's MoE layer with its shared expert at full width in bf16
    (the 384-way fan), on the served model's layer-0 leaves ``p``: kernels
    against plain gathers bitwise at decode and prefill, each gather
    timed."""
    import torch
    from repro_torch.models import moe as M
    g = torch.Generator(device=dev).manual_seed(31)
    moe_leaves = [v for k, v in p.items() if k == "router" or
                  k.startswith(("w_in", "w_gate", "w_out", "shared_"))]
    out = {"arch": cfg.name, "dtype": cfg.dtype, "d_model": cfg.d_model,
           "experts": cfg.moe_experts, "topk": cfg.moe_topk,
           "d_ff": cfg.moe_dff, "shared_ff": cfg.moe_shared_ff,
           "leaves": "the served model's layer 0",
           "param_bytes": sum(v.numel() * v.element_size()
                              for v in moe_leaves),
           "cases": {}, "gathers": []}
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


def moe_drive(cfg, params, sz: Sizes, dev, rng) -> dict:
    """The serve phase's trace through ``ServeEngine(batch=8, s_max=2048)``
    + ``loadgen.drive`` on a MoE model, the launch counters from 0 just
    before the drive and read just after it (``launches``): every request
    done, one flash launch a layer and a prefill, every one on the wgmma
    route; the plan cache's hit rate, peak memory; then where the time
    goes: a prefill of the largest bucket alone, and five decode steps of
    all slots after 8 requests were admitted, each profiled."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops as kops
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine, drive, \
        trace_fingerprint
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
          f"a {cfg.name} request did not finish with its budget of tokens")
    check(counts["flash_attention"] == cfg.n_layers * len(reqs) or
          dev.type != "cuda", f"{cfg.name} flash launches "
          f"{counts['flash_attention']} != {cfg.n_layers} x {len(reqs)}")
    check(sm90 == counts["flash_attention"], f"only {sm90} of "
          f"{counts['flash_attention']} {cfg.name} flash launches took the "
          f"wgmma route")
    out = {"trace_fingerprint": trace_fingerprint(trace),
           "requests": len(reqs),
           "prompt_tokens": sum(r.prompt_len for r in reqs),
           "drive_wall_s": wall, "metrics": metrics,
           "plan_cache": M.plan_cache().stats(),
           "launches": counts, "flash_launches_sm90": sm90,
           "flash_head_size": cfg.hd,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
           if dev.type == "cuda" else None}

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
    del eng
    return out


def moe_params(cfg, seed: int, dev) -> tuple:
    """(params, record) of ``cfg`` from a seeded generator: its parameter
    count, bytes and init seconds."""
    import torch
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, generator=g, device=dev)
    sync(dev)
    leaves = [params["embed"], params["final_norm"],
              *params["blocks"].values()] + \
        ([] if cfg.tie_embeddings else [params["lm_head"]])
    return params, {"params": sum(t.numel() for t in leaves),
                    "param_bytes": sum(t.numel() * t.element_size()
                                       for t in leaves),
                    "init_s": time.perf_counter() - t0}


def moe_serve(sz: Sizes, dev) -> dict:
    """(c) phi3.5-moe served in bf16 at full width, ``moe_layers`` layers,
    random weights from a seeded generator: the batch-1 engine check, the
    gathers timed at the serving shapes (layer 0), then :func:`moe_drive`."""
    import torch
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(6)
    base = moe_config(sz)
    cfg = base.scaled(n_layers=min(sz.moe_layers, base.n_layers))
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "of_layers": base.n_layers, "d_model": cfg.d_model}
    out["engine_equals_direct_greedy"] = moe_engine_check(cfg, sz, dev, rng)
    gc.collect()
    params, rec = moe_params(cfg, 0, dev)
    out.update(rec)
    # the gathers at the serving shapes, on layer 0's leaves
    bp = T.layer(params["blocks"], 0)
    g = torch.Generator(device=dev).manual_seed(0)
    gathers = []
    for shape in ((sz.serve_batch, 1), (1, sz.moe_prefill)):
        x = torch.randn(shape + (cfg.d_model,), generator=g,
                        device=dev).to(torch.bfloat16)
        gathers += moe_gathers("phi bf16", x, bp, cfg, dev,
                               sz.timing_iters)
        out.setdefault("fuse_switch", []).append(
            fuse_switch(x, bp, cfg, dev, sz.timing_iters))
    out["gathers"] = gathers
    del bp
    out.update(moe_drive(cfg, params, sz, dev, rng))
    del params
    gc.collect()
    return out


def kimi_narrow_config(base, sz: Sizes):
    """kimi-k2 for the float32 engine check: its heads (64 / 8 of 112),
    its 384 experts top-8 with the shared expert and its vocabulary, at
    d_model 1,024 and expert widths of 256 (two float32 layers at full
    width would take 136 GB; with ``moe_smoke`` the smoke config ``base``
    itself, already at head size 112)."""
    if sz.moe_smoke:
        return base
    return base.scaled(d_model=1024, moe_dff=256, moe_shared_ff=256)


def moe_kimi_serve(sz: Sizes, dev) -> dict:
    """(d) kimi-k2 served in bf16 at full width, ``kimi_layers`` of its 61
    layers, random weights from a seeded generator: the batch-1 engine
    check on :func:`kimi_narrow_config`, :func:`moe_wide` on the served
    model's layer-0 MoE leaves (``wide_layer``), row 8 at every prefill
    bucket of the trace and at ``moe_prefill`` tokens (``flash_buckets``,
    ``flash`` the latter: :func:`family_flash`, the wgmma kernel at head
    size 112 in turns with the mma.sync kernel at 112, cold L2 at
    ``moe_prefill``, SDPA), then :func:`moe_drive`, whose every attention
    call must have a shape and mask checked here."""
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(7)
    base = moe_config(sz, sz.moe_wide_arch)
    if sz.moe_smoke:
        base = base.scaled(head_dim=112)
    cfg = base.scaled(n_layers=min(sz.kimi_layers, base.n_layers))
    check(cfg.hd == 112, f"kimi-k2's head size is {cfg.hd}, not 112")
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "of_layers": base.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd],
           "experts": [cfg.moe_experts, cfg.moe_topk], "vocab": cfg.vocab}
    narrow = kimi_narrow_config(base, sz)
    out["engine_equals_direct_greedy"] = dict(
        moe_engine_check(narrow, sz, dev, rng), d_model=narrow.d_model,
        moe_dff=narrow.moe_dff, heads=[narrow.n_heads, narrow.n_kv_heads,
                                       narrow.hd])
    gc.collect()
    params, rec = moe_params(cfg, 0, dev)
    out.update(rec)
    t0 = time.perf_counter()
    bp = T.layer(params["blocks"], 0)
    out["wide_layer"] = moe_wide(cfg, bp, sz, dev)
    out["wide_layer"]["seconds"] = time.perf_counter() - t0
    del bp
    # the prefill's attention: causal, the window layer_windows gives it
    S, win = sz.moe_prefill, T.layer_windows(cfg, sz.serve_s_max)[0]
    out["flash_buckets"] = [family_flash(
        dev, f"kimi-k2 prefill {s}", 1, s, s, cfg.n_heads, cfg.n_kv_heads,
        cfg.hd, True, win, sz.timing_iters, prev_route="flash_attention",
        cold=s == S) for s in sorted(set(serve_buckets(
            serve_trace(sz, cfg), sz)) | {S})]
    out["flash"] = next(r for r in out["flash_buckets"] if r["Sq"] == S)
    checked = {(1, r["Sq"], r["Skv"], r["H"], r["Hkv"], r["D"], True, win)
               for r in out["flash_buckets"]}
    seen = set()
    with attention_calls(seen):
        out.update(moe_drive(cfg, params, sz, dev, rng))
    out["flash_call_shapes"] = sorted(seen)
    check(seen <= checked, f"kimi-k2's drive ran attention at "
          f"{sorted(seen - checked)}, which no bucket check held against "
          f"the plain version")
    del params
    gc.collect()
    return out


def phase_moe(sz: Sizes, dev) -> dict:
    """The MoE slice: (a) DynPlan, (b) phi's layer in float32, (c)
    phi3.5-moe served, (d) kimi-k2 served (with its 384-expert layer's
    checks); (c)'s and (d)'s drives are the counted path, their launches
    summed."""
    import torch
    t0 = time.perf_counter()
    out = {"phase": "moe"}
    for key, part in (("dynplan", moe_dynplan), ("layer", moe_layer_checks),
                      ("serve", moe_serve), ("kimi_serve", moe_kimi_serve)):
        # what earlier parts and phases leave allocated: each serving
        # drive's peak adds to it
        resident = torch.cuda.memory_allocated(dev) / 1e9 \
            if dev.type == "cuda" else None
        t1 = time.perf_counter()
        out[key] = part(sz, dev)
        out[key]["resident_before_gb"] = resident
        out[key]["seconds"] = time.perf_counter() - t1
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["wide_layer"] = out["kimi_serve"].pop("wide_layer")
    by_drive = {k: out[k].pop("launches") for k in ("serve", "kimi_serve")}
    out["launches"] = {k: sum(c.get(k, 0) for c in by_drive.values())
                       for k in set().union(*by_drive.values())}
    out["launches_by_drive"] = by_drive
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------- families
# the families phase's sizes for a rehearsal on the CPU (smoke configs)
FAMILIES_SMOKE = dict(
    hymba_batch=4, hymba_s_max=64, hymba_requests=4, hymba_prompt=(4, 40),
    hymba_new=(2, 6), hymba_check_prompt=24, hymba_short_scan=10,
    hymba_stream_prompt=24,
    whisper_batch=2, whisper_frames=24, whisper_s_max=32, whisper_steps=4,
    gqa_decode_keys=100, xlstm_batch=2, xlstm_prefill=16, xlstm_steps=3,
    xlstm_check=20,
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


# The parent's D = 64 wgmma forward: the committed
# csrc/flash_attention_sm90.cu with Tiles<64> at the parent's 64-key tiles,
# 2 slots and no turns (flash_variants.variant_source), built beside the
# kernels by main() and loaded by the families child, whose row 8 shapes
# time it in turns as ``prev_ms``.
PARENT_D64_TILES = (64, 2, False)
PARENT_D64_BUILD: dict = {}     # {"proc": the background nvcc}


def parent_d64_paths() -> tuple:
    """(source, library) of the parent's D = 64 build under
    build/flash_variants/, named by the source's and flags' hash."""
    import hashlib
    import flash_variants
    from repro_torch.kernels import _build
    src = flash_variants.variant_source(
        (_build.CSRC / "flash_attention_sm90.cu").read_text(), 64,
        PARENT_D64_TILES)
    heads = (_build.CSRC / "wgmma_tma.cuh").read_text()
    tag = hashlib.sha1((src + heads + " ".join(_build.NVCC_FLAGS))
                       .encode()).hexdigest()[:12]
    out = os.path.join(HERE, "build", "flash_variants", f"parent_d64-{tag}")
    return src, out + ".so"


def start_parent_d64_build():
    """nvcc on the parent's D = 64 build, started in the background (None
    if the library is there): :func:`finish_parent_d64_build` waits."""
    from repro_torch.kernels import _build
    src, lib = parent_d64_paths()
    if os.path.exists(lib):
        return None
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    cu = lib[:-3] + ".cu"
    with open(cu, "w") as f:
        f.write(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         lib[:-3] + f".{os.getpid()}.tmp.so", cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_parent_d64_build(proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"the parent's D = 64 build failed:\n{log}")
    lib = parent_d64_paths()[1]
    os.replace(lib[:-3] + f".{os.getpid()}.tmp.so", lib)


def parent_d64_flash():
    """The parent's D = 64 forward as a function of (q, k, v, causal,
    window) -> o on the card (its entry point is the committed one's)."""
    import ctypes
    import torch
    from repro_torch.kernels import _build, flash_attention as fa
    f = ctypes.CDLL(parent_d64_paths()[1]).flash_attention_sm90_fwd
    f.argtypes = _build._SIGNATURES["flash_attention_sm90_fwd"][1]
    f.restype = ctypes.c_int
    bc = PARENT_D64_TILES[0]

    def run(q, k, v, causal, window):
        B, Sq, H, D = q.shape
        Skv, Hkv = k.shape[1:3]
        check(D == 64, f"the parent's D = 64 build at D = {D}")
        o = torch.empty_like(q)
        has_window, win = fa._window_arg(window, Sq, Skv)
        br = fa.tile_height(B, Sq, H, fa._sm_count(q.device.index))
        order = fa._order_tensor((Sq, Skv, bool(causal), has_window, win,
                                  br, bc), q.device)
        rc = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
               order.data_ptr(), B, Sq, Skv, H, Hkv, D, int(causal),
               has_window, win, 1.0 / math.sqrt(D), br, order.numel(),
               _build.stream_of(q))
        check(rc == 0, f"the parent's D = 64 kernel failed: {rc}")
        return o
    return run


def family_flash(dev, what: str, B: int, Sq: int, Skv: int, H: int,
                 Hkv: int, D: int, causal: bool, window, it: int,
                 prev_route: str = None, cold: bool = False) -> dict:
    """Row 8 at a family's shape, bf16, on the route :func:`route` gives
    it: the call against its plain version within FLASH_TOL (on the split
    route also against its plain split-and-combine version), two calls
    bitwise, o bitwise with and without the LSE and the LSE within
    FLASH_LSE_ATOL of the plain one; device ms (CUDA-graph replays between
    CUDA events: torch.profiler drops events in this process's late
    windows) in turns with the kernel the route replaces (``prev_ms``: the
    parent's D = 64 build at head size 64, the wgmma kernel at 128, or the
    kernel of ``prev_route``, checked against the plain version too), and
    on the split route the wgmma kernel now (``sm90_ms``), beside the bound
    and SDPA on the same inputs (``is_causal`` for a plain causal mask at
    Sq = Skv, a boolean mask for the others); ``cold``: also the
    kernel's device ms with L2 scrubbed (``ms_cold_l2``); on the wgmma
    route its tile height (``tile_rows``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(7 * Sq + Skv)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Skv, Hkv, D, generator=g, device=dev).bfloat16()
    kw = dict(causal=causal, window=window)
    route = fa.call_route(q, k)
    run = lambda: fa.flash_attention(q, k, v, **kw)
    plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
    got = run()
    check(same_raw_bits(got, run()), f"flash at {what}: two calls differ")
    want, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
    err = flash_check(got, want, f"flash at {what}")
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    check(same_raw_bits(o, got), f"flash at {what}: o differs with the LSE")
    seen = torch.isfinite(want_lse)
    check(torch.equal(torch.isfinite(lse), seen), f"flash at {what}: the "
          f"LSE is not -inf exactly where a row sees no key")
    lse_err = float((lse[seen] - want_lse[seen]).abs().max()) \
        if seen.any() else 0.0
    check(lse_err <= FLASH_LSE_ATOL, f"flash at {what}: LSE {lse_err}")
    del want, want_lse, o, lse
    on_card = dev.type == "cuda"
    if route == fa.SPLIT:
        flash_check(got, fa.flash_attention_split_plain(
            q, k, v, sms=fa._sm_count(dev.index) if on_card else fa.H100_SMS,
            **kw), f"split plain at {what}")
    prev_kernel = prev_route or ("parent's D = 64 wgmma build" if D == 64
                                 else fa.SM90) if on_card else "plain (CPU)"
    if not on_card:
        prev = plain
    elif prev_route:
        prev = lambda: fa.launch_kernel(prev_route, q, k, v, **kw)
    elif D == 64:
        parent = parent_d64_flash()
        prev = lambda: parent(q, k, v, causal, window)
    else:
        prev = lambda: fa.launch_kernel(fa.SM90, q, k, v, **kw)
    flash_check(prev(), plain(), f"{prev_kernel} at {what}")
    # SDPA's own causal mask where it is the plain one (its is_causal is
    # aligned top-left, the same as end-aligned only at Sq = Skv; a window
    # of at least Skv keys masks nothing more): the flash backend takes
    # it, a boolean mask the slower ones
    plain_causal = causal and (window is None or window >= Skv) and \
        Sq == Skv
    mask = None
    if (causal or window is not None) and not plain_causal:
        qpos = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=dev)[None, :]
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=plain_causal, enable_gqa=True)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    nops = 4.0 * visible_pairs(Sq, Skv, causal, window) * H * D * B
    bms, by = bound(nbytes, nops, BF16_OPS_PER_S)
    (ms, ms_runs), (prev_ms, prev_runs) = in_turns(run, prev, dev, it,
                                                   graph_ms)
    rec = {"what": what, "B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hkv": Hkv,
           "D": D, "causal": causal, "window": window, "route": route,
           "rows_per_kv_head": Sq * H // Hkv, "max_abs_err": err,
           "lse_max_abs_err": lse_err, "bitwise_repeat": True,
           "ms": ms, "ms_runs": ms_runs, "prev_ms": prev_ms,
           "prev_ms_runs": prev_runs, "prev_kernel": prev_kernel,
           "plain_ms": graph_ms(plain, dev, it),
           "library_ms": graph_ms(library, dev, it),
           "bound_ms": bms, "bound_by": by}
    if cold:
        rec["ms_cold_l2"] = cold_graph_ms(run, dev, it)
    if route == fa.SM90:
        rec["tile_rows"] = fa.tile_height(B, Sq, H, fa._sm_count(dev.index)
                                          if on_card else fa.H100_SMS)
    if route == fa.SPLIT:
        plan = fa.split_plan(B, Sq, Skv, H, Hkv, D, causal, window,
                             fa._sm_count(dev.index) if on_card
                             else fa.H100_SMS)
        rec["split_plan"] = {"n_split": plan.n_split, "mt": plan.mt,
                             "grid": list(plan.grid)}
        if on_card:
            rec["sm90_ms"] = graph_ms(
                lambda: fa.launch_kernel(fa.SM90, q, k, v, **kw), dev, it)
    rec["share_of_bound"] = bms / rec["ms"]
    return rec


@contextlib.contextmanager
def attention_calls(log: set):
    """Within the block, every prefill attention core call adds its (B,
    Sq, Skv, H, Hkv, D, causal, window) to ``log``."""
    from repro_torch.kernels import ops as kops
    real = kops.flash_attention

    def core(q, k, v, **kw):
        Sq, H, D = (int(n) for n in q.shape[-3:])
        Skv, Hkv = int(k.shape[-3]), int(k.shape[-2])
        log.add((int(q.shape[0]) if q.dim() == 4 else 1, Sq, Skv, H, Hkv,
                 D, kw.get("causal", True), kw.get("window")))
        return real(q, k, v, **kw)
    kops.flash_attention = core
    try:
        yield
    finally:
        kops.flash_attention = real


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


def profiled_kernels(fn, dev):
    """(device ms by kernel name, wall ms) of one ``fn()`` under
    torch.profiler with CUDA activity only, read from the raw kineto
    events: a training step of graph replays records ~10^6 kernels, whose
    ``key_averages()`` takes minutes to build.  On the CPU as
    :func:`profiled`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return profiled(fn, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    PROFILER_WINDOWS["taken"] += 1
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            by_name[e.name()] = by_name.get(e.name(), 0.0) \
                + e.duration_ns() / 1e6
    return by_name, wall


def profiled_groups(fn, dev, profile=profiled) -> dict:
    """A profiled window of ``fn()`` (through ``profile``, default
    :func:`profiled`): wall and device ms, idle share and device ms by
    kernel group (taken again while the profiler returns no device
    event)."""
    for wait in (0.0,) + RETAKE_WAITS_S:
        time.sleep(wait)
        by_name, wall_ms = profile(fn, dev)
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
    # decode steps of all slots (read from the raw kernel events: the SSM
    # scan's graph replays make key_averages() slow to build)
    for i in range(sz.hymba_batch):
        eng.submit(Request(300 + i, rng.integers(
            0, cfg.vocab, sum(sz.hymba_prompt) // 2).tolist(), max_new=64))
    eng.step()
    big = torch.as_tensor(rng.integers(0, cfg.vocab, (1, longest)),
                          device=dev)
    t1 = time.perf_counter()
    out[f"profiled_prefill_{longest}"] = profiled_groups(
        lambda: T.prefill(params, cfg, tokens=big, s_max=sz.hymba_s_max), dev,
        profiled_kernels)
    out["profiled_5_decode_steps"] = profiled_groups(
        lambda: [eng.step() for _ in range(5)], dev, profiled_kernels)
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
        real = S._use_graphs
        S._use_graphs = lambda *a: False     # the steps launched one by one
        try:
            eager = lambda: S.ssm_scan(x, bp, cfg)  # noqa: E731
            y_e, h_e = eager()
            eager_ms = call_ms(eager, dev, 2)
        finally:
            S._use_graphs = real
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
    # the decoder's prefill calls (self-attention over P keys, cross-
    # attention over F_, P rows each) and the cross-attention at each
    # decode step (1 row) take the split route where the rule sends them
    from repro_torch.kernels import flash_attention as fa
    rep = cfg.n_heads // cfg.n_kv_heads
    split = cfg.n_layers * sum(
        n * (fa.route(torch.bfloat16, cfg.hd, rows, keys) == fa.SPLIT)
        for n, rows, keys in ((1, P * rep, P), (1, P * rep, F_),
                              (sz.whisper_steps, rep, F_)))
    check(counts["flash_attention_split"] == split or dev.type != "cuda",
          f"whisper's split-KV launches {counts['flash_attention_split']} "
          f"!= {split}")
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
        family_flash(dev, "whisper decoder self-attention, prefill", B, P,
                     P, cfg.n_heads, cfg.n_kv_heads, cfg.hd, True, None,
                     sz.timing_iters),
        family_flash(dev, "whisper cross-attention, decode", B, 1, F_,
                     cfg.n_heads, cfg.n_kv_heads, cfg.hd, False, None,
                     sz.timing_iters),
        # a short query under GQA: a decode step at qwen3-4b's heads
        family_flash(dev, "GQA decode, 32 / 8 heads of 128", 1, 1,
                     sz.gqa_decode_keys, 32, 8, 128, True, None,
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
    launches = {k: acc.get(k, 0) for k in kops.launch_counts()}
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
    if dev.type == "cuda":
        finish_parent_d64_build(PARENT_D64_BUILD.pop("proc", None))
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


# ------------------------------------------------------------------ train
# FlashAttention's gradients (the forward and backward kernels) against
# flash_attention_backward_plain and against the plain version's autograd
# gradients, bf16: per tensor ||d|| <= 1e-2 ||want||.  The kernels round P
# and dS to bf16 as mma operands (the forward rounds P the same way) and
# return bf16 gradients; the plain sides stay in float32 to the last cast.
# float32 inputs: the kernels' FMAs hold 1e-4.
FLASH_BWD_REL = 1e-2
FLASH_BWD_F32_REL = 1e-4
# the training forward's saved base-2 log-sum-exp against the plain
# version's: float32 statistics, 1e-5 absolute
FLASH_LSE_ATOL = 1e-5
# MoE gradients through the SF dispatch against the dense dispatch: float32
# on one layer at the reference's tests/test_models.py:162-178 tolerance;
# bf16 through the whole model, where the two dispatches round their sums
# in different orders, each leaf's SF gradient within 3e-2 (relative L2) of
# the float32 gradient of the same parameters, or no further from it than
# twice the dense dispatch's bf16 gradient is
MOE_GRAD_RTOL, MOE_GRAD_ATOL = 2e-4, 1e-6
MOE_BF16_GRAD_REL = 3e-2
# one DDP step with grains=1 against make_train_step, bf16 parameters:
# the reference's tests/test_ddp.py:359-376 (rtol 1e-6, atol 1e-6)
DDP_STEP_RTOL, DDP_STEP_ATOL = 1e-6, 1e-6
TRAIN_PATH = ("flash_attention", "flash_attention_backward", PACK, SEGRED)
TRAIN_SMOKE = dict(train_smoke=True, train_batch=2, train_seq=32,
                   train_fixed_steps=4, ddp_layers=2, ddp_batch=4,
                   ddp_seq=16, ddp_budget=4096, moe_train_batch=2,
                   moe_train_seq=32, moe_grad_tokens=(2, 24),
                   flash_bwd_shapes=((64, 4, 2, 64, None),
                                     (96, 5, 1, 64, 48),
                                     (80, 8, 1, 112, None)),
                   hymba_train=(2, 40), hymba_train_steps=(2, 3),
                   xlstm_train=(2, 20), xlstm_train_steps=(2, 3),
                   whisper_train=(2, 12, 24), whisper_train_steps=(2, 3),
                   scan_check=(2, 600), xlstm_check_train=(2, 140),
                   timing_iters=2)


def train_config(arch: str, sz: Sizes, **scaled):
    """``arch``'s published config, scaled by ``scaled`` (its smoke config
    with ``train_smoke``, for rehearsals on the CPU)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (cfg.smoke_config() if sz.train_smoke else cfg).scaled(**scaled)


def grad_rel(a, b) -> float:
    """||a - b|| / ||b|| in float64 (0 when both are 0)."""
    import torch
    d = torch.linalg.vector_norm((a.double() - b.double()).reshape(-1))
    nb = torch.linalg.vector_norm(b.double().reshape(-1))
    return float(d / nb) if float(nb) else float(d)


def step_timed(fn, dev) -> tuple:
    """(result, host ms, device ms between CUDA events) of one ``fn()``."""
    import torch
    if dev.type != "cuda":
        t0 = time.perf_counter()
        res = fn()
        ms = (time.perf_counter() - t0) * 1e3
        return res, ms, ms
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def peak_gb(dev) -> float:
    import torch
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0


def visible_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """The (query, key) pairs one query head sees (end-aligned rows)."""
    qpos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(Skv - 1, qpos) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, qpos - window + 1) if window is not None \
        else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def old_flash_backward(q, k, v, go, causal: bool, window, scale=None):
    """Autograd through the plain version (``flash_bwd_check``'s second
    reference): recomputed in float32 under grad and differentiated, the
    Function's backward before the backward kernels."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = fa.flash_attention_plain(*ins, causal=causal, window=window,
                                       scale=scale)
        return torch.autograd.grad(out, ins, go)


def flash_shape_key(q, k, causal: bool, window, scale) -> list:
    """One backward call's shapes and mask, as JSON: q's and k's shapes,
    the dtype, causal, window, scale."""
    return [list(q.shape), list(k.shape), str(q.dtype)[6:], bool(causal),
            window, scale]


def flash_bwd_check(what: str, q, k, v, go, causal: bool, window, dev,
                    it: int, scale=None) -> tuple:
    """Row 8's backward kernels checked on ``q, k, v`` and output gradient
    ``go`` (q's shape and dtype): the gradients through
    ``kops.flash_attention`` (the Function, one launch of the kernels)
    against ``flash_attention_backward_plain`` and against autograd
    through ``flash_attention_plain``, each within FLASH_BWD_REL (bf16;
    FLASH_BWD_F32_REL for float32 inputs); bf16 inputs also in float32
    within FLASH_BWD_F32_REL; two calls bitwise equal.  Where the backward
    takes the sm90 route (bf16, head size 64 or 128) the forward's saved
    log-sum-exp too: o with the LSE written bitwise o without it (the
    serving path's call), the LSE within FLASH_LSE_ATOL of the plain
    version's.  Then the kernels' device ms (graph replays, on the saved
    LSE) and the bound (10 B (visible pairs) H D FLOPs over the bf16
    tensor cores against the bytes of q, k, v, o, dO, dq, dk and dv).
    Returns (record, the Function's output, the LSE or None)."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops as kops
    kw = dict(causal=causal, window=window, scale=scale)
    tol = FLASH_BWD_F32_REL if q.dtype == torch.float32 else FLASH_BWD_REL
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    y = kops.flash_attention(qr, kr, vr, **kw)
    check(y.grad_fn is not None and "FlashAttention"
          in type(y.grad_fn).__name__, "kops.flash_attention took no "
          "autograd Function for inputs that require grad")
    before = fa.flash_attention_backward.launches
    got = torch.autograd.grad(y, (qr, kr, vr), go)
    check(fa.flash_attention_backward.launches == before + 1
          or dev.type != "cuda", f"{what}: the Function's backward did not "
          f"launch the backward kernels once")
    o = y.detach()
    del y, qr, kr, vr
    want = fa.flash_attention_backward_plain(q, k, v, o, go, **kw)
    auto = old_flash_backward(q, k, v, go, causal, window, scale)
    rel = {n: grad_rel(a, b) for n, a, b in zip("qkv", got, want)}
    rel_auto = {n: grad_rel(a, b) for n, a, b in zip("qkv", got, auto)}
    check(all(r <= tol for r in (*rel.values(), *rel_auto.values())),
          f"flash backward at {what}: ||d||/||want|| {rel} against the "
          f"plain backward, {rel_auto} against autograd, over {tol}")
    err = max(max_abs(a, b) for a, b in zip(got, want))
    del want, auto
    rec = {"what": what, "q": list(q.shape), "kv": list(k.shape),
           "causal": causal, "window": window, "scale": scale,
           "dtype": str(q.dtype)[6:], "rel_err": rel,
           "rel_err_autograd": rel_auto, "tolerance_rel": tol,
           "max_abs_err": err}
    if q.dtype != torch.float32:
        f32 = [t.float() for t in (q, k, v, go)]
        o32 = fa.flash_attention(*f32[:3], **kw)
        got32 = fa.flash_attention_backward(*f32[:3], o32, f32[3], **kw)
        want32 = fa.flash_attention_backward_plain(*f32[:3], o32, f32[3],
                                                   **kw)
        rel32 = {n: grad_rel(a, b) for n, a, b in zip("qkv", got32, want32)}
        check(all(r <= FLASH_BWD_F32_REL for r in rel32.values()),
              f"float32 flash backward at {what}: {rel32} over "
              f"{FLASH_BWD_F32_REL}")
        del f32, o32, got32, want32
        rec.update(float32_rel_err=rel32,
                   float32_tolerance_rel=FLASH_BWD_F32_REL)
    lse = None
    rec["route"] = fa.bwd_route(q.dtype, q.shape[-1])
    if rec["route"] == "sm90":
        o_lse, lse = fa.flash_attention_lse(q, k, v, **kw)
        _, want_lse = fa.flash_attention_plain(q, k, v, with_lse=True, **kw)
        seen = torch.isfinite(want_lse)
        lse_err = float((lse[seen] - want_lse[seen]).abs().max()) \
            if bool(seen.any()) else 0.0
        check(same_raw_bits(o_lse, o) and same_raw_bits(
            o_lse, fa.flash_attention(q, k, v, **kw)), f"flash forward at "
            f"{what}: o with the LSE written differs from o without it")
        check(bool(torch.equal(torch.isfinite(lse), seen))
              and lse_err <= FLASH_LSE_ATOL, f"flash forward at {what}: the "
              f"LSE is {lse_err} from the plain version's (at most "
              f"{FLASH_LSE_ATOL}) or -inf elsewhere")
        rec.update(lse_max_abs_err=lse_err, lse_tolerance_abs=FLASH_LSE_ATOL,
                   o_bitwise_with_lse=True,
                   tiles=list(fa.bwd_tiles(
                       *bwd_dims(q, k), q.shape[-1],
                       fa._sm_count(dev.index) if dev.type == "cuda"
                       else fa.H100_SMS)))
        del o_lse, want_lse, seen
    run = lambda: fa.flash_attention_backward(q, k, v, o, go, lse=lse, **kw)
    again = [run(), run()]
    check(all(same_raw_bits(a, b) and same_raw_bits(a, c)
              for a, b, c in zip(got, *again)),
          f"flash backward at {what}: two calls differ in their bits")
    del again, got
    B = q.shape[0] if q.dim() == 4 else 1
    Sq, H, D = q.shape[-3:]
    pairs = visible_pairs(Sq, k.shape[-3], causal, window)
    nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
    bnd, by = bound(nbytes, 10 * B * pairs * H * D, BF16_OPS_PER_S)
    if rec["route"] == "sm90" and dev.type == "cuda":
        # the sm90 kernels in turns with the mma.sync route's on the same
        # inputs
        (ms, ms_runs), (prev, prev_runs) = in_turns(
            run, lambda: fa._launch_backward_mma(q, k, v, o, go, **kw), dev,
            it, graph_ms)
        rec.update(ms_runs=ms_runs, prev_ms_runs=prev_runs,
                   prev_kernels="the mma.sync route: flash_bwd_dq + "
                   "flash_bwd_dkdv (+ flash_bwd_dkdv_reduce under GQA)")
    else:
        ms, prev = graph_ms(run, dev, it), None
    rec.update(visible_pairs_per_head=pairs, bitwise_repeat=True, ms=ms,
               prev_ms=prev, bound_ms=bnd, bound_by=by,
               share_of_bound=bnd / ms if ms else None)
    return rec, o, lse


def bwd_dims(q, k) -> tuple:
    """(B, Sq, Skv, H, Hkv) of a flash call."""
    B = q.shape[0] if q.dim() == 4 else 1
    return (B, q.shape[-3], k.shape[-3], q.shape[-2], k.shape[-2])


def flash_bwd_record(what: str, q, k, v, go, causal: bool, window, dev,
                     it: int) -> dict:
    """:func:`flash_bwd_check` on bf16 ``q, k, v`` and ``go`` (which times
    the kernels in turns with the mma.sync route's, ``prev_ms``), then the
    kernels' device ms with L2 scrubbed, the plain version's ms, SDPA's
    forward + backward (the library call), SDPA's backward kernels alone
    and the Function's forward + backward call ms."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops as kops
    kw = dict(causal=causal, window=window)
    rec, o, lse = flash_bwd_check(what, q, k, v, go, causal, window, dev, it)
    run = lambda: fa.flash_attention_backward(q, k, v, o, go, lse=lse, **kw)
    few = max(it // 4, 2)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def fb():
        yy = kops.flash_attention(qr, kr, vr, **kw)
        torch.autograd.grad(yy, (qr, kr, vr), go)
    batch = (lambda t: t) if q.dim() == 4 else (lambda t: t[None])
    rec.update({
        "ms_cold_l2": cold_graph_ms(run, dev, it),
        "plain_ms": call_ms(lambda: fa.flash_attention_backward_plain(
            q, k, v, o, go, **kw), dev, few),
        "library_ms": sdpa_fb_ms(batch(q), batch(k), batch(v), batch(go),
                                 causal, window, dev, few),
        "library_call": "scaled_dot_product_attention forward + backward",
        "library_bwd_kernels_ms": sdpa_bwd_kernels_ms(
            batch(q), batch(k), batch(v), batch(go), causal, window, dev),
        "call_ms": call_ms(fb, dev, few),
        "forward_kernel_ms": graph_ms(
            lambda: fa.flash_attention(q, k, v, **kw), dev, it)})
    return rec


def train_flash_backward(sz: Sizes, dev) -> list:
    """Row 8's backward kernels at the heads of the aims' shapes
    (qwen3-4b's, causal; hymba's 25 / 5 heads of 64 with its 2,048-key
    window; one sequence each): :func:`flash_bwd_record` at each.  The
    shapes the path itself gives the kernels are checked by
    :func:`train_flash_path_shapes`."""
    import torch
    out = []
    for S, H, Hkv, D, win in sz.flash_bwd_shapes:
        g = torch.Generator(device=dev).manual_seed(S + H)
        q, k, v = (torch.randn(S, h, D, generator=g, device=dev).bfloat16()
                   for h in (H, Hkv, Hkv))
        go = torch.randn(S, H, D, generator=g, device=dev).bfloat16()
        out.append(flash_bwd_record(f"{(S, H, Hkv, D, win)} causal", q, k,
                                    v, go, True, win, dev, sz.timing_iters))
        del q, k, v, go
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def train_flash_path_shapes(audit: dict, sz: Sizes, dev) -> dict:
    """Row 8's backward kernels at each distinct shape the train path's
    ``FlashAttention.backward`` calls had (``attention_backward_audit``'s
    ``shapes``: every family's self-attention, whisper's encoder and
    cross-attention, hymba's windowed and global layers), on seeded
    inputs of that shape and dtype: :func:`flash_bwd_check` at each (for
    bf16 its device ms in turns with the mma.sync route's kernels and its
    share of bound), and SDPA's backward kernels alone at each shape, in
    its dtype."""
    import torch
    out = []
    for i, e in enumerate(audit.get("shapes", [])):
        qs, ks, dtype, causal, window, scale = e["key"]
        g = torch.Generator(device=dev).manual_seed(29 + i)
        dt = getattr(torch, dtype)
        q, go = (torch.randn(qs, generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(ks, generator=g, device=dev).to(dt)
                for _ in range(2))
        rec, _, _ = flash_bwd_check(f"path shape {e['key']}", q, k, v, go,
                                    causal, window, dev, sz.timing_iters,
                                    scale)
        rec.update(key=e["key"], path_calls=e["calls"])
        # SDPA's backward kernels in the call's dtype (float32 too)
        batch = (lambda t: t) if q.dim() == 4 else (lambda t: t[None])
        rec["library_bwd_kernels_ms"] = sdpa_bwd_kernels_ms(
            batch(q), batch(k), batch(v), batch(go), causal, window, dev,
            scale)
        out.append(rec)
        del q, k, v, go
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    check(out, "the train path made no FlashAttention.backward call")
    return {"shapes": out}


def sdpa_bwd_kernels_ms(q, k, v, go, causal: bool, window, dev,
                        scale=None, calls: int = 5) -> float:
    """Device ms of the kernels under one backward of SDPA on (B, S, H, D)
    q, k, v (masks and GQA as :func:`sdpa_fb_ms`), profiled over ``calls``
    backwards of one forward (warm): the kernel-to-kernel yardstick of the
    flash backward's kernels."""
    import torch
    import torch.nn.functional as F
    Sq, Skv = q.shape[1], k.shape[1]
    mask = None
    if window is not None:
        qpos = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=dev)[None, :]
        mask = (kpos > qpos - window) & ((kpos <= qpos) if causal else True)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    got = go.transpose(1, 2)
    o = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True, scale=scale)

    def bwd():
        for _ in range(calls):
            torch.autograd.grad(o, (qt, kt, vt), got, retain_graph=True)
    bwd()
    if dev.type != "cuda":
        return call_ms(bwd, dev, 1) / calls
    # each backward launches each of its kernels once; torch.profiler on
    # the card may drop a call's events at a window's edge, so the mean is
    # over the calls it recorded (the most often recorded kernel's count)
    by_name, counts, _ = _profile(bwd, dev)
    check(by_name, "torch.profiler recorded no kernel of SDPA's backward")
    return sum(by_name.values()) / max(counts.values())


def sdpa_fb_ms(q, k, v, go, causal: bool, window, dev, iters: int) -> float:
    """Milliseconds of one forward and backward of SDPA under autograd on
    (B, S, H, D) q, k, v (``is_causal`` for a plain causal mask, a boolean
    mask for a window, none unmasked; GQA by ``enable_gqa``): the library
    yardstick of the flash Function's forward + backward."""
    import torch
    import torch.nn.functional as F
    Sq, Skv = q.shape[1], k.shape[1]
    mask = None
    if window is not None:
        qpos = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=dev)[None, :]
        mask = (kpos > qpos - window) & ((kpos <= qpos) if causal else True)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    got = go.transpose(1, 2)

    def fb():
        o = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        torch.autograd.grad(o, (qt, kt, vt), got)
    return call_ms(fb, dev, iters)


def train_flash_cross(sz: Sizes, dev) -> dict:
    """Row 8's backward kernels at whisper's cross-attention shape (the
    decoder's tokens over the encoder's frames, unmasked, Sq != Skv), bf16:
    :func:`flash_bwd_record`."""
    import torch
    cfg = train_config("whisper-base", sz)
    B, P, F_ = sz.whisper_train
    H, D = cfg.n_heads, cfg.hd
    g = torch.Generator(device=dev).manual_seed(448)
    q = torch.randn(B, P, H, D, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(B, F_, cfg.n_kv_heads, D, generator=g, device=dev)
            .bfloat16() for _ in range(2))
    go = torch.randn(B, P, H, D, generator=g, device=dev).bfloat16()
    return flash_bwd_record("whisper cross-attention", q, k, v, go, False,
                            None, dev, sz.timing_iters)


def train_dense(sz: Sizes, dev, acc: dict) -> dict:
    """qwen3-4b at full width and depth, bf16, float32 moments, remat per
    block: ``sz.train_steps`` steps of ``make_train_step`` (the launcher's
    path, parameters and state updated in place) on ``SyntheticLM``
    batches, counted; a profiled step by kernel group; then
    ``train_fixed_steps`` steps on one batch at lr 1e-4, whose loss must
    fall."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    cfg = train_config(sz.train_arch, sz, remat="block")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    nparams = sum(t.numel() for t in tree_leaves_of(params))
    ocfg = OptConfig(warmup_steps=10, decay_steps=max(sz.train_steps, 100))
    opt = init_opt_state(params, ocfg)
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, ocfg, donate=True)
    ds = SyntheticLM(cfg.vocab, sz.train_seq, sz.train_batch, seed=0)
    state = {"p": params, "o": opt}
    del params, opt

    def one(i):
        state["p"], state["o"], m = step(state["p"], state["o"],
                                         ds.batch_at(i))
        return float(m["loss"])

    steps = []
    for i in range(sz.train_steps):
        (loss, host, devms), _ = counted(
            lambda: step_timed(lambda: one(i), dev), acc)
        check(math.isfinite(loss), f"dense step {i}: loss {loss}")
        steps.append({"loss": loss, "host_ms": host, "device_ms": devms})
    window = profiled_groups(lambda: one(sz.train_steps), dev)
    tokens = sz.train_batch * sz.train_seq
    warm = steps[1:] or steps
    host = float(np.mean([s["host_ms"] for s in warm]))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": nparams, "param_count": cfg.param_count(),
           "dtype": cfg.dtype, "moments": "float32",
           "remat": cfg.remat, "batch": [sz.train_batch, sz.train_seq],
           "init_s": init_s, "steps": steps, "step_host_ms": host,
           "step_device_ms": float(np.mean([s["device_ms"] for s in warm])),
           "tokens_per_s": tokens / host * 1e3, "peak_gb": peak_gb(dev),
           "profiled_step": window}
    # the same parameters on one fixed batch at lr 1e-4: the loss falls
    state["o"] = None
    gc.collect()
    ocfg2 = OptConfig(lr=1e-4, warmup_steps=1, decay_steps=1000)
    state["o"] = init_opt_state(state["p"], ocfg2)
    step2 = make_train_step(cfg, ocfg2, donate=True)
    fixed = ds.batch_at(10_000)
    losses = []
    for _ in range(sz.train_fixed_steps):
        state["p"], state["o"], m = step2(state["p"], state["o"], fixed)
        losses.append(float(m["loss"]))
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{sz.train_fixed_steps} steps on one batch at lr 1e-4: losses "
          f"{losses}")
    out["fixed_batch"] = {"lr": 1e-4, "losses": losses}
    del state
    kops.reset_launch_counts()
    return out


def tree_leaves_of(tree) -> list:
    from repro_torch.training.pytree import tree_leaves
    return tree_leaves(tree)


def tree_map_of(fn, tree):
    from repro_torch.training.pytree import tree_map
    return tree_map(fn, tree)


def leaf_names(tree, prefix: str = "") -> list:
    """Slash-joined key paths of ``tree``'s leaves, in flatten order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def trees_equal(a, b) -> bool:
    return all(same_raw_bits(x, y) for x, y in
               zip(tree_leaves_of(a), tree_leaves_of(b)))


def grain_grads(loss_fn, params, batch, G: int):
    """The (G, *shape) stack of each grain's gradient, as the DDP step
    makes it."""
    import torch
    from repro_torch.training.pytree import tree_map
    from repro_torch.training.train_loop import value_and_grad
    B = next(iter(batch.values())).shape[0]
    stack = tree_map(lambda p: torch.empty((G,) + tuple(p.shape),
                                           dtype=p.dtype, device=p.device),
                     params)
    for g in range(G):
        gb = {k: v[g * (B // G):(g + 1) * (B // G)] for k, v in batch.items()}
        _, gr = value_and_grad(loss_fn, params, gb)
        tree_map(lambda s, x: s[g].copy_(x), stack, gr)
    return stack


def ddp_bucket_record(red, stack, dev, it: int) -> dict:
    """One bucket's reduce at the DDP step's shape (the bucket whose bytes
    lie nearest the budget): device ms (graph replays) of the fused
    begin/end against its bound (the grain rows read once, the reduced row
    written once) and ``torch.sum(dim=0)`` over the grain-stacked buffer,
    and its call ms; then row 5 alone on that buffer (``segred_record``:
    the vector kernel in turns with the scalar kernel, column-tiled, as
    ``prev_ms``; cold L2; plain; ``torch.sum(dim=0)`` again as its library
    call) and the scalar kernel at one CTA (before the column tiles), each
    bitwise the plain version."""
    import torch
    from repro_torch.kernels import sf_unpack
    plan = red.plan
    b = min(plan.buckets, key=lambda x: abs(x.nbytes - plan.byte_budget))
    flat = tree_leaves_of(stack)
    fields = red._bucket_fields(flat, b)
    bundle = red._bundles[b.index]
    roots = [f.new_zeros((1, f.shape[1])) for f in fields]
    reduce = lambda: bundle.reduce_multi_begin(fields, "sum").end(roots)
    G = red.grains
    buf = torch.cat(fields, dim=1)
    U = int(buf.shape[1])
    bnd, by = bound((G + 1) * b.nbytes)
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    ln = torch.full((1,), G, dtype=torch.int32, device=dev)
    want = sf_unpack.segment_reduce_plain(buf, st, ln, "sum")
    one = sf_unpack.short_variant(buf, st, ln, segs_per_block=1,
                                  col_tiles=1)
    check(same_raw_bits(one, want),
          "the one-CTA segment reduce differs from plain")
    got = reduce()
    check(all(same_raw_bits(r, w) for r, w in zip(
        got, torch.split(want, [f.shape[1] for f in fields], dim=1))),
        "the bucket reduce differs from the plain fold")
    row5 = segred_record("ddp bucket", buf, st, ln, dev, it,
                         lambda: buf.sum(dim=0, keepdim=True),
                         "torch.sum(dim=0)", lib_tol=2e-2)
    check(row5["short_plan"]["route"] == "vector",
          "the DDP bucket's segment reduce did not take the vector kernel")
    return {"bucket": b.index, "leaves": len(b.leaves), "nbytes": b.nbytes,
            "grains": G, "unit": U, "dtype": str(buf.dtype)[6:],
            "reduce_device_ms": graph_ms(reduce, dev, it),
            "reduce_call_ms": call_ms(reduce, dev, it),
            "bound_ms": bnd, "bound_by": by,
            "torch_sum_dim0_ms": graph_ms(lambda: buf.sum(dim=0), dev, it),
            "segment_reduce": row5,
            "segment_reduce_one_cta_ms": graph_ms(
                lambda: sf_unpack.short_variant(
                    buf, st, ln, segs_per_block=1, col_tiles=1), dev, 2)}


def train_ddp(sz: Sizes, dev, acc: dict) -> dict:
    """The DDP step over the allreduce SF: qwen3-4b at full width with
    ``ddp_layers`` layers, bf16, ``ddp_grains`` grains, ``ddp_budget``-byte
    buckets.  Worlds 1 and 4 give bitwise the same parameters; bucketed =
    per-tensor bitwise on the grain-stacked gradients; grains = 1 against
    ``make_train_step``; the world-4 step counted; one bucket timed."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import (TrainConfig, batch_to,
                                                 make_ddp_train_step,
                                                 make_loss_fn,
                                                 make_train_step)
    cfg = train_config(sz.train_arch, sz, n_layers=sz.ddp_layers,
                       remat="block")
    G = sz.ddp_grains
    p0 = T.init_params(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(1), device=dev)
    ocfg = OptConfig(lr=1e-4, warmup_steps=1, decay_steps=1000)
    batch = SyntheticLM(cfg.vocab, sz.ddp_seq, sz.ddp_batch, seed=1) \
        .batch_at(0)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "grains": G,
           "byte_budget": sz.ddp_budget,
           "params": sum(t.numel() for t in tree_leaves_of(p0)),
           "batch": [sz.ddp_batch, sz.ddp_seq], "worlds": {}}
    after = {}
    for world in (1, 4):
        step, reducer = make_ddp_train_step(
            cfg, ocfg, world=world, byte_budget=sz.ddp_budget, grains=G,
            params_template=p0)
        opt = init_opt_state(p0, ocfg)
        run = lambda: step_timed(lambda: step(p0, opt, batch), dev)
        if world == 4:
            launches = {}
            ((p, _, m), host, devms), _ = counted(run, launches)
            for k, v in launches.items():
                acc[k] = acc.get(k, 0) + v
            out["launches_world4"] = launches
        else:
            (p, _, m), host, devms = run()
        after[world] = p
        met = reducer().metrics()
        out["worlds"][world] = {"loss": float(m["loss"]), "host_ms": host,
                                "device_ms": devms,
                                "buckets": met["ddp_nbuckets"],
                                "bucket_mb": [round(x / 2 ** 20, 3) for x
                                              in met["ddp_bucket_bytes"]]}
        del opt, m
    check(trees_equal(after[1], after[4]), "DDP worlds 1 and 4 gave "
          "different parameters")
    out["worlds_1_4_bitwise"] = True
    del after
    red = reducer()
    stack = grain_grads(make_loss_fn(cfg, TrainConfig()), p0,
                        batch_to(batch, dev), G)
    check(trees_equal(red.allreduce(stack), red.reduce_per_tensor(stack)),
          "bucketed != per-tensor")
    out["bucketed_equals_per_tensor"] = True
    out["bucket"] = ddp_bucket_record(red, stack, dev, sz.timing_iters)
    del stack
    gc.collect()
    # grains = 1: the DDP step against the plain train step
    step1, _ = make_ddp_train_step(cfg, ocfg, world=1, byte_budget=None,
                                   grains=1, params_template=p0)
    pa, _, _ = step1(p0, init_opt_state(p0, ocfg), batch)
    pb, _, _ = make_train_step(cfg, ocfg)(p0, init_opt_state(p0, ocfg),
                                          batch)
    worst = 0.0
    for a, b in zip(tree_leaves_of(pa), tree_leaves_of(pb)):
        worst = max(worst, max_abs(a, b))
        check(bool(torch.allclose(a.float(), b.float(), rtol=DDP_STEP_RTOL,
                                  atol=DDP_STEP_ATOL)),
              f"DDP grains=1 vs make_train_step: max|d| {max_abs(a, b)}")
    out["grains1_vs_train_step"] = {"max_abs": worst,
                                    "rtol": DDP_STEP_RTOL,
                                    "atol": DDP_STEP_ATOL}
    return out


def train_moe(sz: Sizes, dev, acc: dict) -> dict:
    """phi3.5-moe at full width: (a) one MoE layer in float32, gradients
    through the SF dispatch against the dense one at the reference's
    tolerance; (b) ``moe_train_layers`` layers in bf16, the model's
    gradients SF against dense within ``MOE_BF16_GRAD_REL``, and again SF
    (repeatable or not, reported); (c) the DynPlan gather's transpose at
    the combine's shape bitwise across two runs; (d) ``moe_train_steps``
    counted steps with float32 moments."""
    import torch
    from repro_torch.core.dynplan import DynPlan
    from repro_torch.models import moe as M, transformer as T
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import (TrainConfig, batch_to,
                                                 make_loss_fn,
                                                 make_train_step,
                                                 value_and_grad)
    cfg = train_config(sz.moe_train_arch, sz, n_layers=sz.moe_train_layers,
                       remat="block")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts": cfg.moe_experts, "topk": cfg.moe_topk,
           "d_ff": cfg.moe_dff}
    # (a) one layer, float32
    c32 = cfg.scaled(dtype="float32")
    g = torch.Generator(device=dev).manual_seed(31)
    p = {k: v[0] for k, v in M.init_moe(c32, 1, generator=g,
                                        device=dev).items()}
    x = torch.randn(sz.moe_grad_tokens + (cfg.d_model,), generator=g,
                    device=dev) * 0.3

    def layer_grads(mode):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xx = x.detach().requires_grad_()
        y, aux = M.moe_layer(xx, leaves, c32, dispatch=mode)
        loss = torch.sum(y ** 2) + 0.01 * aux
        return dict(zip(list(leaves) + ["x"], torch.autograd.grad(
            loss, list(leaves.values()) + [xx])))

    gs, gd = layer_grads("sf"), layer_grads("dense")
    errs = {}
    for k in gd:
        errs[k] = max_abs(gs[k], gd[k])
        check(bool(torch.allclose(gs[k], gd[k], rtol=MOE_GRAD_RTOL,
                                  atol=MOE_GRAD_ATOL)),
              f"moe f32 layer grad {k}: sf vs dense max|d| {errs[k]}")
    out["layer_f32"] = {"tokens": list(sz.moe_grad_tokens),
                        "max_abs": errs, "rtol": MOE_GRAD_RTOL,
                        "atol": MOE_GRAD_ATOL}
    del p, gs, gd
    gc.collect()
    # (b) the model, bf16: each dispatch's gradients against the float32
    # gradients of the same parameters
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(2), device=dev)
    nparams = sum(t.numel() for t in tree_leaves_of(params))
    ds = SyntheticLM(cfg.vocab, sz.moe_train_seq, sz.moe_train_batch, seed=2)
    b0 = batch_to(ds.batch_at(0), dev)
    p32 = tree_map_of(lambda t: t.float(), params)
    grads = {"f32": value_and_grad(make_loss_fn(cfg.scaled(
        dtype="float32", moe_dispatch="dense"), TrainConfig()), p32, b0)[1]}
    del p32
    for mode in ("sf", "dense", "sf_again"):
        c = cfg.scaled(moe_dispatch="dense" if mode == "dense" else "sf")
        grads[mode] = value_and_grad(make_loss_fn(c, TrainConfig()), params,
                                     b0)[1]
    names = leaf_names(params)
    leaves = {k: tree_leaves_of(v) for k, v in grads.items()}
    per_leaf = {}
    for i, nm in enumerate(names):
        per_leaf[nm] = {
            "sf_vs_f32": grad_rel(leaves["sf"][i], leaves["f32"][i]),
            "dense_vs_f32": grad_rel(leaves["dense"][i], leaves["f32"][i]),
            "sf_vs_dense": grad_rel(leaves["sf"][i], leaves["dense"][i])}
    out["model_bf16"] = {
        "params": nparams, "batch": [sz.moe_train_batch, sz.moe_train_seq],
        "per_leaf_rel": per_leaf, "tolerance_rel": MOE_BF16_GRAD_REL,
        "sf_grads_repeat_bitwise": trees_equal(grads["sf"],
                                               grads["sf_again"])}
    print("TRAIN_PART moe_model_bf16 " + json.dumps(out["model_bf16"]),
          file=sys.stderr, flush=True)
    for nm, r in per_leaf.items():
        check(r["sf_vs_f32"] <= max(MOE_BF16_GRAD_REL,
                                    2 * r["dense_vs_f32"]),
              f"moe bf16 grad {nm}: the SF dispatch {r['sf_vs_f32']} from "
              f"float32, the dense {r['dense_vs_f32']}")
    del grads, leaves
    gc.collect()
    # (c) the transpose at the combine's shape, twice
    G = sz.moe_train_batch
    T_, k, E = sz.moe_train_seq, cfg.moe_topk, cfg.moe_experts
    C = max(int(np.ceil(T_ * k * cfg.moe_capacity / E)), 1)
    nroots, nleaves = G * E * C, G * T_ * k
    gen = torch.Generator(device=dev).manual_seed(5)
    lr = dyn_routing(nroots, nleaves, gen, dev)
    root = torch.randn(nroots, cfg.d_model, generator=gen, device=dev) \
        .bfloat16().requires_grad_()
    cot = torch.randn(nleaves, cfg.d_model, generator=gen, device=dev) \
        .bfloat16()
    plan = DynPlan(nroots, nleaves)
    tr = [torch.autograd.grad(plan.bcast(root, lr), root, cot)[0]
          for _ in range(2)]
    check(same_raw_bits(tr[0], tr[1]), "the DynPlan transpose changed "
          "between runs")
    out["transpose"] = {"roots": nroots, "leaves": nleaves,
                        "bitwise_repeat": True}
    # (d) training steps
    ocfg = OptConfig(lr=1e-4, warmup_steps=1, decay_steps=1000)
    state = {"p": params, "o": init_opt_state(params, ocfg)}
    del params
    step = make_train_step(cfg, ocfg, donate=True)
    steps = []
    for i in range(sz.moe_train_steps):
        def one(i=i):
            state["p"], state["o"], m = step(state["p"], state["o"],
                                             ds.batch_at(i))
            return float(m["loss"])
        (loss, host, devms), _ = counted(lambda: step_timed(one, dev), acc)
        check(math.isfinite(loss), f"moe step {i}: loss {loss}")
        steps.append({"loss": loss, "host_ms": host, "device_ms": devms})
    out.update(steps=steps, peak_gb=peak_gb(dev),
               tokens_per_s=sz.moe_train_batch * sz.moe_train_seq
               / float(np.mean([s["host_ms"] for s in steps[1:] or steps]))
               * 1e3)
    del state
    return out


# hymba's scan Function against autograd through the eager step loop,
# float32: per leaf (Δ, u, B, C, A, h0) max|d| <= SCAN_GRAD_REL x max|want|
SCAN_GRAD_REL = 1e-5
TRAIN_FAMILIES = ("hymba-1.5b", "xlstm-350m", "whisper-base")


def plain_scan(delta, u, Bc, Cc, A, h):
    """The SSM recurrence as out-of-place torch ops, one step at a time, no
    graph (autograd sees every step): Δ (B, S, Hm, 1), u (B, S, Hm, hd),
    B / C (B, S, Hm, N), A (Hm, N), h (B, Hm, hd, N) -> (ys (S, B, Hm, hd,
    1), h after S steps)."""
    import torch
    ys = []
    for t in range(delta.shape[1]):
        dec = torch.exp(A[None] * delta[:, t])[:, :, None, :]
        h = h * dec + (delta[:, t][..., None] * u[:, t].float()[..., None]) \
            * Bc[:, t][:, :, None, :]
        ys.append(torch.einsum("bhdn,bhn->bhd", h, Cc[:, t]))
    return torch.stack(ys, 0)[..., None], h


def train_scan_check(sz: Sizes, dev) -> dict:
    """hymba's scan Function at one layer of hymba-1.5b in float32 over
    ``sz.scan_check`` (B, S): S = 600 crosses two 256-step chunk boundaries
    and ends mid-chunk.  Its forward (through ``ssm_scan`` under grad)
    bitwise the inference ``ssm_scan``; its gradients in Δ, u, B, C, A and
    h0 against autograd through :func:`plain_scan` within SCAN_GRAD_REL;
    the graphs it replays; its forward and backward ms beside the flash
    Function's at the same layer (bf16, the 2,048-key window)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import ssm as S
    cfg = train_config("hymba-1.5b", sz).scaled(dtype="float32")
    B, L = sz.scan_check
    Hm, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
    g = torch.Generator(device=dev).manual_seed(600)

    def normal(shape, std, dtype=None):
        return torch.randn(shape, generator=g, device=dev).mul_(std) \
            .to(dtype or torch.float32)
    p = {k: v[0] for k, v in S.init_ssm(normal, cfg, 1, dev).items()}
    x = torch.randn(B, L, cfg.d_model, generator=g, device=dev)
    h0 = torch.randn(B, Hm, hd, N, generator=g, device=dev) * 0.1
    with torch.no_grad():
        y_inf, h_inf = S.ssm_scan(x, p, cfg, h0=h0)
    y, h = S.ssm_scan(x.clone().requires_grad_(), p, cfg, h0=h0)
    check(h.grad_fn is not None and "SelectiveScan"
          in type(h.grad_fn).__name__, "ssm_scan under grad took no "
          "_SelectiveScan")
    check(same_raw_bits(y.detach(), y_inf) and same_raw_bits(h.detach(),
                                                             h_inf),
          "ssm_scan under grad is not bitwise the inference ssm_scan")
    del y, h
    with torch.no_grad():
        u = (x @ p["in_proj"]).reshape(B, L, Hm, hd)
        delta, Bc, Cc, A = S._gates(u, p)
    ins = (delta, u, Bc, Cc, A, h0)
    cot = (torch.randn(L, B, Hm, hd, 1, generator=g, device=dev),
           torch.randn(B, Hm, hd, N, generator=g, device=dev))
    a = [t.detach().clone().requires_grad_() for t in ins]
    out = S._SelectiveScan.apply(*a, 256)
    got = torch.autograd.grad(out, a, cot, retain_graph=True)
    b = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(plain_scan(*b), b, cot)
    rel = {}
    for name, x1, x2 in zip(("delta", "u", "B", "C", "A", "h0"), got, want):
        rel[name] = max_abs(x1, x2) / float(x2.abs().max())
        check(rel[name] <= SCAN_GRAD_REL, f"scan gradient {name}: max|d| "
              f"{rel[name]} of max|want|, over {SCAN_GRAD_REL}")
    kinds = sorted({k[0] for k in S._GRAPHS if k[-1] == str(dev)})
    check(dev.type != "cuda" or kinds == ["_ChunkBackGraph", "_ChunkGraph"],
          f"the scan replayed graphs {kinds}")
    it = max(sz.timing_iters // 4, 2)
    rec = {"batch": B, "seq": L, "heads": [Hm, hd, N], "time_chunk": 256,
           "rel_err": rel, "tolerance_rel": SCAN_GRAD_REL,
           "forward_bitwise_inference": True, "graphs": kinds,
           "graph_bytes": sum(v.nbytes for k, v in S._GRAPHS.items()
                              if k[-1] == str(dev)),
           "forward_ms": call_ms(lambda: S._SelectiveScan.apply(*a, 256),
                                 dev, it),
           "backward_ms": call_ms(lambda: torch.autograd.grad(
               out, a, cot, retain_graph=True), dev, it),
           "plain_forward_backward_ms": call_ms(lambda: torch.autograd.grad(
               plain_scan(*b), b, cot), dev, 1)}
    del out, got, want
    fq = torch.randn(B, L, cfg.n_heads, hd, generator=g, device=dev) \
        .bfloat16().requires_grad_()
    fk, fv = (torch.randn(B, L, cfg.n_kv_heads, hd, generator=g, device=dev)
              .bfloat16().requires_grad_() for _ in range(2))
    fgo = torch.randn(B, L, cfg.n_heads, hd, generator=g, device=dev) \
        .bfloat16()
    W = cfg.attn_window
    fy = kops.flash_attention(fq, fk, fv, causal=True, window=W)
    rec["flash_same_layer"] = {
        "q": [B, L, cfg.n_heads, hd], "kv_heads": cfg.n_kv_heads,
        "window": W, "dtype": "bfloat16",
        "forward_ms": call_ms(lambda: kops.flash_attention(
            fq, fk, fv, causal=True, window=W), dev, it),
        "backward_ms": call_ms(lambda: torch.autograd.grad(
            fy, (fq, fk, fv), fgo, retain_graph=True), dev, it)}
    return rec


@contextlib.contextmanager
def timed_function(cls, dev, spans: dict):
    """Within the block each call of the autograd Function ``cls``'s
    forward and backward runs between CUDA events (the host clock on the
    CPU); ``spans["forward"]`` / ``spans["backward"]`` collect them for
    :func:`spans_ms`."""
    import torch
    real = {k: cls.__dict__[k] for k in ("forward", "backward")}

    def timed(fn, kind):
        def run(*args):
            if dev.type != "cuda":
                t0 = time.perf_counter()
                res = fn(*args)
                spans[kind].append((time.perf_counter() - t0) * 1e3)
                return res
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = fn(*args)
            ev[1].record()
            spans[kind].append(ev)
            return res
        return staticmethod(run)
    for kind, fn in real.items():
        spans.setdefault(kind, [])
        setattr(cls, kind, timed(fn.__func__, kind))
    try:
        yield
    finally:
        for kind, fn in real.items():
            setattr(cls, kind, fn)


@contextlib.contextmanager
def attention_backward_audit(rec: dict):
    """Within the block ``flash_attention_plain`` raises on a CUDA tensor
    (nothing on the card's training path may take the plain attention),
    and every ``FlashAttention.backward`` call on CUDA tensors must launch
    the backward kernels once: ``rec["backward_calls"]`` counts the calls
    and ``rec["backward_calls_not_one_launch"]`` those that did not.
    ``rec["shapes"]`` lists each distinct :func:`flash_shape_key` of the
    calls with its count, the shapes the path gives the kernels."""
    from repro_torch.kernels import flash_attention as fa
    rec.setdefault("backward_calls", 0)
    rec.setdefault("backward_calls_not_one_launch", 0)
    rec.setdefault("shapes", [])
    real_plain = fa.flash_attention_plain
    real_backward = fa.FlashAttention.__dict__["backward"]

    def plain(q, *args, **kwargs):
        if q.is_cuda:
            raise RuntimeError("flash_attention_plain ran on a CUDA tensor "
                               "on the training path")
        return real_plain(q, *args, **kwargs)

    def backward(ctx, *grads):
        before = fa.flash_attention_backward.launches
        res = real_backward.__func__(ctx, *grads)
        if grads[0].is_cuda:
            rec["backward_calls"] += 1
            rec["backward_calls_not_one_launch"] += \
                fa.flash_attention_backward.launches != before + 1
        # q's shape is the output gradient's, k's that of dk or dv (the
        # saved tensors unpack once under checkpointing)
        k = res[1] if res[1] is not None else res[2]
        key = flash_shape_key(grads[0], k, *ctx.mask)
        for e in rec["shapes"]:
            if e["key"] == key:
                e["calls"] += 1
                break
        else:
            rec["shapes"].append({"key": key, "calls": 1})
        return res
    fa.flash_attention_plain = plain
    fa.FlashAttention.backward = staticmethod(backward)
    try:
        yield
    finally:
        fa.flash_attention_plain = real_plain
        fa.FlashAttention.backward = real_backward


def audit_check(rec: dict, where: str, dev) -> None:
    """:func:`attention_backward_audit`'s record: on the card some
    backward ran and each launched the kernels once."""
    check(dev.type != "cuda" or (rec["backward_calls"] > 0 and
                                 not rec["backward_calls_not_one_launch"]),
          f"{where}: {rec['backward_calls_not_one_launch']} of "
          f"{rec['backward_calls']} FlashAttention.backward calls did not "
          f"launch the backward kernels once")


def spans_ms(spans: list) -> float:
    """The summed ms of :func:`timed_function`'s spans (after a sync)."""
    return float(sum(s if isinstance(s, float) else s[0].elapsed_time(s[1])
                     for s in spans))


def train_xlstm_check(sz: Sizes, dev) -> dict:
    """One xlstm-350m pair at full width in float32 over ``sz.xlstm_check``
    (B, S) steps under grad (S = 300: chunks of 128, 128 and 44): the
    chunk graphs' outputs, state and gradients bitwise the eager chunks'
    (the same operations launched one by one), and each way's forward +
    backward ms."""
    import torch
    from repro_torch.models import xlstm as X
    cfg = train_config("xlstm-350m", sz).scaled(dtype="float32")
    B, L = sz.xlstm_check_train
    g = torch.Generator(device=dev).manual_seed(L)

    def normal(shape, std, dtype=None):
        return torch.randn(shape, generator=g, device=dev).mul_(std) \
            .to(dtype or torch.float32)
    pp = {k: v[0] for k, v in X.init_xlstm_pair(normal, cfg, 1, dev).items()}
    names = sorted(pp)
    x = torch.randn(B, L, cfg.d_model, generator=g, device=dev) * 0.5
    leaves = [x.requires_grad_()] + [pp[k].requires_grad_() for k in names]

    def fwd_bwd():
        y, st = X.xlstm_pair_scan(leaves[0], dict(zip(names, leaves[1:])),
                                  cfg, X.init_xlstm_state(cfg, B, dev))
        loss = y.square().sum() + sum(v.sum() for v in st.values())
        return [y.detach(), *(v.detach() for v in st.values()),
                *torch.autograd.grad(loss, leaves)]
    real = X._use_graphs
    try:
        X._use_graphs = lambda d: False          # the eager chunks
        want = fwd_bwd()
        eager_ms = call_ms(fwd_bwd, dev, 1)
    finally:
        X._use_graphs = real
    got = fwd_bwd()
    check(dev.type != "cuda" or any(k[3] == str(x.device)
                                    for k in X._GRAPHS),
          "the xlstm chunks replayed no graph")
    check(all(same_raw_bits(a, b) for a, b in zip(got, want)),
          f"xlstm chunk graphs are not bitwise the eager chunks: max|d| "
          f"{[max_abs(a, b) for a, b in zip(got, want)]}")
    return {"batch": B, "seq": L, "chunk": X.TIME_CHUNK, "bitwise": True,
            "graphs": len(X._GRAPHS),
            "graph_forward_backward_ms": call_ms(fwd_bwd, dev, 2),
            "eager_forward_backward_ms": eager_ms}


def train_family(arch: str, sz: Sizes, dev, acc: dict) -> dict:
    """One family at its published width and depth, bf16, float32 moments,
    remat per block: the counted steps of ``make_train_step`` (parameters
    and state updated in place) on ``SyntheticLM`` batches (whisper's with
    bf16 frame embeddings), each timed on the host and between CUDA
    events, hymba's SSM scan timed inside them; a profiled step by kernel
    group; then steps on one batch at lr 1e-4, whose loss must fall.
    hymba's scan Function and xlstm's cell chunks run between CUDA events
    inside the counted steps (their share of the step's device time)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import ssm as S, transformer as T, xlstm as X
    from repro_torch.models.config import torch_dtype
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import batch_to, make_train_step
    shape, (n_steps, n_fixed) = {
        "hymba-1.5b": (sz.hymba_train, sz.hymba_train_steps),
        "xlstm-350m": (sz.xlstm_train, sz.xlstm_train_steps),
        "whisper-base": (sz.whisper_train, sz.whisper_train_steps)}[arch]
    B, L = shape[:2]
    frames = shape[2] if len(shape) > 2 else 0
    cfg = train_config(arch, sz, remat="block")
    dt = torch_dtype(cfg.dtype)
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    nparams = sum(t.numel() for t in tree_leaves_of(params))
    ocfg = OptConfig(warmup_steps=10, decay_steps=100)
    state = {"p": params, "o": init_opt_state(params, ocfg)}
    del params
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, ocfg, donate=True)
    ds = SyntheticLM(cfg.vocab, L, B, seed=0)

    def batch(i):
        b = batch_to(ds.batch_at(i), dev)
        if frames:
            gen = torch.Generator(device=dev).manual_seed(i)
            b["enc_embeds"] = (torch.randn(B, frames, cfg.d_model,
                                           generator=gen, device=dev)
                               * 0.02).to(dt)
        return b

    def one(b):
        state["p"], state["o"], m = step(state["p"], state["o"], b)
        return float(m["loss"])

    steps, counts, stage = [], {}, {}
    t1 = time.perf_counter()
    for i in range(n_steps):
        b = batch(i)
        spans = {"scan": {}, "cells": {}}
        with timed_function(S._SelectiveScan, dev, spans["scan"]), \
                timed_function(X._CellChunk, dev, spans["cells"]):
            (loss, host, devms), _ = counted(
                lambda: step_timed(lambda: one(b), dev), counts)
        check(math.isfinite(loss), f"{arch} step {i}: loss {loss}")
        rec = {"loss": loss, "host_ms": host, "device_ms": devms}
        for name, sp in spans.items():
            if sp["forward"]:
                rec[f"{name}_ms"] = [spans_ms(sp["forward"]),
                                     spans_ms(sp["backward"])]
                rec[f"{name}_calls"] = [len(sp["forward"]),
                                        len(sp["backward"])]
        steps.append(rec)
    stage["steps_s"] = time.perf_counter() - t1
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v
    want = ([] if cfg.block_kind == "xlstm" else
            ["flash_attention", "flash_attention_backward"]) + [PACK, SEGRED]
    missing = missing_kernels(tuple(want), counts)
    check(not missing or dev.type != "cuda", f"{arch}'s steps never "
          f"launched {missing}")
    t1 = time.perf_counter()
    window = profiled_groups(lambda: one(batch(n_steps)), dev,
                             profiled_kernels)
    stage["profiled_step_s"] = time.perf_counter() - t1
    warm = steps[1:] or steps
    host = float(np.mean([s["host_ms"] for s in warm]))
    devms = float(np.mean([s["device_ms"] for s in warm]))
    out = {"arch": cfg.name, "layers": [cfg.enc_layers, cfg.n_layers]
           if cfg.enc_layers else cfg.n_layers, "d_model": cfg.d_model,
           "params": nparams, "dtype": cfg.dtype, "moments": "float32",
           "remat": cfg.remat, "batch": list(shape), "init_s": init_s,
           "steps": steps, "step_host_ms": host, "step_device_ms": devms,
           "tokens_per_s": B * L / host * 1e3, "peak_gb": peak_gb(dev),
           "launches": counts, "profiled_step": window, "stage_s": stage}
    # the recurrence's share: hymba's scan Function, xlstm's cell chunks
    # (forward, remat recompute and backward, between CUDA events)
    for name in ("scan", "cells"):
        if f"{name}_ms" in warm[0]:
            ms = float(np.mean([sum(s[f"{name}_ms"]) for s in warm]))
            out[f"{name}_ms_per_step"] = ms
            out[f"{name}_share_of_step_device_ms"] = ms / devms
    print(f"TRAIN_PART {arch}_steps " + json.dumps(out), file=sys.stderr,
          flush=True)
    # the same parameters on one fixed batch at lr 1e-4: the loss falls
    state["o"] = None
    gc.collect()
    ocfg2 = OptConfig(lr=1e-4, warmup_steps=1, decay_steps=1000)
    state["o"] = init_opt_state(state["p"], ocfg2)
    step = make_train_step(cfg, ocfg2, donate=True)
    fixed = batch(10_000)
    t1 = time.perf_counter()
    losses = [one(fixed) for _ in range(n_fixed)]
    stage["fixed_steps_s"] = time.perf_counter() - t1
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{arch}: {n_fixed} steps on one batch at lr 1e-4: losses "
          f"{losses}")
    out["fixed_batch"] = {"lr": 1e-4, "losses": losses}
    del state
    kops.reset_launch_counts()
    return out


def phase_train(sz: Sizes, dev):
    """The training path: the flash Function's backward, qwen3-4b trained
    at full size, the DDP step over the allreduce SF, phi3.5-moe trained
    at full width, hymba's scan Function and whisper's cross shape
    checked, then hymba, xlstm and whisper trained at full size
    (``train_families``); each freed before the next.  Returns (record,
    launches): the counted drives' launches summed, the train path."""
    import torch
    t0 = time.perf_counter()
    out, acc = {"phase": "train"}, {}
    parts = [("flash_backward", lambda: train_flash_backward(sz, dev)),
             ("dense", lambda: train_dense(sz, dev, acc)),
             ("ddp", lambda: train_ddp(sz, dev, acc)),
             ("moe", lambda: train_moe(sz, dev, acc)),
             ("scan_check", lambda: train_scan_check(sz, dev)),
             ("xlstm_check", lambda: train_xlstm_check(sz, dev)),
             ("flash_cross", lambda: train_flash_cross(sz, dev))]
    parts += [(arch.split("-")[0], lambda arch=arch: train_family(
        arch, sz, dev, acc)) for arch in TRAIN_FAMILIES]
    # row 8's backward checked, and row 5's calls timed, at the shapes the
    # path gave them, at the end
    segreds, audit = [], {}
    parts.append(("flash_path_shapes",
                  lambda: train_flash_path_shapes(audit, sz, dev)))
    parts.append(("segred_shapes",
                  lambda: train_segred_shapes(segreds, sz, dev)))
    for name, part in parts:
        t1 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        if name == "segred_shapes":
            res = part()
        elif name.startswith("flash_"):
            # the checks compute the plain attention on the card
            with recorded_segreds(segreds, name):
                res = part()
        else:
            with recorded_segreds(segreds, name), \
                    attention_backward_audit(audit):
                res = part()
        out[name] = res if isinstance(res, dict) else {"shapes": res}
        out[name]["seconds"] = time.perf_counter() - t1
        print(f"TRAIN_PART {name} " + json.dumps(out[name]),
              file=sys.stderr, flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    audit_check(audit, "the train phase", dev)
    out["attention_backward_audit"] = audit
    out["seconds"] = time.perf_counter() - t0
    from repro_torch.kernels import ops as kops
    launches = {k: acc.get(k, 0) for k in kops.launch_counts()}
    out["launches"] = launches
    return out, launches


def train_segred_shapes(log: list, sz: Sizes, dev) -> dict:
    """Row 5 at each distinct shape the train path launched it at
    (``recorded_segreds``), on seeded buffers with the path's own (first,
    length) metadata: ``segred_record`` for each runtime-routed call (the
    token lookups' and the MoE dispatch's transposes: ``zeros().index_add_``
    as the library call) and, at qwen3-4b's token transpose,
    ``dynplan._transpose_sum``'s call ms and the device ms of its three
    full-vocabulary passes beside the kernel (``new_zeros``, the combine,
    ``where``).  The DDP buckets are listed (``ddp.bucket`` times the one
    nearest the budget)."""
    import torch
    from repro_torch.core import dynplan
    from repro_torch.kernels import sf_unpack
    g = torch.Generator(device=dev).manual_seed(28)
    out = {"calls": len(log), "buckets": [], "shapes": []}
    seen = set()
    for e in log:
        first = torch.as_tensor(e["first"], device=dev).to(torch.int32)
        length = torch.as_tensor(e["length"], device=dev).to(torch.int32)
        S = first.numel()
        key = (e["shape"], str(e["dtype"]), e["op"], e["dynamic"], S)
        if key in seen:
            continue
        seen.add(key)
        if not e["dynamic"]:
            out["buckets"].append({"part": e["part"],
                                   "shape": list(e["shape"]),
                                   "dtype": str(e["dtype"])[6:],
                                   "segments": S})
            continue
        check(e["op"] == "sum", f"a train-path row-5 call of op {e['op']}")
        ln64 = length.long()
        n = int(ln64.sum())
        check(torch.equal(first.long(), torch.cumsum(ln64, 0) - ln64),
              "a transpose's segments are not consecutive from row 0")
        unit = tuple(e["shape"][1:])
        buf = torch.randn(e["shape"], generator=g, device=dev).to(
            e["dtype"])
        seg_ids = torch.repeat_interleave(torch.arange(S, device=dev), ln64,
                                          output_size=n)
        lib = lambda: torch.zeros((S,) + unit, dtype=buf.dtype,
                                  device=dev).index_add_(0, seg_ids, buf[:n])
        what = (f"{e['part']} transpose: {n} rows onto {S} x "
                f"{list(unit)} {str(buf.dtype)[6:]}")
        # index_add_'s bf16 atomics sum in another order: at a few hundred
        # rows a segment they part from the sequential fold by ~5% of the
        # largest sum; a row sent to the wrong segment moves it by ~100%
        rec = segred_record(what, buf, first, length, dev, sz.timing_iters,
                            lib, "torch.zeros().index_add_", lib_tol=0.25)
        rec["part"] = e["part"]
        check(rec["short_plan"]["route"] == "vector",
              f"{what}: the {rec['short_plan']['route']} kernel")
        if e["part"] == "dense" and "transpose_sum_call_ms" not in out:
            # qwen3-4b's token lookup: the whole transpose around the kernel
            rows = buf[:n]
            idx = seg_ids[torch.randperm(n, generator=g, device=dev)]
            want = torch.zeros((S,) + unit, dtype=buf.dtype,
                               device=dev).index_add_(0, idx, rows)
            got = dynplan._transpose_sum(rows, idx, S)
            check(max_abs(got, want) <= 0.25 * float(want.abs().max()),
                  "_transpose_sum disagrees with index_add_")
            seg = sf_unpack.segment_reduce_sorted(buf, first, length)
            mask = (length > 0).reshape((-1,) + (1,) * len(unit))

            def passes():
                zeros = rows.new_zeros((S,) + unit)
                return torch.where(mask, torch.add(zeros, seg), zeros)
            rec["transpose_sum_call_ms"] = call_ms(
                lambda: dynplan._transpose_sum(rows, idx, S), dev,
                sz.timing_iters)
            rec["transpose_extra_passes_ms"] = graph_ms(passes, dev,
                                                        sz.timing_iters)
            out["transpose_sum_call_ms"] = rec["transpose_sum_call_ms"]
            del got, want, seg, rows, idx
        out["shapes"].append(rec)
        del buf, seg_ids
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def train_child(device: str, smoke: bool) -> int:
    """``chip_smoke.py --train DEVICE [smoke]``: :func:`phase_train` in
    this process (the kernels built already), its record and launches
    printed as one ``TRAIN_RESULT`` JSON line."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.kernels import _build
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.build_all()          # loads the parent's build
        dev = torch.device("cuda", torch.cuda.current_device())
    sz = Sizes(**TRAIN_SMOKE) if smoke else Sizes()
    res, launches = phase_train(sz, dev)
    print("TRAIN_RESULT " + json.dumps({"record": res,
                                        "launches": launches}), flush=True)
    return 0


def train_in_child(sz: Sizes, dev):
    """(record, launches) of the ``train`` phase, run by
    :func:`train_child` in a process of its own (the card's memory whole
    for a 4.41 B-parameter model and its float32 moments); fails if the
    child does."""
    cmd = [sys.executable, os.path.abspath(__file__), "--train",
           dev.type] + (["smoke"] if sz.train_smoke else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("TRAIN_RESULT ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"the train phase's child exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    out = json.loads(lines[0][len("TRAIN_RESULT "):])
    return out["record"], out["launches"]


# ----------------------------------------------------------------- launch
# rows 1, 2, 5 and 8: the token lookup and the MoE dispatch's gathers
# (hidden-state rows, the weight column), their transposes in the
# backward, attention and its backward
LAUNCH_PATH = ("flash_attention", "flash_attention_backward", "pack",
               "pack_blocked", SEGRED)
LAUNCH_SMOKE = dict(launch_smoke=True, launch_batch=2, launch_seq=32,
                    launch_steps=2, launch_check_layers=2,
                    launch_cells=("qwen3-4b", "hymba-1.5b"),
                    launch_shapes=("decode_32k", "long_500k"),
                    launch_dryrun_jobs=2, launch_family_steps=2,
                    timing_iters=2)
# the dry run's prediction of the card's step at world 1: FLOPs exactly
# (the same ops at the same shapes); peak memory within this share of the
# card's max_memory_allocated (the caching allocator rounds each block up
# and keeps cuBLAS's workspace, which the count does not model)
LAUNCH_PEAK_REL = 0.15
LAUNCH_CARD_SHAPE = "launch_card"


def launch_config(sz: Sizes, **scaled):
    """``launch_arch``'s published config (its smoke config with
    ``launch_smoke``), scaled by ``scaled``."""
    from repro_torch.configs import get_config
    cfg = get_config(sz.launch_arch)
    return (cfg.smoke_config() if sz.launch_smoke else cfg).scaled(**scaled)


def launch_batches(cfg, sz: Sizes, steps: int) -> list:
    """The launcher's data stream (``training.data.make_batch``), steps
    0 .. steps - 1."""
    from repro_torch.training.data import make_batch
    return [make_batch(cfg, sz.launch_batch, sz.launch_seq, step=i)
            for i in range(steps)]


def launch_full(sz: Sizes, dev, mesh, acc: dict) -> dict:
    """qwen3-4b at full size through the launcher's path
    (``launch.train.sharded_state`` + ``make_train_step(param_shardings=)``)
    on the (1, 1) mesh: ``launch_steps`` counted steps of ``launch_batch`` x
    ``launch_seq`` tokens, step ms on the host and between CUDA events,
    tokens/s, peak memory, a profiled step's idle share."""
    import torch
    from repro_torch.launch.train import sharded_state
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import make_train_step
    cfg = launch_config(sz, remat="block")
    ocfg = OptConfig(warmup_steps=10, decay_steps=max(sz.launch_steps, 100))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, opt, psh, _ = sharded_state(cfg, ocfg, mesh, dev)
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, ocfg, donate=True, param_shardings=psh)
    state = {"p": params, "o": opt}
    del params, opt
    batches = launch_batches(cfg, sz, sz.launch_steps + 1)

    def one(i):
        state["p"], state["o"], m = step(state["p"], state["o"], batches[i])
        return float(m["loss"])

    steps = []
    for i in range(sz.launch_steps):
        (loss, host, devms), _ = counted(
            lambda: step_timed(lambda: one(i), dev), acc)
        check(math.isfinite(loss), f"launch step {i}: loss {loss}")
        steps.append({"loss": loss, "host_ms": host, "device_ms": devms})
    window = profiled_groups(lambda: one(sz.launch_steps), dev)
    warm = steps[1:] or steps
    host = float(np.mean([s["host_ms"] for s in warm]))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "moments": "float32", "remat": cfg.remat,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "placements": {"embed": str(state["p"]["embed"].placements),
                          "wq": str(state["p"]["blocks"]["wq"].placements)},
           "batch": [sz.launch_batch, sz.launch_seq], "init_s": init_s,
           "steps": steps, "step_host_ms": host,
           "step_device_ms": float(np.mean([s["device_ms"] for s in warm])),
           "tokens_per_s": sz.launch_batch * sz.launch_seq / host * 1e3,
           "peak_gb": peak_gb(dev), "profiled_step": window}
    del state
    return out


def tree_local(tree):
    """A tree of DTensors as their local shards."""
    return tree_map_of(lambda t: t.to_local() if hasattr(t, "to_local")
                       else t, tree)


def launch_bitwise(sz: Sizes, dev, mesh, acc: dict) -> dict:
    """qwen3-4b at full width, ``launch_check_layers`` layers: one step
    through the mesh path against ``make_train_step`` without a mesh from
    the same parameters, bitwise in the loss and every parameter and
    moment; then both steps timed in turns (plain, mesh, mesh, plain: the
    DTensor layer's cost), the mesh step counted with its peak memory
    (``max_memory_allocated``, the plain state freed) and FlopCounterMode's
    count of both steps."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.train import sharded_state
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    cfg = launch_config(sz, n_layers=sz.launch_check_layers, remat="block")
    ocfg = OptConfig(warmup_steps=10, decay_steps=100)
    mp, mo, psh, _ = sharded_state(cfg, ocfg, mesh, dev)
    pp = T.init_params(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
    po = init_opt_state(pp, ocfg)
    same_start = all(same_bits(a, b) for a, b in zip(
        tree_leaves_of(tree_local(mp)), tree_leaves_of(pp)))
    check(same_start, "the mesh path's parameters differ from "
          "init_params's before the step")
    plain = make_train_step(cfg, ocfg, donate=True)
    meshed = make_train_step(cfg, ocfg, donate=True, param_shardings=psh)
    batches = launch_batches(cfg, sz, 6)
    pp, po, pm = plain(pp, po, batches[0])
    (mp, mo, mm), _ = counted(lambda: meshed(mp, mo, batches[0]), acc)
    names = leaf_names(pp)
    diff = [n for n, a, b in zip(names, tree_leaves_of(tree_local(mp)),
                                 tree_leaves_of(pp)) if not same_bits(a, b)]
    mdiff = [n for n, a, b in zip(
        leaf_names(po["m"]) + leaf_names(po["v"]),
        tree_leaves_of(tree_local(mo["m"])) + tree_leaves_of(
            tree_local(mo["v"])),
        tree_leaves_of(po["m"]) + tree_leaves_of(po["v"]))
        if not same_bits(a, b)]
    loss_same = same_bits(mm["loss"], pm["loss"])
    check(loss_same and not diff and not mdiff,
          f"the mesh step is not bitwise make_train_step: loss "
          f"{float(mm['loss'])} vs {float(pm['loss'])}, parameters "
          f"{diff[:5]}, moments {mdiff[:5]}")
    out = {"layers": cfg.n_layers, "loss": float(pm["loss"]),
           "bitwise": {"loss": loss_same, "params": len(names),
                       "params_differing": diff, "moments_differing": mdiff}}
    st = {"pp": pp, "po": po, "mp": mp, "mo": mo}
    del pp, po, mp, mo

    def run_plain(i):
        st["pp"], st["po"], m = plain(st["pp"], st["po"], batches[i])
        return m

    def run_mesh(i):
        st["mp"], st["mo"], m = meshed(st["mp"], st["mo"], batches[i])
        return m
    turns = []
    for i, (kind, fn) in enumerate((("plain", run_plain),
                                    ("mesh", run_mesh),
                                    ("mesh", run_mesh),
                                    ("plain", run_plain))):
        _, host, devms = step_timed(lambda: fn(1 + i // 2), dev)
        turns.append({"path": kind, "host_ms": host, "device_ms": devms})
    with FlopCounterMode(display=False) as fc:
        run_plain(3)
    plain_flops = fc.get_total_flops()
    del st["pp"], st["po"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    (_, host, devms), _ = counted(
        lambda: step_timed(lambda: run_mesh(4), dev), acc)
    card_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    with FlopCounterMode(display=False) as fc:
        run_mesh(5)
    mean = {k: float(np.mean([t["host_ms"] for t in turns
                              if t["path"] == k])) for k in ("plain", "mesh")}
    out.update({
        "turns": turns, "plain_step_ms": mean["plain"],
        "mesh_step_ms": mean["mesh"],
        "dtensor_overhead_ms": mean["mesh"] - mean["plain"],
        "mesh_counted_step": {"host_ms": host, "device_ms": devms},
        "card_flops_mesh": fc.get_total_flops(),
        "card_flops_plain": plain_flops,
        "card_peak_bytes": card_peak, "resident_before_bytes": base})
    del st
    return out


def launch_family_shape(arch: str, sz: Sizes) -> tuple:
    """(batch, tokens, encoder frames or 0, layers or None for the
    published depth) of ``arch``'s timed steps: the train phase's."""
    if sz.launch_smoke:
        return 2, 32, 24 if arch == "whisper-base" else 0, None
    return {"phi3.5-moe-42b-a6.6b": (sz.moe_train_batch, sz.moe_train_seq,
                                     0, sz.moe_train_layers),
            "hymba-1.5b": sz.hymba_train + (0, None),
            "xlstm-350m": sz.xlstm_train + (0, None),
            "whisper-base": sz.whisper_train + (None,)}[arch]


def launch_family(arch: str, sz: Sizes, dev, mesh, acc: dict) -> dict:
    """``arch`` through the launcher's sharded path on the (1, 1) mesh:
    (a) at ``launch_family_check_layers`` layers one mesh step against
    ``make_train_step`` from the same parameters on the same batch,
    bitwise in the loss and every parameter and moment; (b) at the train
    phase's sizes (:func:`launch_family_shape`) ``launch_family_steps``
    counted steps, each timed on the host and between CUDA events,
    tokens/s, peak memory and a profiled step's idle share.  bf16, float32
    moments, remat per block."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import sharded_state
    from repro_torch.models import transformer as T
    from repro_torch.models.config import torch_dtype
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import batch_to, make_train_step
    B, L, frames, layers = launch_family_shape(arch, sz)
    base = get_config(arch)
    base = (base.smoke_config() if sz.launch_smoke else base).scaled(
        remat="block")
    dt = torch_dtype(base.dtype)
    ds = SyntheticLM(base.vocab, L, B, seed=0)

    def batch(i):
        b = batch_to(ds.batch_at(i), dev)
        if frames:
            gen = torch.Generator(device=dev).manual_seed(i)
            b["enc_embeds"] = (torch.randn(B, frames, base.d_model,
                                           generator=gen, device=dev)
                               * 0.02).to(dt)
        return b

    ocfg = OptConfig(warmup_steps=10, decay_steps=100)
    out = {"arch": base.name, "batch": [B, L] + ([frames] if frames else [])}
    # (a) bitwise at reduced depth (phi3.5-moe: one layer, so that two
    # full-width states and their moments fit the card together)
    t0 = time.perf_counter()
    cfg = base.scaled(n_layers=1 if base.is_moe
                      else sz.launch_family_check_layers)
    mp, mo, psh, _ = sharded_state(cfg, ocfg, mesh, dev)
    pp = T.init_params(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
    po = init_opt_state(pp, ocfg)
    plain = make_train_step(cfg, ocfg, donate=True)
    meshed = make_train_step(cfg, ocfg, donate=True, param_shardings=psh)
    b0 = batch(0)
    pp, po, pm = plain(pp, po, b0)
    (mp, mo, mm), _ = counted(lambda: meshed(mp, mo, b0), acc)
    names = leaf_names(pp)
    diff = [n for n, a, b in zip(names, tree_leaves_of(tree_local(mp)),
                                 tree_leaves_of(pp)) if not same_bits(a, b)]
    mdiff = [n for n, a, b in zip(
        leaf_names(po["m"]) + leaf_names(po["v"]),
        tree_leaves_of(tree_local(mo["m"])) + tree_leaves_of(
            tree_local(mo["v"])),
        tree_leaves_of(po["m"]) + tree_leaves_of(po["v"]))
        if not same_bits(a, b)]
    loss_same = same_bits(mm["loss"], pm["loss"])
    check(loss_same and not diff and not mdiff,
          f"{arch}: the mesh step is not bitwise make_train_step: loss "
          f"{float(mm['loss'])} vs {float(pm['loss'])}, parameters "
          f"{diff[:5]}, moments {mdiff[:5]}")
    out["bitwise"] = {"layers": cfg.n_layers, "loss": float(pm["loss"]),
                      "loss_same": loss_same, "params": len(names),
                      "params_differing": diff, "moments_differing": mdiff,
                      "seconds": time.perf_counter() - t0}
    del mp, mo, pp, po, plain, meshed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    # (b) the timed steps
    cfg = base if layers is None else base.scaled(n_layers=layers)
    t0 = time.perf_counter()
    params, opt, psh, _ = sharded_state(cfg, ocfg, mesh, dev)
    out["init_s"] = time.perf_counter() - t0
    step = make_train_step(cfg, ocfg, donate=True, param_shardings=psh)
    state = {"p": params, "o": opt}
    del params, opt

    def one(b):
        state["p"], state["o"], m = step(state["p"], state["o"], b)
        return float(m["loss"])

    steps, counts = [], {}
    for i in range(sz.launch_family_steps):
        b = batch(1 + i)
        (loss, host, devms), _ = counted(
            lambda: step_timed(lambda: one(b), dev), counts)
        check(math.isfinite(loss), f"{arch} mesh step {i}: loss {loss}")
        steps.append({"loss": loss, "host_ms": host, "device_ms": devms})
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v
    want = ["pack", SEGRED] + (["flash_attention", "flash_attention_backward"]
                               if cfg.block_kind != "xlstm" else []) + (
        ["pack_blocked"] if cfg.is_moe else [])
    missing = missing_kernels(tuple(want), counts)
    check(not missing or dev.type != "cuda",
          f"{arch}'s mesh steps never launched {missing}")
    bn = batch(1 + sz.launch_family_steps)
    window = profiled_groups(lambda: one(bn), dev, profiled_kernels)
    warm = steps[1:] or steps
    host = float(np.mean([s["host_ms"] for s in warm]))
    out.update({
        "layers": [cfg.enc_layers, cfg.n_layers] if cfg.enc_layers
        else cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "params": sum(t.numel() for t in tree_leaves_of(state["p"])),
        "placements": {n: str(t.placements) for n, t in zip(
            leaf_names(state["p"]), tree_leaves_of(state["p"]))
            if n.split("/")[-1] in ("w_in", "router", "in_proj", "m_wq",
                                    "wq")},
        "steps": steps, "step_host_ms": host,
        "step_device_ms": float(np.mean([s["device_ms"] for s in warm])),
        "tokens_per_s": B * L / host * 1e3, "peak_gb": peak_gb(dev),
        "launches": counts, "profiled_step": window})
    del state
    return out


def launch_dryrun_child(device: str, smoke: bool) -> int:
    """``chip_smoke.py --launch-dryrun DEVICE [smoke]``: the dry run of the
    bitwise check's cell (``launch_check_layers`` layers, ``launch_batch``
    x ``launch_seq``, one microbatch, float32 moments) under a fake group
    of one rank on a (1, 1) mesh, printed as one ``LAUNCH_DRYRUN`` JSON
    line."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import dataclasses as dc
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import CellOptions
    from repro_torch.launch.mesh import make_mesh
    sz = Sizes(**LAUNCH_SMOKE) if smoke else Sizes()
    configs.SHAPES[LAUNCH_CARD_SHAPE] = dict(
        seq_len=sz.launch_seq, global_batch=sz.launch_batch, kind="train")
    cfg = launch_config(sz, n_layers=sz.launch_check_layers)
    overrides = {k: v for k, v in dc.asdict(cfg).items()
                 if k not in ("name", "remat", "seq_shard")}
    dryrun.fake_group(1)
    mesh = make_mesh((1, 1), ("data", "model"), device_type=device)
    rec = dryrun.run_cell(sz.launch_arch, LAUNCH_CARD_SHAPE, mesh,
                          CellOptions(microbatches=1), overrides,
                          device=device)
    rec["cell"] = f"{sz.launch_arch}__{LAUNCH_CARD_SHAPE}__1x1"
    print("LAUNCH_DRYRUN " + json.dumps(rec), flush=True)
    return 0


def launch_dryrun_card(sz: Sizes, dev, bit: dict) -> dict:
    """The dry run of the bitwise check's cell at world 1 (a child
    process), beside the card's counts: FLOPs against FlopCounterMode's of
    the mesh step (equal), peak against ``max_memory_allocated`` (within
    ``LAUNCH_PEAK_REL``), and the roofline row built from ``HW`` beside
    the measured step."""
    from repro_torch.launch.roofline import roofline_row
    cmd = [sys.executable, os.path.abspath(__file__), "--launch-dryrun",
           dev.type] + (["smoke"] if sz.launch_smoke else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("LAUNCH_DRYRUN ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"the launch dry run's child exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    rec = json.loads(lines[0][len("LAUNCH_DRYRUN "):])
    pred_flops = rec["op_cost"]["flops"]
    pred_peak = rec["memory"]["peak_per_device"]
    card_flops = bit["card_flops_mesh"]
    card_peak = bit["card_peak_bytes"]
    check(pred_flops == card_flops,
          f"the dry run predicts {pred_flops} FLOPs, the card's step "
          f"counted {card_flops}")
    check(card_flops == bit["card_flops_plain"],
          f"the mesh step counted {card_flops} FLOPs, make_train_step "
          f"{bit['card_flops_plain']}")
    if dev.type == "cuda":
        check(abs(pred_peak / card_peak - 1) <= LAUNCH_PEAK_REL,
              f"the dry run predicts a peak of {pred_peak} bytes, the card "
              f"allocated {card_peak} at most")
    row = roofline_row(rec)
    step_s = bit["mesh_counted_step"]["device_ms"] / 1e3
    bound_s = max(row["compute_s"], row["memory_s"], row["collective_s"])
    return {"seconds": time.perf_counter() - t0, "cell": rec["cell"],
            "dryrun_s": {"lower": rec["lower_s"], "step": rec["step_s"]},
            "flops": {"dryrun": pred_flops, "card": card_flops,
                      "ratio": pred_flops / card_flops if card_flops
                      else None},
            "peak_bytes": {"dryrun": pred_peak, "card": card_peak,
                           "ratio": pred_peak / card_peak if card_peak
                           else None},
            "op_cost": rec["op_cost"],
            "roofline": row, "measured_step_s": step_s,
            "bound_over_measured": bound_s / step_s if step_s else None}


LAUNCH_DRYRUN_DIR = os.path.join(HERE, "reports", "torch_dryrun")


def launch_production_start(sz: Sizes, dev):
    """Start ``python -m repro_torch.launch.dryrun`` on the 16 x 16
    production mesh for ``launch_cells`` x ``launch_shapes`` (a child
    process, which runs the mesh in another; host work only, so it runs
    beside the card's parts of the phase), its records written under
    ``reports/torch_dryrun``.  Returns (the process, its start)."""
    os.makedirs(LAUNCH_DRYRUN_DIR, exist_ok=True)
    device = "cuda" if dev.type == "cuda" else "cpu"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           ",".join(sz.launch_cells), "--shape",
           ",".join(sz.launch_shapes), "--mesh", "single", "--out",
           LAUNCH_DRYRUN_DIR, "--device", device, "--force", "--jobs",
           str(sz.launch_dryrun_jobs)]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True), time.perf_counter()


def stop_group(proc) -> None:
    """Kill ``proc``'s process group (it and the children it started) if
    it still runs, and reap it."""
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()


def launch_production(sz: Sizes, dev, started) -> dict:
    """The production dry run's records (:func:`launch_production_start`):
    per cell the seconds, the peak GiB per device, ``fits80G`` and the
    collective counts, and the roofline rows; a cell skipped by design
    (``long_500k`` of a full-attention family) with its reason.  Every
    other cell must be ``ok``."""
    from repro_torch.launch.roofline import roofline_row
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=900)
    check(proc.returncode == 0,
          f"the production dry run exited {proc.returncode}: "
          f"{stdout[-3000:]}{stderr[-4000:]}")
    device = "cuda" if dev.type == "cuda" else "cpu"
    out_dir = LAUNCH_DRYRUN_DIR
    cells = []
    for arch in sz.launch_cells:
        for shape in sz.launch_shapes:
            path = os.path.join(out_dir, f"{arch}__{shape}__16x16.json")
            check(os.path.exists(path), f"the dry run wrote no {path}")
            with open(path) as f:
                rec = json.load(f)
            if rec["status"] == "skipped" and shape == "long_500k":
                cells.append({"cell": rec["cell"], "status": "skipped",
                              "reason": rec["reason"]})
                continue
            check(rec["status"] == "ok", f"{path}: {rec.get('status')}")
            row = roofline_row(rec)
            cells.append({
                "cell": rec["cell"], "status": "ok",
                "seconds": rec["lower_s"]
                + rec["step_s"], "depths_run": rec["depths_run"],
                "peak_gib": rec["memory"]["peak_per_device"] / 2 ** 30,
                "fits80G": rec["fits80G"],
                "collective_counts": rec["op_cost"]["collective_counts"],
                "collective_bytes": rec["op_cost"]["collective_bytes"],
                "flops_per_device": rec["op_cost"]["flops"],
                "roofline": {k: row[k] for k in (
                    "compute_s", "memory_s", "collective_s", "dominant",
                    "useful_frac", "roofline_frac")}})
    return {"seconds": time.perf_counter() - t0, "device": device,
            "out_dir": os.path.relpath(out_dir, HERE), "cells": cells}


def phase_launch(sz: Sizes, dev):
    """The launch path: qwen3-4b trained at full size through the
    launcher's sharded path on a (1, 1) mesh over an NCCL group of one rank
    (gloo on the CPU), the 4-layer mesh step bitwise ``make_train_step``,
    then phi3.5-moe, hymba, xlstm and whisper through the same path
    (:func:`launch_family`), the dry run against the card, the production
    mesh's dry run of every arch and shape (started first: host work,
    which runs beside the card's).  Returns (record, launches): the
    counted drives' launches, the launch path."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    out, acc, audit = {"phase": "launch"}, {}, {}
    production = launch_production_start(sz, dev)
    try:
        with world1_group(dev), attention_backward_audit(audit):
            mesh = make_mesh((1, 1), ("data", "model"),
                             device_type=dev.type)
            parts = [("full", lambda: launch_full(sz, dev, mesh, acc)),
                     ("bitwise", lambda: launch_bitwise(sz, dev, mesh,
                                                        acc))]
            parts += [(arch.split("-")[0], lambda arch=arch: launch_family(
                arch, sz, dev, mesh, acc)) for arch in sz.launch_families]
            for name, part in parts:
                t1 = time.perf_counter()
                out[name] = part()
                out[name]["seconds"] = time.perf_counter() - t1
                print(f"LAUNCH_PART {name} " + json.dumps(out[name]),
                      file=sys.stderr, flush=True)
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        out["dryrun_vs_card"] = launch_dryrun_card(sz, dev, out["bitwise"])
        out["production"] = launch_production(sz, dev, production)
    finally:
        stop_group(production[0])
    audit_check(audit, "the launch phase", dev)
    out["attention_backward_audit"] = audit
    out["seconds"] = time.perf_counter() - t0
    launches = {k: acc.get(k, 0) for k in kops.launch_counts()}
    out["launches"] = launches
    return out, launches


def launch_child(device: str, smoke: bool) -> int:
    """``chip_smoke.py --launch DEVICE [smoke]``: :func:`phase_launch` in
    this process (the kernels built already), its record and launches
    printed as one ``LAUNCH_RESULT`` JSON line."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.kernels import _build
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.build_all()          # loads the parent's build
        dev = torch.device("cuda", torch.cuda.current_device())
    sz = Sizes(**LAUNCH_SMOKE) if smoke else Sizes()
    res, launches = phase_launch(sz, dev)
    print("LAUNCH_RESULT " + json.dumps({"record": res,
                                         "launches": launches}), flush=True)
    return 0


def launch_in_child(sz: Sizes, dev):
    """(record, launches) of the ``launch`` phase, run by
    :func:`launch_child` in a process of its own (an NCCL group, and the
    card's memory whole for qwen3-4b's training state); fails if the child
    does."""
    cmd = [sys.executable, os.path.abspath(__file__), "--launch",
           dev.type] + (["smoke"] if sz.launch_smoke else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("LAUNCH_RESULT ")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"the launch phase's child exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    out = json.loads(lines[0][len("LAUNCH_RESULT "):])
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

    # measured backend selection: phase_priors zeroes the counters before
    # its sweeps; whatever they launched is the path's
    TUNING["path"] = "priors"
    pri = phase_priors(sz, dev)
    emit(pri)
    by_path["priors"] = pri["launches"]
    del pri
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
    # row 8 at kimi-k2's prefill shape: head size 112 on the wgmma kernel
    recs["flash_attention"]["kimi_shape"] = moe["kimi_serve"]["flash"]
    recs["flash_attention"]["kimi_buckets"] = \
        moe["kimi_serve"]["flash_buckets"]
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
    # the split route's row: whisper's cross-attention at decode
    split_shapes = [r for r in fam["whisper"]["flash"]
                    if r["route"] == "flash_attention_split"]
    check(split_shapes or not on_card, "no family shape took the split "
          "route")
    row = next((r for r in split_shapes if r["what"] ==
                "whisper cross-attention, decode"), None) or \
        (split_shapes or fam["whisper"]["flash"])[0]
    recs["flash_attention_split"] = {
        "name": "flash_attention_split", "route": "cuda",
        "source": SOURCES["flash_attention_split"],
        "replaces": REPLACES["flash_attention_split"], "launches": 0,
        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "prev_ms",
                               "prev_kernel", "lse_max_abs_err")},
        "kernels": ["flash_split_kernel", "flash_split_combine_kernel"],
        "shape": {k: row[k] for k in ("B", "Sq", "Skv", "H", "Hkv", "D")},
        "split_shapes": split_shapes,
        "ptxas": [{k: r[k] for k in ("function", "registers",
                                     "spill_stores", "smem_bytes")}
                  for r in flash_ptxas() if "split" in r["function"]]}
    del fam

    # the training path (flash backward, qwen3-4b trained, the DDP step,
    # phi3.5-moe trained, then hymba, xlstm and whisper trained) in a child
    # process with the card's memory to itself: its counted drives'
    # launches are the path's
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    train, by_path["train"] = train_in_child(sz, dev)
    emit(train)
    missing = missing_kernels(TRAIN_PATH, by_path["train"])
    check(not missing or not on_card, f"the train path never launched "
          f"{missing}")
    bwd = train["flash_backward"]["shapes"] + [train["flash_cross"]]
    path_bwd = train["flash_path_shapes"]
    recs["flash_attention_backward"] = {     # the row: qwen3-4b's heads
        "name": "flash_attention_backward", "route": "cuda",
        "source": SOURCES["flash_attention_backward"],
        "replaces": REPLACES["flash_attention_backward"], "launches": 0,
        **{k: bwd[0][k] for k in ("ms", "ms_cold_l2", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "library_call", "call_ms", "prev_ms")},
        "max_abs_err": max(r["max_abs_err"]
                           for r in bwd + path_bwd["shapes"]),
        "kernels": ["flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90",
                    "flash_bwd_dkdv_reduce"],
        "kernels_float32_and_d16_32": ["flash_bwd_dq", "flash_bwd_dkdv",
                                       "flash_bwd_dkdv_reduce"],
        "shapes": bwd,
        "path_shapes": path_bwd["shapes"],
        "audit": {"train": train["attention_backward_audit"]},
        "ptxas": [{k: r[k] for k in ("function", "registers",
                                     "spill_stores", "smem_bytes")}
                  for r in flash_ptxas() if r["source"] ==
                  "flash_attention_bwd"]}
    for name in SEGRED:
        recs[name]["ddp_bucket_shape"] = train["ddp"]["bucket"]
    recs["segment_reduce_sorted"]["train_shapes"] = \
        train["segred_shapes"]["shapes"]
    del train

    # the launch path (the sharded step through the launcher on a (1, 1)
    # mesh over an NCCL group of one rank, the dry run against the card,
    # the production mesh's dry run) in a child process: its counted
    # drives' launches are the path's
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    launch, by_path["launch"] = launch_in_child(sz, dev)
    emit(launch)
    recs["flash_attention_backward"]["audit"]["launch"] = \
        launch["attention_backward_audit"]
    checked = [r["key"] for r in path_bwd["shapes"]]
    unchecked = [e["key"] for e in launch["attention_backward_audit"]
                 ["shapes"] if e["key"] not in checked]
    check(not unchecked or not on_card, f"the launch path's flash "
          f"backward ran at shapes the train phase did not check: "
          f"{unchecked}")
    missing = missing_kernels(LAUNCH_PATH, by_path["launch"])
    check(not missing or not on_card, f"the launch path never launched "
          f"{missing}")
    del launch

    # the long segment reduce's sweep comes after the last profiled window:
    # its plain folds launch ~4 M small kernels, and after them torch.profiler
    # on the card returns windows without all their device events
    t0 = time.perf_counter()
    emit({"phase": "long_sweep",
          "cases": long_sweep(dev, np.random.default_rng(7)),
          "seconds": time.perf_counter() - t0})
    for name, rec in recs.items():
        rec["launches_by_path"] = {p: c.get(name, 0)
                                   for p, c in by_path.items()}
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
    if sys.argv[1:2] == ["--train"]:
        return train_child(sys.argv[2], sys.argv[3:4] == ["smoke"])
    if sys.argv[1:2] == ["--launch"]:
        return launch_child(sys.argv[2], sys.argv[3:4] == ["smoke"])
    if sys.argv[1:2] == ["--launch-dryrun"]:
        return launch_dryrun_child(sys.argv[2], sys.argv[3:4] == ["smoke"])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    # Every path but priors runs under the static selection rule that its
    # launch checks hold the hand kernels to: card-stamped
    # BENCH_torch_*.json at the root would move SFComm(backend=None)
    # exchanges to "global" wherever they measure plain torch faster.  The
    # priors phase points the variable at its own artifacts and puts this
    # back; the children inherit it.
    os.environ["REPRO_SF_PRIORS"] = "0"
    from repro_torch.kernels import _build
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    build_s = _build.build_all()
    # the parent's D = 64 forward (the families phase's prev_ms), built
    # while the first phases run
    PARENT_D64_BUILD["proc"] = start_parent_d64_build()
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
              if "long_" in r["function"]],
          "sf_unpack_short_ptxas": [
              r for r in _build.ptxas_report("sf_unpack")
              if "segment_reduce_" in r["function"]]})
    try:
        kernels = run(dev, Sizes())
    finally:
        # the background build, if no phase waited for it
        proc = PARENT_D64_BUILD.pop("proc", None)
        if proc is not None:
            proc.kill()
            proc.wait()
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
