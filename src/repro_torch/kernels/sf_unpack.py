"""SF unpack with reduction: the deterministic segment reduce — the Hopper
port of ``repro/kernels/sf_unpack.py``.

Paper §5.3 GPU unpacks need atomics when destinations repeat.  The
reference replaces them with a setup-time sort (DESIGN §3.3): the packed
buffer is ordered by destination, equal destinations form *segments*, a
segment reduction emits one row per segment, and one duplicate-free
scatter finishes the unpack.  ``csrc/sf_unpack.cu`` is that segment
reduction.  Every result is the fold of the segment's rows in buffer order
from the identity, the earlier operand first, so results are the same on
every run and equal to the plain version bit for bit (max / min keep the
first NaN with its payload, and of equal values the first, which decides
+-0).  Routes (:func:`reduce_route`): while no segment is longer than
``LONG_SEG`` rows, one thread per (segment, unit element) folds its rows
(with the unit cut into column tiles across CTAs when the segments are
too few to fill the card: a DDP bucket's one segment of ``grains`` rows);
otherwise the longer segments leave that kernel for the long route, planned
once per segment metadata (:func:`long_plan`): chunks of
``LONG_CHUNK_ROWS`` rows folded by separate CTAs and their partials in
chunk order where the fold's bits do not depend on the order (integers,
float max / min), else a CTA a segment folding its rows, staged through
shared memory, in buffer order (float sum / prod).  The source's note
gives the bounds and why the split fold is exact.

Entry points (each counts its launches in ``<function>.launches``):
  * ``segment_reduce_sorted``  — one segment per CTA;
  * ``segment_reduce_blocked`` — ``segs_per_block`` segments per CTA; zero-
                                 length segments emit the identity;
  * ``unpack_segments``        — segment reduce, then the duplicate-free
                                 scatter into ``target``.

Ops: sum, prod, max, min (max/min propagate NaN); dtypes float32, float64,
bfloat16, float16, int8, uint8, int16, int32, int64 (uint16 and uint32
payloads reach it as signed views or widened, ``core/ops.py``).  The
kernel reads only rows ``< len``, so the buffer needs no ``Lmax`` pad.  A
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import _build
from ._index import cached, device_index, require_cuda_tensor, \
    segment_meta

__all__ = ["segment_reduce_sorted", "segment_reduce_blocked",
           "unpack_segments", "segment_reduce_plain", "short_variant",
           "LONG_SEG", "LONG_CHUNK_ROWS", "LongPlan", "long_plan",
           "build_long_plan", "order_free", "reduce_route", "prepare"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                torch.bfloat16: 3, torch.int8: 4, torch.uint8: 5,
                torch.int16: 6, torch.int64: 7, torch.float16: 8}
_OP_CODES = {"sum": 0, "prod": 1, "max": 2, "min": 3}
_COMBINE = {"sum": torch.add, "prod": torch.mul, "max": torch.maximum,
            "min": torch.minimum}


def _first_max(acc, v):
    # the kernels' combine(acc, v): a NaN in acc stays, else a NaN in v
    # wins (v <= acc is false for it), else v only if greater
    # (torch.maximum gives its own NaN bits on the CPU and may take v on a
    # tie of -0 and +0)
    return torch.where((acc != acc) | (v <= acc), acc, v)


def _first_min(acc, v):
    return torch.where((acc != acc) | (v >= acc), acc, v)


_FOLD = {"sum": torch.add, "prod": torch.mul, "max": _first_max,
         "min": _first_min}


def _identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if op == "prod":
        return 1
    if dtype.is_floating_point:
        return -math.inf if op == "max" else math.inf
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


# ------------------------------------------------------------------ plain
def segment_reduce_plain(buf: torch.Tensor, seg_start: torch.Tensor,
                         seg_len: torch.Tensor, op: str = "sum",
                         Lmax: int = None) -> torch.Tensor:
    """Per-segment fold of ``buf[start : start + len]`` from the identity,
    taken sequentially in buffer order (the kernels' order): max / min
    keep the first NaN, with its payload, else the first extremum."""
    start, length = seg_start.long().reshape(-1), seg_len.long().reshape(-1)
    S, unit = start.numel(), tuple(buf.shape[1:])
    if Lmax is None:
        Lmax = int(length.max()) if S else 0
    combine = _FOLD[op]
    acc = torch.full((S,) + unit, _identity(op, buf.dtype), dtype=buf.dtype,
                     device=buf.device)
    for k in range(int(Lmax)):
        live = k < length
        vals = buf[torch.where(live, start + k, 0)]
        mask = live.reshape((S,) + (1,) * len(unit))
        acc = torch.where(mask, combine(acc, vals), acc)
    return acc


# ------------------------------------------------------------ long plan
LONG_SEG = 256              # segments longer than this take the long route
LONG_CHUNK_ROWS = 8192      # C: csrc/sf_unpack.cu kLongChunkRows (a CPU
                            # test holds the two equal)


def order_free(dtype: torch.dtype, op: str) -> bool:
    """Whether ``op``'s fold over ``dtype`` gives the same bits in any
    order of combines that keeps the earlier operand left: every integer
    op (sums and products wrap) and float max / min (the first NaN, else
    the first extremum), not float sum / prod."""
    return not dtype.is_floating_point or op in ("max", "min")


def reduce_route(lmax: int, dtype: torch.dtype, op: str) -> str:
    """The route of a launch whose longest segment has ``lmax`` rows:
    ``"short"`` (every segment in the one-thread-a-segment kernel), or,
    for the segments longer than ``LONG_SEG``, ``"split"`` (chunks folded
    by separate CTAs, then their partials in chunk order: the folds whose
    result does not depend on the order, every integer op and float
    max / min) or ``"ordered"`` (float sum / prod: one CTA a segment folds
    the rows in buffer order)."""
    if lmax <= LONG_SEG:
        return "short"
    return "split" if order_free(dtype, op) else "ordered"


@dataclasses.dataclass(frozen=True)
class LongPlan:
    """The long route's plan for one segment metadata: the ``n_long``
    segments longer than the cut (ids ``seg``, ascending, with their
    ``start`` / ``length`` rows), cut into ``n_chunks`` chunks of
    ``LONG_CHUNK_ROWS`` rows (the last of a segment shorter): segment ``j``'s
    chunks are ``chunk0[j]`` onwards, ``chunk_seg[c]`` is chunk ``c``'s
    index into the long lists.  int32 tensors on the metadata's device."""
    n_long: int
    n_chunks: int
    seg: torch.Tensor
    start: torch.Tensor
    length: torch.Tensor
    chunk0: torch.Tensor
    chunk_seg: torch.Tensor

    def chunks(self) -> np.ndarray:
        """``(n_chunks, 3)`` int64: each chunk's segment id, first row and
        rows, as the kernels compute them."""
        C = LONG_CHUNK_ROWS
        cs = self.chunk_seg.cpu().numpy().astype(np.int64)
        k = np.arange(self.n_chunks) - self.chunk0.cpu().numpy()[cs]
        first = self.start.cpu().numpy().astype(np.int64)[cs] + k * C
        rows = np.minimum(C, self.length.cpu().numpy()[cs] - k * C)
        return np.stack([self.seg.cpu().numpy()[cs], first, rows], 1)


def build_long_plan(start: torch.Tensor, length: torch.Tensor, *,
                    cut: int = LONG_SEG) -> LongPlan:
    """:class:`LongPlan` of prepared int32 metadata, built on its device
    with one host read (the counts of long segments and chunks).  ``cut``
    other than ``LONG_SEG`` sends shorter segments to the long route (the
    card's measurement of where the route pays)."""
    dev = start.device
    C = LONG_CHUNK_ROWS
    ln = length.long()
    long = ln > cut
    nch = torch.where(long, (ln + C - 1) // C, 0)
    n_long, n_chunks = torch.stack([long.sum(), nch.sum()]).tolist()
    if n_chunks >= 2 ** 31:
        raise ValueError(f"{n_chunks} chunks exceed the long route's 32-bit "
                         f"grid")
    # the long segments first, in id order
    seg = torch.argsort((~long).to(torch.uint8), stable=True)[:n_long]
    per = nch[seg]
    chunk_seg = torch.repeat_interleave(
        torch.arange(n_long, device=dev), per, output_size=n_chunks)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return LongPlan(n_long=int(n_long), n_chunks=int(n_chunks),
                    seg=i32(seg), start=i32(start[seg]),
                    length=i32(length[seg]),
                    chunk0=i32(torch.cumsum(per, 0) - per),
                    chunk_seg=i32(chunk_seg))


def long_plan(seg_start, seg_len, device: torch.device) -> LongPlan:
    """The long route's :class:`LongPlan` of ``(seg_start, seg_len)`` on
    ``device``, cached beside :func:`segment_meta`'s entry: a static SF
    builds it once, runtime metadata once per call that has a long
    segment."""
    def build():
        start, length, _, _ = segment_meta(seg_start, seg_len, device)
        return build_long_plan(start, length)
    return cached((seg_start, seg_len), device, "long_plan", build)


def prepare(seg_start, seg_len, device: torch.device) -> None:
    """Build the cached metadata (and, on a card, the long plan where a
    segment is longer than ``LONG_SEG``) ahead of the first launch, so that
    a launch captured into a CUDA graph reads nothing back."""
    _, _, _, lmax = segment_meta(seg_start, seg_len, device)
    if lmax > LONG_SEG and device.type == "cuda":
        long_plan(seg_start, seg_len, device)


# ---------------------------------------------------------------- kernels
def _launch_short(buf, out, start, length, op: str, segs_per_cta: int,
                  cut: int, col_tiles: int = 0) -> None:
    """The short route; ``col_tiles`` column tiles of the unit on the
    grid's y axis (0: the launcher's choice, which cuts a wide unit when
    the segment groups are too few to fill the card)."""
    S, U = start.numel(), math.prod(buf.shape[1:])
    _build.launch("sf_segment_reduce", buf.data_ptr(), out.data_ptr(),
                  start.data_ptr(), length.data_ptr(), S, U,
                  _DTYPE_CODES[buf.dtype], _OP_CODES[op], int(segs_per_cta),
                  int(cut), int(col_tiles), _build.stream_of(buf))


def _launch_long(buf, out, plan: LongPlan, op: str) -> None:
    U = math.prod(buf.shape[1:])
    part = None
    if order_free(buf.dtype, op):
        part = torch.empty((plan.n_chunks,) + tuple(buf.shape[1:]),
                           dtype=buf.dtype, device=buf.device)
    _build.launch("sf_segment_reduce_long", buf.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(),
                  plan.seg.data_ptr(), plan.start.data_ptr(),
                  plan.length.data_ptr(), plan.chunk0.data_ptr(),
                  plan.chunk_seg.data_ptr(), plan.n_long, plan.n_chunks, U,
                  _DTYPE_CODES[buf.dtype], _OP_CODES[op],
                  _build.stream_of(buf))


def _checked(buf: torch.Tensor, seg_start, seg_len, op: str):
    if op not in _OP_CODES:
        raise ValueError(f"segment reduce op must be one of "
                         f"{sorted(_OP_CODES)}, got {op!r}")
    if buf.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment reduce takes "
                        f"{', '.join(str(d)[6:] for d in _DTYPE_CODES)}, "
                        f"not "
                        f"{buf.dtype}")
    start, length, end, lmax = segment_meta(seg_start, seg_len, buf.device)
    M = int(buf.shape[0])
    if end > M:
        raise IndexError(f"segments reach row {end} of a {M}-row buffer")
    return start, length, lmax


def _reduce(counter, buf: torch.Tensor, seg_start, seg_len, op: str,
            segs_per_cta: int) -> torch.Tensor:
    start, length, lmax = _checked(buf, seg_start, seg_len, op)
    if buf.device.type == "cpu":
        return segment_reduce_plain(buf, start, length, op, lmax)
    require_cuda_tensor(buf, "buf")
    S = start.numel()
    out = torch.empty((S,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    if S == 0 or out.numel() == 0:
        return out
    if reduce_route(lmax, buf.dtype, op) == "short":
        _launch_short(buf, out, start, length, op, segs_per_cta, LONG_SEG)
    else:
        plan = long_plan(seg_start, seg_len, buf.device)
        if plan.n_long < S:
            _launch_short(buf, out, start, length, op, segs_per_cta,
                          LONG_SEG)
        _launch_long(buf, out, plan, op)
    counter.launches += 1
    return out


def segment_reduce_sorted(buf: torch.Tensor, seg_start, seg_len, *,
                          op: str = "sum") -> torch.Tensor:
    """Reduce sorted rows into per-segment rows, one segment per CTA.

    buf: (M, *unit) rows sorted by destination; seg_start / seg_len: (S,)
    first row and length of each segment.  Returns (S, *unit)."""
    return _reduce(segment_reduce_sorted, buf, seg_start, seg_len, op, 1)


def segment_reduce_blocked(buf: torch.Tensor, seg_start, seg_len, *,
                           segs_per_block: int, op: str = "sum"
                           ) -> torch.Tensor:
    """:func:`segment_reduce_sorted` with ``segs_per_block`` segments per
    CTA."""
    if int(segs_per_block) < 1:
        raise ValueError("segs_per_block must be >= 1")
    return _reduce(segment_reduce_blocked, buf, seg_start, seg_len, op,
                   int(segs_per_block))


def short_variant(buf: torch.Tensor, seg_start, seg_len, *,
                  segs_per_block: int, col_tiles: int,
                  op: str = "sum") -> torch.Tensor:
    """The short route on a CUDA tensor with the unit's column tiles
    forced (``col_tiles=1``: one CTA for each group of ``segs_per_block``
    segments, as before the tiles), for comparisons in ``chip_smoke.py``;
    every segment must be at most ``LONG_SEG`` rows (the plain version on
    the CPU).  Counts no launch (it is on no path)."""
    start, length, lmax = _checked(buf, seg_start, seg_len, op)
    if buf.device.type == "cpu":
        return segment_reduce_plain(buf, start, length, op, lmax)
    require_cuda_tensor(buf, "buf")
    if reduce_route(lmax, buf.dtype, op) != "short":
        raise ValueError(f"a segment of {lmax} rows takes the long route")
    out = torch.empty((start.numel(),) + tuple(buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    if out.numel():
        _launch_short(buf, out, start, length, op, int(segs_per_block),
                      LONG_SEG, int(col_tiles))
    return out


def unpack_segments(target: torch.Tensor, buf_sorted: torch.Tensor,
                    seg_start, seg_len, seg_dst, *, op: str = "sum",
                    segs_per_block: int = 64) -> torch.Tensor:
    """Full unpack: segment-reduce the sorted buffer, then one
    duplicate-free scatter of the segment rows into a copy of ``target``
    at rows ``seg_dst`` with reduction ``op``."""
    red = segment_reduce_blocked(buf_sorted, seg_start, seg_len,
                                 segs_per_block=segs_per_block, op=op)
    dst, lo, hi = device_index(seg_dst, target.device, "seg_dst")
    if dst.numel() and (lo < 0 or hi >= int(target.shape[0])):
        raise IndexError("seg_dst outside target rows")
    dst = dst.long()
    out = target.clone()
    out[dst] = _COMBINE[op](out[dst], red.to(target.dtype))
    return out


for _f in (segment_reduce_sorted, segment_reduce_blocked):
    _f.launches = 0
