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
``LONG_SEG`` rows, the short route folds every segment, laid out by
:func:`short_plan` (the one place that picks its kernel and grid): rows of
whole 16-byte vectors on 16-byte boundaries take the vector kernel (a lane
folds one 16-byte vector of a segment's row, ``SHORT_ROWS`` rows' loads in
flight; a warp a chunk of a wide row or several narrow segments), other
rows the scalar kernel (one thread per (segment, unit element), the unit
cut into column tiles when the segments are too few to fill the card);
otherwise the longer segments leave that kernel for the long route, planned
once per segment metadata (:func:`long_plan`): chunks of
``LONG_CHUNK_ROWS`` rows folded by separate CTAs and their partials in
chunk order where the fold's bits do not depend on the order (integers,
float max / min), else a CTA a segment folding its rows, staged through
shared memory, in buffer order (float sum / prod).  The source's note
gives the bounds and why each layout keeps the sequential fold's bits.

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
import functools
import math

import numpy as np
import torch

from . import _build
from .sf_pack import H100_SMS, _device_sms
from ._index import cached, device_index, require_cuda_tensor, \
    segment_meta

__all__ = ["segment_reduce_sorted", "segment_reduce_blocked",
           "unpack_segments", "segment_reduce_plain", "short_variant",
           "LONG_SEG", "LONG_CHUNK_ROWS", "LongPlan", "long_plan",
           "build_long_plan", "order_free", "reduce_route", "prepare",
           "SHORT_ROWS", "SHORT_MAX_K", "SHORT_WARPS", "ShortPlan",
           "short_plan", "plan_of"]

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


# ----------------------------------------------------------- short plan
SHORT_ROWS = 8          # R: csrc/sf_unpack.cu kShortRows, rows a lane has
                        # in flight (a CPU test holds these three equal)
SHORT_MAX_K = 4         # kShortMaxK: vectors a lane folds a chunk
SHORT_WARPS = 4         # kShortWarps: warps a vector CTA (fewer below 4
                        # items an SM)
# The rest of the vector plan's rule was picked from a sweep of K, warps
# and items a CTA at the paths' four shapes on an H100 (segred_variants.py)
SHORT_LANE_ROWS = 4     # K grows until a lane's chunk moves this many rows
                        # (a segment's rows and its output row) a vector
SHORT_FILL_WARPS = 32   # ...and shrinks while the items give an SM fewer
                        # warps than this
SHORT_CTA_BYTES = 12 << 10  # a CTA walks items until it moves this many
SHORT_CTAS_PER_SM = 4   # bytes, while the grid keeps this many CTAs an SM
SCALAR_FILL_CTAS = 8    # scalar route: column tiles until the grid holds
                        # 8 CTAs of 256 threads an SM (a full SM)...
SCALAR_MIN_TILE = 1024  # ...each tile at least this many columns
SHORT_ROUTES = ("scalar", "vector")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ShortPlan:
    """How one short-route launch folds ``S`` segments of ``U``-element
    rows (``elem`` bytes an element) read from a buffer ``buf_mod`` bytes
    and written to an output ``out_mod`` bytes past a 16-byte boundary, at
    ``segs_per_cta`` segments a CTA at least.

    ``route == "vector"``: a row is ``UV`` 16-byte vectors; ``lanes`` (LS)
    lanes fold one segment's row, so a warp item covers ``32 // lanes``
    segments (``lanes < 32``: rows under 32 vectors) or one ``chunk`` of
    ``32 * K`` vectors of one row (``chunks`` a row); lane ``l`` of a group
    folds vectors ``c * lanes * K + l + lanes * q``, ``q < K``, in turn,
    ``SHORT_ROWS`` rows' loads in flight.  ``grid`` CTAs of ``threads``
    walk ``per_cta`` consecutive items each, their warps in turn.
    ``route == "scalar"``: ``grid = (gx, gy)`` CTAs of ``threads``; CTA
    (x, y) folds segments ``x * segs_per_cta ...`` over the unit's columns
    ``y * width ...``, one thread per (segment, element) in turn."""
    route: str
    S: int
    U: int
    elem: int
    buf_mod: int
    out_mod: int
    segs_per_cta: int
    threads: int
    grid: tuple
    UV: int = 0
    lanes: int = 0
    K: int = 0
    chunks: int = 0
    items: int = 0
    per_cta: int = 0
    width: int = 0

    @property
    def V(self) -> int:
        """Elements a fold owns: a 16-byte vector's, or 1."""
        return 16 // self.elem if self.route == "vector" else 1

    def walk(self, seg_start, seg_len, *, long_cut: int = None,
             ctas=None) -> dict:
        """The launch's folds as the kernel computes them, in numpy, for
        segments ``(seg_start, seg_len)``, over CTAs ``ctas`` (a range of
        linear CTA ids, ``blockIdx.y * gx + blockIdx.x``; all by default).
        A fold is one accumulator: ``cta``, ``warp``, ``lane`` (its
        thread), ``seg``, ``elem`` (its first output element, ``seg * U +
        e``) and ``width`` (its elements, ``V``).  ``reads``: ``(fold,
        row)`` pairs, each fold's buffer rows in the order it combines
        them.  Segments longer than ``long_cut`` (default ``LONG_SEG``)
        are skipped."""
        st = np.asarray(seg_start, np.int64).reshape(-1)
        ln = np.asarray(seg_len, np.int64).reshape(-1)
        cut = LONG_SEG if long_cut is None else long_cut
        n_ctas = int(np.prod(self.grid))
        lo, hi = (0, n_ctas) if ctas is None else (ctas.start, ctas.stop)
        hi = min(hi, n_ctas)
        if self.route == "vector":
            cta, warp, lane, seg, elem = self._walk_vector(lo, hi)
        else:
            cta, warp, lane, seg, elem = self._walk_scalar(lo, hi)
        keep = ln[seg] <= cut
        cta, warp, lane, seg, elem = (a[keep] for a in
                                      (cta, warp, lane, seg, elem))
        # every fold's rows start .. start + len - 1 in row order (the
        # kernel loads them SHORT_ROWS a batch and folds each batch in order)
        n = ln[seg]
        fold = np.repeat(np.arange(seg.size), n)
        row = st[seg][fold] + np.arange(fold.size) \
            - np.repeat(np.cumsum(n) - n, n)
        return {"cta": cta, "warp": warp, "lane": lane, "seg": seg,
                "elem": elem, "width": np.full(seg.size, self.V),
                "reads": (fold, row)}

    def _walk_vector(self, lo: int, hi: int):
        W, LS, K = self.threads // 32, self.lanes, self.K
        it = np.arange(lo * self.per_cta, min(hi * self.per_cta, self.items),
                       dtype=np.int64)
        cta = it // self.per_cta
        warp = (it - cta * self.per_cta) % W
        lane = np.arange(32)
        sub, lv = lane // LS, lane % LS
        grp, c = it // self.chunks, it % self.chunks
        s = (grp * (32 // LS))[:, None, None] + sub[None, :, None]
        v = (c * LS * K)[:, None, None] + lv[None, :, None] \
            + LS * np.arange(K)[None, None, :]
        live = (s < self.S) & (v < self.UV)
        shape = live.shape
        pick = lambda a: np.broadcast_to(a, shape)[live]
        return (pick(cta[:, None, None]), pick(warp[:, None, None]),
                pick(lane[None, :, None]), pick(s),
                pick(s) * self.U + pick(v) * self.V)

    def _walk_scalar(self, lo: int, hi: int):
        gx, gy = self.grid
        w0, SB, T = self.width, self.segs_per_cta, self.threads
        ids = np.arange(lo, hi, dtype=np.int64)
        x, y = ids % gx, ids // gx
        ns = np.minimum(SB, self.S - x * SB)
        w = np.minimum(w0, self.U - y * w0)
        total = ns * w
        cta = np.repeat(ids, total)
        t = np.arange(cta.size) - np.repeat(np.cumsum(total) - total, total)
        wc = np.repeat(w, total)
        s = np.repeat(x * SB, total) + t // wc
        e = np.repeat(y * w0, total) + t % wc
        th = t % T
        return cta, th // 32, th % 32, s, s * self.U + e


def short_plan(S: int, unit_elems: int, elem_bytes: int, *, rows: int,
               buf_ptr: int, out_ptr: int, segs_per_cta: int,
               sms: int = H100_SMS, col_tiles: int = 0,
               route: str = None) -> ShortPlan:
    """The short route's launch plan for ``S`` segments over a buffer of
    ``rows`` rows of ``unit_elems`` elements of ``elem_bytes`` bytes, read
    from ``buf_ptr`` into ``out_ptr``, ``segs_per_cta`` segments a CTA at
    least, on a card of ``sms`` SMs.

    The route is ``"vector"`` where a row is whole 16-byte vectors and
    both pointers sit on 16-byte boundaries, else ``"scalar"``; ``route``
    forces one (for comparisons on the card; ``"vector"`` raises where the
    rows do not qualify, and so do column tiles, which are the scalar
    route's).  Vector: ``lanes`` is the row's vectors rounded up to a
    power of two, at most 32.  For wide rows (32 lanes) ``K``, the vectors
    a lane folds a chunk, is the least that gives a lane
    ``SHORT_LANE_ROWS`` rows a vector at ``rows / S`` rows a segment (plus
    its output row), at most 4; it shrinks while the items would give an
    SM fewer than ``SHORT_FILL_WARPS`` warps; then ``K`` is the least that
    spreads a row's vectors over its chunks.  A CTA has ``SHORT_WARPS``
    warps (fewer when the items are fewer than that an SM) and walks
    ``per_cta = warps * m`` items: ``m`` the least that moves
    ``SHORT_CTA_BYTES``, or ``segs_per_cta`` items over the warps if more
    (a segment is an item where its row is one chunk), at most what keeps
    ``SHORT_CTAS_PER_SM`` CTAs an SM.  Scalar: ``col_tiles`` column tiles
    (0: enough to give the grid ``SCALAR_FILL_CTAS`` CTAs an SM, each at
    least ``SCALAR_MIN_TILE`` columns); non-zero ``col_tiles`` with no
    ``route`` means the scalar route.  Only the pointers' offsets from
    16-byte alignment matter, and plans are memoized on them and the
    shapes: the path asks for one on every launch."""
    if route not in (None,) + SHORT_ROUTES:
        raise ValueError(f"route must be one of {SHORT_ROUTES}, got "
                         f"{route!r}")
    return _short_plan(int(S), int(unit_elems), int(elem_bytes), int(rows),
                       int(buf_ptr) % 16, int(out_ptr) % 16,
                       int(segs_per_cta), int(sms), int(col_tiles), route)


@functools.lru_cache(maxsize=1024)
def _short_plan(S: int, U: int, eb: int, M: int, buf_mod: int, out_mod: int,
                SB: int, sms: int, col_tiles: int, route) -> ShortPlan:
    if S < 1 or U < 1 or SB < 1 or M < 0:
        raise ValueError("short_plan needs S, unit elements and "
                         "segs_per_cta >= 1, rows >= 0")
    rb = U * eb
    vector = rb % 16 == 0 and buf_mod == 0 and out_mod == 0
    if route == "vector" and col_tiles:
        raise ValueError("col_tiles are the scalar route's")
    if route == "vector" and not vector:
        raise ValueError(f"rows of {rb} bytes at offsets {buf_mod} / "
                         f"{out_mod} from 16 bytes cannot take the vector "
                         f"route")
    if route == "scalar" or not vector or col_tiles:
        return _scalar_plan(S, U, eb, buf_mod, out_mod, SB, sms, col_tiles)
    UV = rb // 16
    LS = min(32, 1 << (UV - 1).bit_length())
    G = 32 // LS
    groups = _cdiv(S, G)
    moved = M / S + 1                       # rows a vector moves, output too
    K, chunks = 1, 1
    if LS == 32:
        first = min(SHORT_MAX_K, max(1, math.ceil(SHORT_LANE_ROWS / moved)))
        for K in range(first, 0, -1):
            chunks = _cdiv(UV, 32 * K)
            if groups * chunks >= SHORT_FILL_WARPS * sms:
                break
        K = _cdiv(UV, 32 * chunks)
    items = groups * chunks
    if items >= 2 ** 31:
        raise ValueError(f"{S} segments of {rb}-byte rows exceed the vector "
                         f"route's 32-bit item count")
    W = SHORT_WARPS if items >= SHORT_WARPS * sms else max(1, items // sms)
    item_bytes = 16 * min(UV, 32 * K) * G * moved
    m = max(math.ceil(SHORT_CTA_BYTES / (W * item_bytes)),
            _cdiv(_cdiv(SB, G), W))
    m = max(1, min(m, items // (W * SHORT_CTAS_PER_SM * sms)))
    per_cta = W * m
    return ShortPlan(route="vector", S=S, U=U, elem=eb, buf_mod=buf_mod,
                     out_mod=out_mod, segs_per_cta=SB, threads=32 * W,
                     grid=(_cdiv(items, per_cta),), UV=UV, lanes=LS, K=K,
                     chunks=chunks, items=items, per_cta=per_cta)


def _scalar_plan(S, U, eb, buf_mod, out_mod, SB, sms, col_tiles):
    groups = _cdiv(S, SB)
    if groups >= 2 ** 31:
        raise ValueError(f"{S} segments exceed the scalar route's grid")
    tiles = col_tiles
    if tiles <= 0:
        want = sms * SCALAR_FILL_CTAS
        tiles = 1 if groups >= want else _cdiv(want, groups)
        tiles = min(tiles, _cdiv(U, SCALAR_MIN_TILE))
    tiles = max(1, min(tiles, U))
    width = _cdiv(U, tiles)
    if tiles > 1:
        width = _cdiv(width, 32) * 32
    while _cdiv(U, width) > 65535:
        width *= 2
    warps = _cdiv(SB * width, 32)
    threads = 256 if warps >= 8 else 32 * max(1, warps)
    return ShortPlan(route="scalar", S=S, U=U, elem=eb, buf_mod=buf_mod,
                     out_mod=out_mod, segs_per_cta=SB, threads=threads,
                     grid=(groups, _cdiv(U, width)), width=width)


def plan_of(buf: torch.Tensor, out: torch.Tensor, segs_per_cta: int,
            col_tiles: int = 0, route: str = None) -> ShortPlan:
    """The :func:`short_plan` of a short-route launch on these tensors."""
    return short_plan(out.shape[0], math.prod(buf.shape[1:]),
                      buf.element_size(), rows=buf.shape[0],
                      buf_ptr=buf.data_ptr(),
                      out_ptr=out.data_ptr(), segs_per_cta=segs_per_cta,
                      sms=_device_sms(buf), col_tiles=col_tiles, route=route)


# ---------------------------------------------------------------- kernels
def _launch_short(buf, out, start, length, op: str, segs_per_cta: int,
                  cut: int, col_tiles: int = 0, route: str = None) -> None:
    """The short route as :func:`short_plan` lays it out (``col_tiles`` and
    ``route`` forced only for comparisons)."""
    plan = plan_of(buf, out, segs_per_cta, col_tiles, route)
    args = (buf.data_ptr(), out.data_ptr(), start.data_ptr(),
            length.data_ptr(), plan.S)
    if plan.route == "vector":
        _build.launch("sf_segment_reduce_vec", *args, plan.UV,
                      _DTYPE_CODES[buf.dtype], _OP_CODES[op], int(cut),
                      plan.items, plan.chunks, plan.per_cta, plan.K,
                      plan.lanes.bit_length() - 1, plan.threads // 32,
                      plan.grid[0], _build.stream_of(buf))
    else:
        _build.launch("sf_segment_reduce", *args, plan.U,
                      _DTYPE_CODES[buf.dtype], _OP_CODES[op],
                      int(segs_per_cta), int(cut), plan.width, plan.threads,
                      plan.grid[0], plan.grid[1], _build.stream_of(buf))


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
            segs_per_cta: int, col_tiles: int = 0,
            route: str = None) -> torch.Tensor:
    """The segment reduce; ``col_tiles`` / ``route`` force the short
    route's layout (``short_variant``); ``counter`` (the entry point whose
    launches to count, or None) counts the call."""
    start, length, lmax = _checked(buf, seg_start, seg_len, op)
    if buf.device.type == "cpu":
        return segment_reduce_plain(buf, start, length, op, lmax)
    require_cuda_tensor(buf, "buf")
    S = start.numel()
    out = torch.empty((S,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    if S == 0 or out.numel() == 0:
        return out
    short = lambda: _launch_short(buf, out, start, length, op, segs_per_cta,
                                  LONG_SEG, col_tiles, route)
    if reduce_route(lmax, buf.dtype, op) == "short":
        short()
    else:
        plan = long_plan(seg_start, seg_len, buf.device)
        if plan.n_long < S:
            short()
        _launch_long(buf, out, plan, op)
    if counter is not None:
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
                  segs_per_block: int, col_tiles: int = 0,
                  route: str = None, op: str = "sum") -> torch.Tensor:
    """The segment reduce with its short route's layout forced, for
    comparisons in ``chip_smoke.py``: ``route="scalar"`` (the one-thread-
    an-element kernel, the design before the vector kernel) or
    ``"vector"`` (raises where the rows do not qualify); ``col_tiles`` the
    scalar kernel's column tiles (``col_tiles=1``: one CTA for each group
    of ``segs_per_block`` segments, as before the tiles; a non-zero value
    with no ``route`` means the scalar kernel).  No ``route`` and no tiles:
    the plan's choice.  Segments over ``LONG_SEG`` rows take the long
    route, as in the entry points (the plain version on the CPU).  Counts
    no launch (it is on no path)."""
    return _reduce(None, buf, seg_start, seg_len, op, int(segs_per_block),
                   int(col_tiles), route)


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
