"""SF unpack with reduction: the deterministic segment reduce — the Hopper
port of ``repro/kernels/sf_unpack.py``.

Paper §5.3 GPU unpacks need atomics when destinations repeat.  The
reference replaces them with a setup-time sort (DESIGN §3.3): the packed
buffer is ordered by destination, equal destinations form *segments*, a
segment reduction emits one row per segment, and one duplicate-free
scatter finishes the unpack.  ``csrc/sf_unpack.cu`` is that segment
reduction: one thread per (segment, unit element) folds the segment's rows
in buffer order, so float results are the same on every run and equal to
the plain version bit for bit.  The source's note gives the bound (bytes)
and the design.

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

import math

import numpy as np
import torch

from . import _build
from ._index import device_index, require_cuda_tensor, segment_meta

__all__ = ["segment_reduce_sorted", "segment_reduce_blocked",
           "unpack_segments", "segment_reduce_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                torch.bfloat16: 3, torch.int8: 4, torch.uint8: 5,
                torch.int16: 6, torch.int64: 7, torch.float16: 8}
_OP_CODES = {"sum": 0, "prod": 1, "max": 2, "min": 3}
_COMBINE = {"sum": torch.add, "prod": torch.mul, "max": torch.maximum,
            "min": torch.minimum}


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
    taken sequentially in buffer order (the kernel's order)."""
    start, length = seg_start.long().reshape(-1), seg_len.long().reshape(-1)
    S, unit = start.numel(), tuple(buf.shape[1:])
    if Lmax is None:
        Lmax = int(length.max()) if S else 0
    combine = _COMBINE[op]
    acc = torch.full((S,) + unit, _identity(op, buf.dtype), dtype=buf.dtype,
                     device=buf.device)
    for k in range(int(Lmax)):
        live = k < length
        vals = buf[torch.where(live, start + k, 0)]
        mask = live.reshape((S,) + (1,) * len(unit))
        acc = torch.where(mask, combine(acc, vals), acc)
    return acc


# ---------------------------------------------------------------- kernels
def _reduce(counter, buf: torch.Tensor, seg_start, seg_len, op: str,
            segs_per_cta: int) -> torch.Tensor:
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
    if buf.device.type == "cpu":
        return segment_reduce_plain(buf, start, length, op, lmax)
    require_cuda_tensor(buf, "buf")
    S = start.numel()
    out = torch.empty((S,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    U = int(np.prod(buf.shape[1:], dtype=np.int64))
    if S == 0 or U == 0:
        return out
    _build.launch("sf_segment_reduce", buf.data_ptr(), out.data_ptr(),
                  start.data_ptr(), length.data_ptr(), S, U,
                  _DTYPE_CODES[buf.dtype], _OP_CODES[op], int(segs_per_cta),
                  _build.stream_of(buf))
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
