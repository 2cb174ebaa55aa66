"""Entry points of the kernel backend (the port of ``repro/kernels/ops.py``).

The SF hot path calls ``pack_rows``, ``segment_reduce_rows`` and
``local_bcast_rows``.  Each routes to a hand-written kernel by a fixed rule;
there is no autotune sweep and no library candidate, so the path always
runs the kernels and a kernel that fails to build raises:

  * rows of fewer than ``WIDE_ROW`` elements: the blocked kernels at
    ``block_rows=PACK_BLOCK_ROWS`` / ``SEG_BLOCK`` segments per CTA.  The
    gather's rows of 1–4 32-bit words take its narrow kernel (4 rows per
    thread, 128-thread CTAs at this ``block_rows``, grid from
    ``sf_pack.row_plan``); other rows its generic loop, 64 rows per CTA;
  * rows of ``WIDE_ROW`` elements or more: the wide gather ``pack``
    (aligned 16-byte output vectors whatever the row's width and base
    offsets, a warp per chunk of up to 2 KB of a row, rows split across
    warps when they are few, grid from ``sf_pack.wide_plan``) and one
    segment per CTA (``segment_reduce_sorted``);
  * a strided box (``pack_strided_rows``): the route and grid that
    ``sf_pack.strided_plan`` computes from the box and the pointers;
  * a segment reduce whose longest segment has more than
    ``sf_unpack.LONG_SEG`` rows: those segments take the long route
    (``sf_unpack.reduce_route``; chunks folded across CTAs where the fold is
    order-free, a CTA a segment in buffer order for float sum / prod), the
    rest the kernel above in the same call.

``chip_smoke.py`` times both variants on f32 rows of 64, 256 and 1024
elements (see ``PERF.md``).  For the segment reduce the one-segment-per-CTA
kernel is the faster there, about 2x at 256 and more; for the gather the
wide kernel is the faster at 256 and 1024 and the blocked one at 64.  The
MoE path's rows (8-16 KB, some 2 or 4 bytes past a 16-byte multiple) and
the wide-row SF's 1 KB rows take ``pack``.

Index lists are prepared once per source array and device (int32 upload
and bounds check, :mod:`repro_torch.kernels._index`), so repeat exchanges
on one plan cost no conversion.  A routing index that is new every step
takes ``pack_rows(..., dynamic=True)`` instead: no host read, no cache
entry, and the bounds checked by the gather kernels on the device.  The
direct entry points ``sf_pack``, ``sf_pack_strided``, ``sf_unpack`` and
``spmv_ell`` call one kernel each.

``flash_attention`` is the serving path's prefill attention core (the
reference's ``_chunked_attn`` function, computed by the hand-written
kernel; ``models/layers.py::attention`` calls it).
"""

from __future__ import annotations

import math

import torch

from . import ref
from .sf_pack import (bcast_fused, inverse_map, pack, pack_blocked,
                      pack_strided)
from .sf_unpack import (segment_reduce_blocked, segment_reduce_sorted,
                        unpack_segments)
from .spmv_ell import spmv_ell
from .flash_attention import flash_attention

__all__ = [
    "PACK_BLOCK_ROWS", "SEG_BLOCK", "WIDE_ROW",
    "pack_rows", "segment_reduce_rows", "local_bcast_rows", "inverse_map",
    "sf_pack", "sf_pack_strided", "sf_unpack", "spmv_ell", "flash_attention",
    "ref",
    "kernel_wrappers", "reset_launch_counts", "launch_counts",
    "add_launches",
]

PACK_BLOCK_ROWS = 64
SEG_BLOCK = 64
WIDE_ROW = 256


def _row_elems(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:])     # per launch: cheaper than np.prod


def pack_rows(data: torch.Tensor, idx, *, dynamic: bool = False
              ) -> torch.Tensor:
    """``data[idx]`` row gather through the pack kernels, for rows of any
    unit shape and dtype; ``idx`` is a numpy array or an integer tensor on
    ``data``'s device.

    ``dynamic=True`` is the route for an index written on the device this
    step (``DynPlan``'s routing, new every call): it is used as it is, with
    no host read and no cache entry, and the kernel checks every index
    against ``data``'s rows on the device and traps on one outside them.
    On the CPU the plain version checks the range first and raises."""
    if _row_elems(data) >= WIDE_ROW:
        return pack(data, idx, dynamic=dynamic)
    return pack_blocked(data, idx, block_rows=PACK_BLOCK_ROWS,
                        dynamic=dynamic)


def pack_strided_rows(data: torch.Tensor, strided) -> torch.Tensor:
    """The rows a :class:`repro_torch.core.patterns.Strided3D` enumerates,
    through the strided pack kernels (route and grid from
    ``sf_pack.strided_plan``)."""
    return pack_strided(data, start=strided.start, dims=strided.dims,
                        strides=strided.strides)


def segment_reduce_rows(sorted_vals: torch.Tensor, seg_first, seg_len, *,
                        op: str = "sum") -> torch.Tensor:
    """One row per segment of a destination-sorted row buffer (sum, prod,
    max, min), folded in buffer order by the segment-reduce kernels."""
    if _row_elems(sorted_vals) >= WIDE_ROW:
        return segment_reduce_sorted(sorted_vals, seg_first, seg_len, op=op)
    return segment_reduce_blocked(sorted_vals, seg_first, seg_len,
                                  segs_per_block=SEG_BLOCK, op=op)


def local_bcast_rows(rootdata: torch.Tensor, leafdata: torch.Tensor,
                     src_of_leaf) -> torch.Tensor:
    """Local-only bcast through the fused kernel: a copy of ``leafdata``
    with every leaf that has a root (``src_of_leaf >= 0``, built once by
    :func:`inverse_map`) replaced by its root's row."""
    return bcast_fused(rootdata, leafdata, src_of_leaf)


# --------------------------------------------------------------------------
# direct (untuned) kernel access
# --------------------------------------------------------------------------
def sf_pack(data, idx):
    return pack(data, idx)


def sf_pack_strided(data, *, start, dims, strides):
    return pack_strided(data, start=int(start),
                        dims=tuple(int(d) for d in dims),
                        strides=tuple(int(s) for s in strides))


def sf_unpack(target, buf_sorted, seg_start, seg_len, seg_dst, *, op="sum"):
    return unpack_segments(target, buf_sorted, seg_start, seg_len, seg_dst,
                           op=op, segs_per_block=SEG_BLOCK)


# --------------------------------------------------------------------------
# launch counters
# --------------------------------------------------------------------------
def kernel_wrappers() -> dict:
    """Every kernel entry point by name; each counts its launches in
    ``.launches``."""
    return {"pack": pack, "pack_blocked": pack_blocked,
            "pack_strided": pack_strided, "bcast_fused": bcast_fused,
            "segment_reduce_sorted": segment_reduce_sorted,
            "segment_reduce_blocked": segment_reduce_blocked,
            "spmv_ell": spmv_ell, "flash_attention": flash_attention}


def reset_launch_counts() -> None:
    for f in kernel_wrappers().values():
        f.launches = 0
    flash_attention.launches_sm90 = 0   # the wgmma route's share
    pack_strided.routes = {r: 0 for r in pack_strided.routes}


def launch_counts() -> dict:
    return {n: f.launches for n, f in kernel_wrappers().items()}


def add_launches(counts: dict, times: int) -> None:
    """Add ``times`` × ``counts[name]`` to each kernel's count: the launches
    of ``times`` replays of a CUDA graph whose capture recorded ``counts``
    (by name, as :func:`launch_counts` gives).  ``times=-1`` takes back what
    the wrappers counted while the graph was captured, which launched
    nothing."""
    wrappers = kernel_wrappers()
    for name, c in counts.items():
        wrappers[name].launches += c * times
