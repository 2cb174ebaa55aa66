"""Entry points of the kernel backend (the port of ``repro/kernels/ops.py``).

The SF hot path calls ``pack_rows``, ``segment_reduce_rows`` and
``local_bcast_rows``.  Each is *autotuned* (:mod:`repro_torch.kernels.
tuning`) over its hand kernels' own variants, under the reference's three
kinds; there is no library candidate, so the path always runs the kernels
and a kernel that fails to build raises:

  * ``pack``: ``"row"``, the wide gather ``pack`` (aligned 16-byte output
    vectors whatever the row's width and base offsets, a warp per chunk of
    up to 2 KB of a row, rows split across warps when they are few, grid
    from ``sf_pack.wide_plan``), and ``"block:B"``, ``pack_blocked`` at
    ``block_rows=B`` (rows of 1–4 32-bit words take its narrow kernel, 4
    rows per thread, grid from ``sf_pack.row_plan``; other rows its generic
    loop, B rows per CTA), B from the reference's block sizes and
    ``PACK_BLOCK_ROWS``;
  * ``segred``: ``"row"``, one segment per CTA (``segment_reduce_sorted``),
    and ``"block:SB"``, ``segment_reduce_blocked`` at SB segments per CTA
    (``core.redplan.seg_block_candidates`` and ``SEG_BLOCK``).  Segments
    longer than ``sf_unpack.LONG_SEG`` rows take the long route in either
    (``sf_unpack.reduce_route``);
  * ``localbcast``: ``"fused"``, ``bcast_fused``'s own plan, and, for rows
    of 1–4 words, ``"generic"``, its generic loop (``sf_pack.bcast_variant``).

The default of every kind is the fixed rule the port had before the tuner:
rows of ``WIDE_ROW`` elements or more take ``"row"``, narrower ones
``"block:64"``; the local bcast takes ``"fused"``.  With
``REPRO_SF_AUTOTUNE=0``, or on the CPU (where every candidate is the same
plain version), every call takes that default.  Sweeps time the call's own
tensors and launch nothing into the launch counters: the counters are put
back after a sweep, so a path counts only its own calls.  ``key=`` scopes
the winner per communication pattern (callers pass their plan's
``comm_signature()``).

A strided box (``pack_strided_rows``) takes the route and grid that
``sf_pack.strided_plan`` computes, untuned, as in the reference.  Index
lists are prepared once per source array and device (int32 upload and
bounds check, :mod:`repro_torch.kernels._index`), so repeat exchanges on
one plan cost no conversion.  A routing index that is new every step takes
``pack_rows(..., dynamic=True)`` instead, and segments written on the
device each step ``segment_reduce_rows(..., dynamic=True)``: the fixed
rule, no sweep, no host read and no cache entry, and the gather kernels
check the bounds on the device.  The direct entry points ``sf_pack``,
``sf_pack_strided``, ``sf_unpack`` and ``spmv_ell`` call one kernel each.

``flash_attention`` is the serving path's prefill attention core (the
reference's ``_chunked_attn`` function, computed by the hand-written
kernel; ``models/layers.py::attention`` calls it).
"""

from __future__ import annotations

import math

import torch

import numpy as np

from . import ref, tuning
from ._index import segment_meta
from .sf_pack import (bcast_fused, bcast_variant, inverse_map, pack,
                      pack_blocked, pack_strided)
from .sf_unpack import (segment_reduce_blocked, segment_reduce_sorted,
                        unpack_segments)
from .spmv_ell import spmv_ell
from .flash_attention import flash_attention
from ..core.redplan import seg_block_candidates

__all__ = [
    "PACK_BLOCK_ROWS", "SEG_BLOCK", "WIDE_ROW",
    "pack_rows", "segment_reduce_rows", "local_bcast_rows", "inverse_map",
    "pack_strided_rows", "pack_candidates", "segred_candidates",
    "localbcast_candidates",
    "sf_pack", "sf_pack_strided", "sf_unpack", "spmv_ell", "flash_attention",
    "ref", "tuning",
    "kernel_wrappers", "reset_launch_counts", "launch_counts",
    "add_launches",
]

PACK_BLOCK_ROWS = 64
SEG_BLOCK = 64
WIDE_ROW = 256

# (kind, *signature) -> the winning candidate: a repeat call costs one
# dictionary lookup
_DISPATCH: dict = {}
tuning.register_cache(_DISPATCH)


def _row_elems(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:])     # per launch: cheaper than np.prod


def _count(idx) -> int:
    return idx.numel() if isinstance(idx, torch.Tensor) else int(np.size(idx))


def _tuned(key: tuple, candidates: dict, args: tuple, default: str,
           work: int, device: torch.device):
    """The winning candidate of ``key`` = (kind, *signature), swept on
    ``args``; the launch counters are put back after a sweep.  A winner
    that the tuner memoized is kept in ``_DISPATCH``."""
    saved = _saved_counts()
    try:
        winner = tuning.autotune(key[0], key[1:], candidates, args,
                                 default=default, work=work, device=device)
    finally:
        _restore_counts(saved)
    fn = candidates[winner]
    if tuning.lookup(key) is not None:
        _DISPATCH[key] = fn
    return fn


# --------------------------------------------------------------------------
# pack: tuned row gather
# --------------------------------------------------------------------------
def _pack_block_sizes(M: int) -> list:
    """The reference's CTA tiles (``ops.py`` ``_pack_block_sizes``) and the
    fixed rule's ``PACK_BLOCK_ROWS``."""
    cands = {min(M, b) for b in (8, 32, 128, 512)} | {PACK_BLOCK_ROWS}
    if M <= 2048:
        cands.add(M)          # one CTA tile
    return sorted(b for b in cands if b >= 1)


def _pack_kernel(name: str, dynamic: bool = False):
    """The gather a ``pack`` candidate name names: ``f(data, idx)``."""
    if name == "row":
        return lambda d, i: pack(d, i, dynamic=dynamic)
    B = int(name.split(":")[1])
    return lambda d, i: pack_blocked(d, i, block_rows=B, dynamic=dynamic)


def pack_candidates(M: int) -> dict:
    """``pack``'s candidates for ``M`` gathered rows: name -> ``f(data,
    idx)``."""
    names = ["row"] + [f"block:{B}" for B in _pack_block_sizes(M)]
    return {n: _pack_kernel(n) for n in names}


def _pack_default(data: torch.Tensor) -> str:
    """The fixed rule: wide rows take the wide gather, others 64 a CTA."""
    return "row" if _row_elems(data) >= WIDE_ROW \
        else f"block:{PACK_BLOCK_ROWS}"


def pack_rows(data: torch.Tensor, idx, *, dynamic: bool = False,
              key=None) -> torch.Tensor:
    """``data[idx]`` row gather through the tuned pack kernels, for rows of
    any unit shape and dtype; ``idx`` is a numpy array or an integer tensor
    on ``data``'s device.  ``key`` (a plan's ``comm_signature()``) scopes
    the winner per communication pattern.

    ``dynamic=True`` is the route for an index written on the device this
    step (``DynPlan``'s routing, new every call): the fixed rule, used as
    it is, with no sweep, no host read and no cache entry, and the kernel
    checks every index against ``data``'s rows on the device and traps on
    one outside them.  On the CPU the plain version checks the range first
    and raises."""
    if dynamic:
        return _pack_kernel(_pack_default(data), dynamic=True)(data, idx)
    M = _count(idx)
    sig = ("pack", int(data.shape[0]), M, tuple(data.shape[1:]),
           str(data.dtype), data.device.type, key)
    fn = _DISPATCH.get(sig)
    if fn is None:
        fn = _tuned(sig, pack_candidates(M), (data, idx), _pack_default(data),
                    M * _row_elems(data), data.device)
    return fn(data, idx)


def pack_strided_rows(data: torch.Tensor, strided) -> torch.Tensor:
    """The rows a :class:`repro_torch.core.patterns.Strided3D` enumerates,
    through the strided pack kernels (route and grid from
    ``sf_pack.strided_plan``)."""
    return pack_strided(data, start=strided.start, dims=strided.dims,
                        strides=strided.strides)


# --------------------------------------------------------------------------
# segment reduce: tuned sorted-buffer reduction
# --------------------------------------------------------------------------
def _segred_kernel(name: str, op: str):
    """The fold a ``segred`` candidate name names: ``f(vals, seg_first,
    seg_len)``."""
    if name == "row":
        return lambda v, f, l: segment_reduce_sorted(v, f, l, op=op)
    SB = int(name.split(":")[1])
    return lambda v, f, l: segment_reduce_blocked(
        v, f, l, segs_per_block=SB, op=op)


def segred_candidates(nseg: int, lmax: int, op: str) -> dict:
    """``segred``'s candidates for ``nseg`` segments whose longest has
    ``lmax`` rows: name -> ``f(vals, seg_first, seg_len)``."""
    blocks = sorted(set(seg_block_candidates(nseg, lmax)) | {SEG_BLOCK})
    names = ["row"] + [f"block:{SB}" for SB in blocks]
    return {n: _segred_kernel(n, op) for n in names}


def _segred_default(sorted_vals: torch.Tensor) -> str:
    """The fixed rule: wide rows one segment a CTA, others 64 a CTA."""
    return "row" if _row_elems(sorted_vals) >= WIDE_ROW \
        else f"block:{SEG_BLOCK}"


def segment_reduce_rows(sorted_vals: torch.Tensor, seg_first, seg_len, *,
                        op: str = "sum", key=None,
                        dynamic: bool = False) -> torch.Tensor:
    """One row per segment of a destination-sorted row buffer (sum, prod,
    max, min), folded in buffer order by the tuned segment-reduce kernels
    (every candidate gives the same bits).  ``key`` scopes the winner per
    communication pattern; ``dynamic=True`` (segments written on the device
    this step) takes the fixed rule without a sweep."""
    if dynamic:
        return _segred_kernel(_segred_default(sorted_vals), op)(
            sorted_vals, seg_first, seg_len)
    S = _count(seg_first)
    _, _, _, lmax = segment_meta(seg_first, seg_len, sorted_vals.device)
    sig = ("segred", int(sorted_vals.shape[0]), S, int(lmax),
           tuple(sorted_vals.shape[1:]), str(sorted_vals.dtype), op,
           sorted_vals.device.type, key)
    fn = _DISPATCH.get(sig)
    if fn is None:
        fn = _tuned(sig, segred_candidates(S, lmax, op),
                    (sorted_vals, seg_first, seg_len),
                    _segred_default(sorted_vals),
                    int(sorted_vals.shape[0]) * _row_elems(sorted_vals),
                    sorted_vals.device)
    return fn(sorted_vals, seg_first, seg_len)


# --------------------------------------------------------------------------
# fused local exchange: tuned leaf[gl] = root[gr]
# --------------------------------------------------------------------------
def localbcast_candidates(leafdata: torch.Tensor) -> dict:
    """``localbcast``'s candidates for these leaf rows: name -> ``f(root,
    leaf, src_of_leaf)``.  Rows of 1–4 words (or cast elements) have two
    routes, the narrow kernel ``bcast_fused`` plans and the generic loop;
    other rows one."""
    impls = {"fused": bcast_fused}
    rb = _row_elems(leafdata) * leafdata.element_size()
    if (rb % 4 == 0 and 1 <= rb // 4 <= 4) or 1 <= _row_elems(leafdata) <= 4:
        impls["generic"] = _bcast_generic
    return impls


def _bcast_generic(rootdata, leafdata, src_of_leaf) -> torch.Tensor:
    """``localbcast``'s ``"generic"`` candidate: ``bcast_fused``'s generic
    loop, counted in ``bcast_fused.launches`` where it launches (it runs on
    the path; ``bcast_variant`` itself counts nothing)."""
    out = bcast_variant(rootdata, leafdata, src_of_leaf, route="generic")
    if leafdata.is_cuda and leafdata.shape[0] and _row_elems(leafdata):
        bcast_fused.launches += 1
    return out


def local_bcast_rows(rootdata: torch.Tensor, leafdata: torch.Tensor,
                     src_of_leaf, *, key=None) -> torch.Tensor:
    """Local-only bcast through the tuned fused kernel: a copy of
    ``leafdata`` with every leaf that has a root (``src_of_leaf >= 0``,
    built once by :func:`inverse_map`) replaced by its root's row."""
    sig = ("localbcast", tuple(rootdata.shape), tuple(leafdata.shape),
           str(rootdata.dtype), str(leafdata.dtype), leafdata.device.type,
           key)
    fn = _DISPATCH.get(sig)
    if fn is None:
        fn = _tuned(sig, localbcast_candidates(leafdata),
                    (rootdata, leafdata, src_of_leaf), "fused",
                    int(leafdata.shape[0]) * _row_elems(leafdata),
                    leafdata.device)
    return fn(rootdata, leafdata, src_of_leaf)


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


def _saved_counts() -> tuple:
    return (launch_counts(), flash_attention.launches_sm90,
            dict(pack_strided.routes))


def _restore_counts(saved: tuple) -> None:
    counts, sm90, routes = saved
    for name, f in kernel_wrappers().items():
        f.launches = counts[name]
    flash_attention.launches_sm90 = sm90
    pack_strided.routes = routes


def add_launches(counts: dict, times: int) -> None:
    """Add ``times`` × ``counts[name]`` to each kernel's count: the launches
    of ``times`` replays of a CUDA graph whose capture recorded ``counts``
    (by name, as :func:`launch_counts` gives).  ``times=-1`` takes back what
    the wrappers counted while the graph was captured, which launched
    nothing."""
    wrappers = kernel_wrappers()
    for name, c in counts.items():
        wrappers[name].launches += c * times
