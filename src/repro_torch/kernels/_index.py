"""Prepared index tensors for the kernels, cached per index array.

A kernel takes its row indices as a contiguous int32 tensor on the data's
device, checked against the rows it may touch before any pointer reaches
CUDA.  Preparing one (conversion, upload, bounds) costs a copy and, for a
device tensor, a device-to-host read; the SF plans hand the same index
arrays to every exchange, so the prepared tensor and its bounds are cached
per source array and device, and a repeat call costs two dictionary
lookups.  An entry lives as long as its source array (a weak reference
drops it); a torch source is re-prepared after an in-place change (its
``_version`` moves).  numpy index arrays are treated as immutable once
they have been used.
"""

from __future__ import annotations

import weakref
from typing import Tuple

import numpy as np
import torch

__all__ = ["device_index", "segment_meta", "require_cuda_tensor",
           "cached"]

_CACHE: dict = {}
_INT32_MAX = 2 ** 31 - 1


def _key_source(obj):
    return obj if isinstance(obj, (torch.Tensor, np.ndarray)) else None


class _Source:
    """The place of a source tensor (``flat``: its flat view) in a cached
    value: an entry holding its own source would keep it alive, and the
    weak reference that drops the entry would never fire."""
    __slots__ = ("i", "flat")

    def __init__(self, i: int, flat: bool):
        self.i, self.flat = i, flat


def _unalias(value, objs) -> tuple:
    """(``value`` with each tensor that is a source, or a source's flat
    view, replaced by a :class:`_Source`; whether any was)."""
    if not isinstance(value, tuple):
        return value, False
    out, found = [], False
    for v in value:
        for i, o in enumerate(objs):
            if isinstance(v, torch.Tensor) and isinstance(o, torch.Tensor) \
                    and (v is o or v.dim() == 1 and o.is_contiguous()
                         and v.numel() == o.numel() and v.dtype == o.dtype
                         and v.device == o.device
                         and v.data_ptr() == o.data_ptr()):
                v, found = _Source(i, v is not o), True
                break
        out.append(v)
    return tuple(out), found


def cached(sources: tuple, device: torch.device, tag: str, build):
    """``build()`` memoized on the identity and version of ``sources``;
    the entry holds no strong reference to a source (a value that
    returns one gets it back from the caller's ``sources``)."""
    objs = [_key_source(s) for s in sources]
    if any(o is None for o in objs):
        return build()
    key = (tag, str(device)) + tuple(id(o) for o in objs)
    versions = tuple(getattr(o, "_version", 0) for o in objs)
    hit = _CACHE.get(key)
    if hit is not None:
        refs, vers, value, aliased = hit
        if vers == versions and all(r() is o for r, o in zip(refs, objs)):
            if not aliased:
                return value
            return tuple((objs[v.i].reshape(-1) if v.flat else objs[v.i])
                         if isinstance(v, _Source) else v for v in value)
    value = build()

    def _drop(_ref, key=key, cache=_CACHE):
        # the dict is bound here: at interpreter exit the module's globals
        # are cleared before the last weak references die
        cache.pop(key, None)

    _CACHE[key] = (tuple(weakref.ref(o, _drop) for o in objs), versions,
                   *_unalias(value, objs))
    return value


def _as_int32(idx, device: torch.device, what: str) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        if idx.device != device:
            raise ValueError(f"{what} is on {idx.device}, the data on "
                             f"{device}; move it there explicitly")
        if idx.dtype.is_floating_point or idx.dtype == torch.bool:
            raise TypeError(f"{what} must be an integer tensor, got "
                            f"{idx.dtype}")
        t = idx
    else:
        a = np.asarray(idx)
        if a.size and not np.issubdtype(a.dtype, np.integer):
            raise TypeError(f"{what} must hold integers, got {a.dtype}")
        t = torch.as_tensor(a.astype(np.int64, copy=False), device=device)
    if t.numel() and t.dtype != torch.int32:
        lo, hi = (int(v) for v in torch.aminmax(t.reshape(-1)))
        if lo < -_INT32_MAX or hi > _INT32_MAX:
            raise ValueError(f"{what} does not fit in int32")
    return t.to(torch.int32).contiguous()


def device_index(idx, device: torch.device, what: str = "index"
                 ) -> Tuple[torch.Tensor, int, int]:
    """``(int32 tensor on device, min, max)`` of an index array or tensor
    (min/max are 0/-1 for an empty index)."""
    def build():
        t = _as_int32(idx, device, what)
        if t.numel() == 0:
            return t, 0, -1
        lo, hi = (int(v) for v in torch.aminmax(t.reshape(-1)))
        return t, lo, hi
    return cached((idx,), device, "index", build)


def segment_meta(seg_start, seg_len, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """``(start, length, max end, max length)`` of per-segment metadata as
    int32 tensors on ``device``; raises on a negative start or length.
    For int32 tensors the four bounds come back in one host read."""
    def build():
        st, ln = (t if t.dim() == 1 else t.reshape(-1) for t in (
            _as_int32(seg_start, device, "seg_start"),
            _as_int32(seg_len, device, "seg_len")))
        if st.shape != ln.shape:
            raise ValueError(f"seg_start has {st.numel()} entries, seg_len "
                             f"{ln.numel()}")
        if st.numel() == 0:
            return st, ln, 0, 0
        st_min, ln_min, end, lmax = torch.stack([
            st.min().long(), ln.min().long(),
            (st.to(torch.int64) + ln).max(), ln.max().long()]).tolist()
        if st_min < 0 or ln_min < 0:
            raise ValueError("negative segment start or length")
        return st, ln, end, lmax
    return cached((seg_start, seg_len), device, "segments", build)


def require_cuda_tensor(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is a contiguous tensor on the current CUDA
    device (the kernels read raw pointers on the current context)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} is on {t.device}; the kernels take CPU "
                         f"tensors (plain version) or CUDA tensors")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what} is on {t.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
