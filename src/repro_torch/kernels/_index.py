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

__all__ = ["device_index", "segment_meta", "require_cuda_tensor"]

_CACHE: dict = {}
_INT32_MAX = 2 ** 31 - 1


def _key_source(obj):
    return obj if isinstance(obj, (torch.Tensor, np.ndarray)) else None


def _cached(sources: tuple, device: torch.device, tag: str, build):
    """``build()`` memoized on the identity and version of ``sources``."""
    objs = [_key_source(s) for s in sources]
    if any(o is None for o in objs):
        return build()
    key = (tag, str(device)) + tuple(id(o) for o in objs)
    versions = tuple(getattr(o, "_version", 0) for o in objs)
    hit = _CACHE.get(key)
    if hit is not None:
        refs, vers, value = hit
        if vers == versions and all(r() is o for r, o in zip(refs, objs)):
            return value
    value = build()

    def _drop(_ref, key=key, cache=_CACHE):
        # the dict is bound here: at interpreter exit the module's globals
        # are cleared before the last weak references die
        cache.pop(key, None)

    _CACHE[key] = (tuple(weakref.ref(o, _drop) for o in objs), versions,
                   value)
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
    if t.numel():
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
    return _cached((idx,), device, "index", build)


def segment_meta(seg_start, seg_len, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """``(start, length, max end, max length)`` of per-segment metadata as
    int32 tensors on ``device``; raises on a negative start or length."""
    def build():
        st = _as_int32(seg_start, device, "seg_start").reshape(-1)
        ln = _as_int32(seg_len, device, "seg_len").reshape(-1)
        if st.shape != ln.shape:
            raise ValueError(f"seg_start has {st.numel()} entries, seg_len "
                             f"{ln.numel()}")
        if st.numel() == 0:
            return st, ln, 0, 0
        if int(st.min()) < 0 or int(ln.min()) < 0:
            raise ValueError("negative segment start or length")
        end = int((st.to(torch.int64) + ln).max())
        return st, ln, end, int(ln.max())
    return _cached((seg_start, seg_len), device, "segments", build)


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
