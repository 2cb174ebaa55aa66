"""SF pack: gather rows into a contiguous send buffer, and the fused local
bcast — the Hopper port of ``repro/kernels/sf_pack.py``.

Paper §5.2/§5.3: ``rootbuf[i] = rootdata[rootidx[i]]`` executed as a device
kernel.  One CUDA kernel (``csrc/sf_pack.cu``) copies whole rows as raw
bytes, so every dtype and every unit shape ``(n, *unit)`` goes through the
same code; the source row comes from an int32 index list or is computed
from a 3D box.  The source's note gives the bound (bytes) and the design.

Entry points (each counts its launches in ``<function>.launches``):
  * ``pack``          — one row per CTA (Pallas ``pack``, one row per step);
  * ``pack_blocked``  — ``block_rows`` rows per CTA (Pallas ``pack_blocked``);
  * ``pack_strided``  — paper §5.2 ¶3 parametric pack: rows
                        ``start + i + j*sy + k*sz`` for (i,j,k) < dims, k
                        outer, then j, then i; no index array exists;
  * ``bcast_fused``   — ``out[l] = cast(root[src_of_leaf[l]])`` where the
                        inverse map is set, else ``leaf[l]``: the local
                        pack→unpack of paper §5.2's local/remote split in
                        one race-free pass (``inverse_map`` builds the map
                        at setup).

Each has a plain PyTorch version (``*_plain``).  A wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ._index import device_index, require_cuda_tensor

__all__ = ["pack", "pack_blocked", "pack_strided", "bcast_fused",
           "inverse_map", "pack_plain", "pack_strided_plain",
           "bcast_fused_plain"]

# dtype codes of the cast kernel (csrc/sf_pack.cu)
_CAST_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 3}


def _row_bytes(t: torch.Tensor) -> int:
    return int(np.prod(t.shape[1:], dtype=np.int64)) * t.element_size()


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ------------------------------------------------------------------ plain
def pack_plain(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = data[idx[i]]."""
    return data[idx.long()]


def strided_rows(start: int, dims, strides, device=None) -> torch.Tensor:
    """The rows a strided pack reads, k outer, then j, then i."""
    dx, dy, dz = (int(d) for d in dims)
    sx, sy, sz = (int(s) for s in strides)
    i = torch.arange(dx, device=device)[None, None, :] * sx
    j = torch.arange(dy, device=device)[None, :, None] * sy
    k = torch.arange(dz, device=device)[:, None, None] * sz
    return (int(start) + (i + j + k)).reshape(-1)


def pack_strided_plain(data: torch.Tensor, start: int, dims,
                       strides) -> torch.Tensor:
    return data[strided_rows(start, dims, strides, data.device)]


def bcast_fused_plain(rootdata: torch.Tensor, leafdata: torch.Tensor,
                      src_of_leaf: torch.Tensor) -> torch.Tensor:
    src = src_of_leaf.long()
    hit = src >= 0
    out = leafdata.clone()
    out[hit] = rootdata[src[hit]].to(leafdata.dtype)
    return out


# ---------------------------------------------------------------- kernels
def _gather(counter, data: torch.Tensor, idx, rows_per_cta: int
            ) -> torch.Tensor:
    idx, lo, hi = device_index(idx, data.device, "idx")
    N = int(data.shape[0])
    if idx.numel() and (lo < 0 or hi >= N):
        raise IndexError(f"pack index range [{lo}, {hi}] outside the "
                         f"{N} rows of data")
    if _on_cpu(data):
        return pack_plain(data, idx)
    require_cuda_tensor(data, "data")
    out = torch.empty(tuple(idx.shape) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    M, rb = idx.numel(), _row_bytes(data)
    if M == 0 or rb == 0:
        return out
    if -(-M // rows_per_cta) >= 2 ** 31:
        raise ValueError(f"{M} rows need more than 2**31 CTAs")
    _build.launch("sf_gather_rows", data.data_ptr(), out.data_ptr(),
                  idx.data_ptr(), M, rb, int(rows_per_cta),
                  _build.stream_of(data))
    counter.launches += 1
    return out


def pack(data: torch.Tensor, idx) -> torch.Tensor:
    """out[i] = data[idx[i]], one row per CTA.  data: (N, *unit) of any
    dtype; idx: (M,) integers (tensor on data's device, or numpy)."""
    return _gather(pack, data, idx, 1)


def pack_blocked(data: torch.Tensor, idx, *, block_rows: int
                 ) -> torch.Tensor:
    """out[i] = data[idx[i]] with ``block_rows`` rows per CTA."""
    if int(block_rows) < 1:
        raise ValueError("block_rows must be >= 1")
    return _gather(pack_blocked, data, idx, int(block_rows))


def pack_strided(data: torch.Tensor, *, start: int, dims, strides,
                 block_rows: int = 64) -> torch.Tensor:
    """Pack rows ``start + i + j*sy + k*sz`` for (i,j,k) < dims (sx == 1),
    ``block_rows`` rows per CTA; output k outer, then j, then i."""
    dx, dy, dz = (int(d) for d in dims)
    sx, sy, sz = (int(s) for s in strides)
    if sx != 1:
        raise ValueError("pack_strided requires unit inner stride")
    if min(dx, dy, dz) < 0 or min(sy, sz) < 0 or int(start) < 0:
        raise ValueError("pack_strided needs non-negative start, dims and "
                         "strides")
    M = dx * dy * dz
    N = int(data.shape[0])
    if M and int(start) + (dx - 1) + (dy - 1) * sy + (dz - 1) * sz >= N:
        raise IndexError(f"strided box reaches past the {N} rows of data")
    if _on_cpu(data):
        return pack_strided_plain(data, start, dims, strides)
    require_cuda_tensor(data, "data")
    out = torch.empty((M,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    rb = _row_bytes(data)
    if M == 0 or rb == 0:
        return out
    _build.launch("sf_gather_strided", data.data_ptr(), out.data_ptr(), M,
                  rb, int(block_rows), int(start), dx, dy, sy, sz,
                  _build.stream_of(data))
    pack_strided.launches += 1
    return out


def inverse_map(gr: np.ndarray, gl: np.ndarray, nleaf: int) -> np.ndarray:
    """``src_of_leaf[l]`` = root row feeding leaf ``l``, or -1: the setup
    product of the fused bcast.  ``gl`` must be duplicate-free."""
    gr = np.asarray(gr, dtype=np.int64)
    gl = np.asarray(gl, dtype=np.int64)
    if np.unique(gl).size != gl.size:
        raise ValueError("bcast_fused needs duplicate-free leaf indices")
    src = np.full(int(nleaf), -1, dtype=np.int32)
    src[gl] = gr
    return src


def bcast_fused(rootdata: torch.Tensor, leafdata: torch.Tensor,
                src_of_leaf) -> torch.Tensor:
    """A copy of ``leafdata`` with row ``l`` replaced by
    ``rootdata[src_of_leaf[l]]`` cast to the leaf dtype wherever the map is
    >= 0.  Same dtypes copy bytes (any dtype); float32 / float64 / bfloat16
    pairs cast; other pairs raise."""
    Nl, Nr = int(leafdata.shape[0]), int(rootdata.shape[0])
    if tuple(rootdata.shape[1:]) != tuple(leafdata.shape[1:]):
        raise ValueError(f"root rows {tuple(rootdata.shape[1:])} and leaf "
                         f"rows {tuple(leafdata.shape[1:])} differ")
    src, lo, hi = device_index(src_of_leaf, leafdata.device, "src_of_leaf")
    if src.shape != (Nl,):
        raise ValueError(f"src_of_leaf has shape {tuple(src.shape)}, want "
                         f"({Nl},)")
    if Nl and (lo < -1 or hi >= Nr):
        raise IndexError(f"src_of_leaf range [{lo}, {hi}] outside the {Nr} "
                         f"root rows")
    same = rootdata.dtype == leafdata.dtype
    if not same and (rootdata.dtype not in _CAST_CODES
                     or leafdata.dtype not in _CAST_CODES):
        raise TypeError(f"bcast_fused casts only between float32, float64 "
                        f"and bfloat16, not {rootdata.dtype} -> "
                        f"{leafdata.dtype}")
    if rootdata.device != leafdata.device:
        raise ValueError(f"rootdata on {rootdata.device}, leafdata on "
                         f"{leafdata.device}")
    if _on_cpu(leafdata):
        return bcast_fused_plain(rootdata, leafdata, src)
    require_cuda_tensor(rootdata, "rootdata")
    require_cuda_tensor(leafdata, "leafdata")
    out = torch.empty_like(leafdata)
    rb = _row_bytes(leafdata)
    if Nl == 0 or rb == 0:
        return out
    rows_per_cta = 64
    stream = _build.stream_of(leafdata)
    if same:
        _build.launch("sf_bcast_fused_copy", rootdata.data_ptr(),
                      leafdata.data_ptr(), out.data_ptr(), src.data_ptr(), Nl,
                      rb, rows_per_cta, stream)
    else:
        _build.launch("sf_bcast_fused_cast", rootdata.data_ptr(),
                      leafdata.data_ptr(), out.data_ptr(), src.data_ptr(), Nl,
                      rb // leafdata.element_size(),
                      _CAST_CODES[rootdata.dtype],
                      _CAST_CODES[leafdata.dtype], rows_per_cta, stream)
    bcast_fused.launches += 1
    return out


for _f in (pack, pack_blocked, pack_strided, bcast_fused):
    _f.launches = 0
