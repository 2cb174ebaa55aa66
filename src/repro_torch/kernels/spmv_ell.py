"""Local sparse matrix-vector product in ELLPACK format — the Hopper port of
``repro/kernels/spmv_ell.py``.

The local-compute half of the paper's §4.1 SpMV (``y = A x_local`` while
the SF bcast is in flight).  Every row is padded to K nonzeros; padding
columns point at a trailing zero the caller appends to ``x``.
``csrc/spmv_ell.cu`` runs one thread per row and folds its K products in
the data's type, reading ``x`` through the read-only cache; its note gives
the bound (bytes) and the design.  ``spmv_ell.launches`` counts launches.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from ._index import device_index, require_cuda_tensor

__all__ = ["spmv_ell", "spmv_ell_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def spmv_ell_plain(data: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y[i] = Σ_k data[i,k] * x[cols[i,k]]."""
    return (data * x[cols.long()]).sum(dim=1)


def spmv_ell(data: torch.Tensor, cols, x: torch.Tensor) -> torch.Tensor:
    """y[i] = Σ_k data[i,k] * x[cols[i,k]].  data/cols: (N, K) float32 or
    float64 / integers; x: (Nx,) of data's dtype.  Returns (N,)."""
    if data.dim() != 2 or x.dim() != 1:
        raise ValueError(f"spmv_ell takes data (N, K) and x (Nx,), got "
                         f"{tuple(data.shape)} and {tuple(x.shape)}")
    if data.dtype not in _DTYPE_CODES or x.dtype != data.dtype:
        raise TypeError(f"spmv_ell takes float32 or float64 data and x of "
                        f"the same dtype, got {data.dtype} and {x.dtype}")
    if x.device != data.device:
        raise ValueError(f"x on {x.device}, data on {data.device}")
    c, lo, hi = device_index(cols, data.device, "cols")
    N, K = (int(s) for s in data.shape)
    if tuple(c.shape) != (N, K):
        raise ValueError(f"cols has shape {tuple(c.shape)}, data {(N, K)}")
    if c.numel() and (lo < 0 or hi >= int(x.shape[0])):
        raise IndexError(f"cols range [{lo}, {hi}] outside x of "
                         f"{int(x.shape[0])} entries")
    if data.device.type == "cpu":
        return spmv_ell_plain(data, c, x)
    require_cuda_tensor(data, "data")
    require_cuda_tensor(x, "x")
    y = torch.empty((N,), dtype=data.dtype, device=data.device)
    if N == 0:
        return y
    if K == 0:
        return y.zero_()
    _build.launch("sf_spmv_ell", data.data_ptr(), c.data_ptr(), x.data_ptr(),
                  y.data_ptr(), N, K, _DTYPE_CODES[data.dtype],
                  _build.stream_of(data))
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
