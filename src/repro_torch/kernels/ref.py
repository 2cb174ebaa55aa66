"""Oracles under the reference's names (``repro/kernels/ref.py``), pointing
at the plain PyTorch versions that sit beside each kernel."""

from __future__ import annotations

import torch

from .sf_pack import pack_plain, pack_strided_plain
from .sf_unpack import segment_reduce_plain
from .spmv_ell import spmv_ell_plain
from .flash_attention import flash_attention_plain

__all__ = ["pack_ref", "pack_strided_ref", "unpack_segment_ref",
           "flash_attention_ref", "spmv_ell_ref"]


def pack_ref(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather-pack: out[i] = data[idx[i]] (paper §5.2 rootbuf packing)."""
    return pack_plain(data, torch.as_tensor(idx, device=data.device))


def pack_strided_ref(data: torch.Tensor, start: int, dims,
                     strides) -> torch.Tensor:
    """Parametric 3D-subdomain pack (paper §5.2 ¶3): no index array."""
    return pack_strided_plain(data, start, dims, strides)


def unpack_segment_ref(buf: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """Segment-reduce of a buffer sorted by destination: ``seg_ids`` is the
    (non-decreasing) segment of each row."""
    seg_ids = torch.as_tensor(seg_ids, device=buf.device).long()
    length = torch.bincount(seg_ids, minlength=int(num_segments))
    start = torch.cumsum(length, 0) - length
    return segment_reduce_plain(buf, start, length, op)


# plain softmax attention: q (Sq, H, D), k/v (Skv, Hkv, D), positions aligned
# at the end, fully masked rows 0
flash_attention_ref = flash_attention_plain


def spmv_ell_ref(data: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV: y[i] = Σ_k data[i,k] * x[cols[i,k]]."""
    return spmv_ell_plain(data, torch.as_tensor(cols, device=data.device), x)
