"""Flash attention forward — the Hopper port of
``repro/kernels/flash_attention.py``.

GQA softmax attention, forward only: ``q (Sq, H, D)``, ``k, v (Skv, Hkv,
D)`` with ``Hkv | H``; query row i sits at absolute position ``Skv - Sq +
i`` (end-aligned, so one kernel serves prefill and prefix-cache queries);
``causal`` keeps keys at or before the query's position, ``window`` keeps
keys after ``qpos - window``; ``scale`` defaults to ``1/sqrt(D)``.  The
softmax and the accumulation run in float32 and the output has q's dtype.
A query row that sees no key returns 0, as ``ref.flash_attention_ref`` does
(the Pallas kernel returns the mean of v there).  A leading batch dimension,
``(B, Sq, H, D)``, is accepted as well and goes into the kernel's grid.

``csrc/flash_attention.cu`` is the kernel: bf16 on the tensor cores
(``mma.sync``), float32 with fp32 FMAs, head sizes 16, 32, 64 and 128; its
note gives the bound and the design.  ``flash_attention.launches`` counts
launches.  The wrapper takes the plain version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises.  There is no backward
kernel yet, so an input that requires grad raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from ._index import require_cuda_tensor

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 3}
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None,
                          scale=None) -> torch.Tensor:
    """Softmax attention written out in float32, GQA by grouping the query
    heads of each KV head (no repeated K/V)."""
    batched = q.dim() == 4
    if not batched:
        q, k, v = q[None], k[None], v[None]
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    qg = q.float().reshape(B, Sq, Hkv, rep, D)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    # a row that sees no key: softmax gives NaN, the contract gives 0
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v.float())
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    return out if batched else out[0]


def _check(q, k, v):
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"flash_attention takes q (Sq, H, D) and k, v "
                         f"(Skv, Hkv, D), optionally with a leading batch "
                         f"dimension; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    H, D, Hkv = q.shape[-2], q.shape[-1], k.shape[-2]
    if k.shape[-1] != D or q.shape[:-3] != k.shape[:-3]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} KV "
                         f"heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention has no backward kernel yet; "
                           "call it on tensors that do not require grad")


def _window_arg(window, Sq: int, Skv: int):
    """(has_window, window) for the kernel; a window of Skv keys or more
    masks nothing, and a window below -(Sq + Skv) masks no more than that."""
    if window is None or int(window) >= Skv:
        return 0, 0
    return 1, max(int(window), -(Sq + Skv))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    scale=None) -> torch.Tensor:
    """q: (Sq, H, D); k, v: (Skv, Hkv, D) with Hkv | H (or all with a
    leading batch dimension).  Returns q's shape and dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        require_cuda_tensor(t, what)
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary")
    batched = q.dim() == 4
    B = int(q.shape[0]) if batched else 1
    Sq, H, D = (int(s) for s in q.shape[-3:])
    Skv, Hkv = int(k.shape[-3]), int(k.shape[-2])
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head sizes {HEAD_DIMS}, got {D}")
    if max(Sq, Skv) >= 2 ** 30:
        raise ValueError("sequence too long for the kernel's int32 positions")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    has_window, win = _window_arg(window, Sq, Skv)
    sc = 1.0 / math.sqrt(D) if scale is None else float(scale)
    _build.launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), B, Sq, Skv, H, Hkv, D,
                  int(bool(causal)), has_window, win, sc,
                  _DTYPE_CODES[q.dtype], _build.stream_of(q))
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
