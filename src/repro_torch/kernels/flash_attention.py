"""Flash attention — the Hopper port of
``repro/kernels/flash_attention.py``, and a backward of its own.

GQA softmax attention: ``q (Sq, H, D)``, ``k, v (Skv, Hkv,
D)`` with ``Hkv | H``; query row i sits at absolute position ``Skv - Sq +
i`` (end-aligned, so one kernel serves prefill and prefix-cache queries);
``causal`` keeps keys at or before the query's position, ``window`` keeps
keys after ``qpos - window``; ``scale`` defaults to ``1/sqrt(D)``.  The
softmax and the accumulation run in float32 and the output has q's dtype.
A query row that sees no key returns 0, as ``ref.flash_attention_ref`` does
(the Pallas kernel returns the mean of v there).  A leading batch dimension,
``(B, Sq, H, D)``, is accepted as well and goes into the kernel's grid.

Three routes, chosen by a fixed rule (:func:`route`):

  * bf16 with head size 64, 112 or 128 (every attention config of the
    repo: 64 hymba and whisper, 112 kimi-k2, 128 the rest) goes to
    ``csrc/flash_attention_sm90.cu``: TMA loads into a ring of K/V stages,
    a producer warpgroup and one or two consumer warpgroups on ``wgmma``,
    a persistent grid walking the tiles of :func:`tile_plan` longest first,
    with tiles of :func:`sm90_bc` keys (128 at head size 64 and 128-row
    tiles, else 64); head size 112 runs on the 128-wide tiles
    (:func:`sm90_width`: TMA reads columns 112-127 as zeros and drops
    them on the store);
  * unless, at head size 64 or 128, a KV head has at most
    :data:`SPLIT_ROWS` query rows (Sq x H / Hkv) over more than
    :data:`SPLIT_BC` keys (whisper's cross-attention at decode and at its
    4-token prefill); then the split-KV route
    (``flash_attention_split_fwd`` in ``csrc/flash_attention.cu``): the KV
    tiles cut into the ranges of :func:`split_plan`, a CTA per (range, KV
    head) on ``mma.sync`` with a ``cp.async`` ring, each range's partial
    output folded in range order
    by a second kernel.  Head size 112 stays on the wgmma kernel at every
    row count (no path gives kimi-k2's attention such a call: its decode
    attention is the plain ``decode_core``);
  * everything else (float32, bf16 head sizes 16 and 32) goes to
    ``csrc/flash_attention.cu``: ``mma.sync`` for bf16, fp32 FMAs for
    float32, at head sizes 16, 32, 64, 112 and 128 (:data:`HEAD_DIMS`).

A head size outside :data:`HEAD_DIMS` raises, on the card and in the
operators' fakes (the dry run) alike.

Each source's note gives its bound and design.  ``flash_attention.launches``
counts the calls of all three (one a call), ``flash_attention.launches_sm90``
those of the first and ``flash_attention.launches_split`` those of the
second.  The wrapper takes the plain version only for tensors on the CPU;
for a CUDA tensor it launches a route's kernels or raises.  The wrapper has
no backward, so an input that requires grad raises there.

Training goes through :class:`FlashAttention` (``kernels.ops.
flash_attention`` takes it when grad mode is on and an input requires a
gradient): its forward is the kernel on detached inputs and, where the
backward takes the sm90 route, also writes each row's base-2 log-sum-exp
(either forward route writes it)
(:func:`flash_attention_lse`, the operator
``torch.ops.repro_torch.flash_attention_lse``; the serving path asks for
none); its backward is :func:`flash_attention_backward`, the operator
``torch.ops.repro_torch.flash_attention_backward``.  On a CUDA tensor that
launches ``csrc/flash_attention_bwd.cu``'s deterministic kernels on the
walk of :func:`bwd_plan` and counts one launch of the set in
``flash_attention_backward.launches``: for bf16 at head sizes 64 and 128
(:func:`bwd_route` ``"sm90"``) ``flash_bwd_dq_sm90`` (query tiles outer,
reading the saved log-sum-exp: rowsum(dO * O) and dq) then
``flash_bwd_dkdv_sm90`` (KV tiles outer: dk and dv of each KV head summed
over its query heads in registers), both on wgmma and TMA; otherwise the
mma.sync kernels ``flash_bwd_dq`` and ``flash_bwd_dkdv`` (float32, and
bf16 at head sizes 16, 32 and 112; the log-sum-exp recomputed; under GQA
each query head's share summed by ``flash_bwd_dkdv_reduce``, as the
sm90 route does too where its plan splits the KV heads).  On a CPU tensor it is
:func:`flash_attention_backward_plain`, the same equations in float32
PyTorch.  The reference trains through its plain ``_chunked_attn`` and has
no backward kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ._index import require_cuda_tensor

__all__ = ["flash_attention", "flash_attention_plain", "FlashAttention",
           "flash_attention_lse", "flash_attention_backward",
           "flash_attention_backward_plain", "HEAD_DIMS", "flash_flops",
           "flash_bwd_flops", "bwd_plan", "BwdPlan", "bwd_route",
           "bwd_tiles", "SM90", "SM90_HEAD_DIMS", "SPLIT",
           "SPLIT_HEAD_DIMS", "SM90_BWD_HEAD_DIMS", "SPLIT_ROWS", "ROUTES",
           "route", "tile_plan", "TilePlan", "sm90_bc", "sm90_width",
           "sm90_smem_bytes",
           "split_plan", "SplitPlan", "flash_attention_split_plain",
           "launch_kernel"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 3}
LOG2E = 1.4426950408889634
SM90 = "flash_attention_sm90"
SPLIT = "flash_attention_split"
ROUTES = (SM90, SPLIT, "flash_attention")
# the head sizes the kernels take: every one the mma.sync kernels
# (forward and backward), of them the wgmma forward's, the split route's
# and the wgmma backward's
HEAD_DIMS = (16, 32, 64, 112, 128)
SM90_HEAD_DIMS = (64, 112, 128)
SPLIT_HEAD_DIMS = (64, 128)
SM90_BWD_HEAD_DIMS = (64, 128)
H100_SMS = 132
# the sm90 kernel's (keys per K/V tile, ring depth) at each (tile width,
# tile height) (csrc/flash_attention_sm90.cu: Tiles<W, br / 64>::BC,
# STAGES); head size D runs on the tiles of width sm90_width(D)
SM90_TILES = {(64, 64): (64, 2), (64, 128): (128, 3), (128, 64): (64, 2),
              (128, 128): (64, 2)}
# the split route: KV tiles of 128 keys (csrc/flash_attention.cu
# split::BC); a call whose KV heads have at most SPLIT_ROWS query rows each,
# over more than one such tile, takes it, its grid as many CTAs as fit
# SPLIT_WAVES waves of the SMs (PERF.md: flash_variants.py's readings, in
# turns with the sm90 kernel, at Sq x H / Hkv = 1 to 64 over 4 to 4,096
# keys)
SPLIT_BC = 128
SPLIT_ROWS = 16
SPLIT_WAVES = 1


def sm90_width(D: int) -> int:
    """The tile width (columns of q, k, v and o a tile holds) the sm90
    forward runs head size ``D`` on: whole 64-column TMA boxes, so 112
    runs on the 128-wide tiles, TMA filling columns 112-127 with zeros on
    load (they add nothing to q k^T and give o columns it never stores)."""
    return 64 * -(-D // 64)


def sm90_bc(D: int, br: int) -> int:
    """Keys per K/V tile of the sm90 forward at head size ``D`` and tile
    height ``br`` (:func:`tile_height`)."""
    return SM90_TILES[(sm90_width(D), br)][0]


def route(dtype: torch.dtype, D: int, rows: Optional[int] = None,
          keys: Optional[int] = None) -> str:
    """The kernel a CUDA call takes: bf16 with head size 64, 112 or 128
    goes to ``flash_attention_sm90`` (wgmma, TMA) or, at head size 64 or
    128 when ``rows`` (the query rows of a KV head, Sq x H / Hkv) is at
    most :data:`SPLIT_ROWS` and the ``keys`` (Skv) fill more than one of
    its tiles of :data:`SPLIT_BC`, to ``flash_attention_split`` (split KV,
    mma.sync; on one tile the two measured even; head size 112 stays on
    the wgmma kernel); everything else to ``flash_attention`` (mma.sync
    bf16, float32 FMAs)."""
    if dtype != torch.bfloat16 or D not in SM90_HEAD_DIMS:
        return "flash_attention"
    short = D in SPLIT_HEAD_DIMS and rows is not None and keys is not None \
        and rows <= SPLIT_ROWS and keys > SPLIT_BC
    return SPLIT if short else SM90


def _check_head_size(D: int) -> None:
    """Raise for a head size no flash kernel takes: the card's launches
    and the operators' fakes (the dry run) alike."""
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head sizes {HEAD_DIMS}, "
                         f"got {D}")


def call_route(q: torch.Tensor, k: torch.Tensor) -> str:
    """:func:`route` of a call on q (.., Sq, H, D) and k (.., Skv, Hkv,
    D)."""
    Sq, H, D = q.shape[-3:]
    return route(q.dtype, D, Sq * (H // max(1, k.shape[-2])), k.shape[-3])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None, scale=None,
                          with_lse: bool = False):
    """Softmax attention written out in float32, GQA by grouping the query
    heads of each KV head (no repeated K/V).  ``with_lse``: also each row's
    base-2 log-sum-exp of the masked scores, log2(e) logsumexp(scale q k^T)
    (-inf for a row that sees no key), float32 (B, H, Sq) (or (H, Sq)
    without a batch dimension), as the training forward saves it."""
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
    if not with_lse:
        return out if batched else out[0]
    lse = (torch.logsumexp(s, dim=-1) * LOG2E).reshape(B, H, Sq)
    return (out, lse) if batched else (out[0], lse[0])


def flash_attention_backward_plain(q, k, v, o, do, *, causal: bool = True,
                                   window=None, scale=None) -> tuple:
    """(dq, dk, dv) of :func:`flash_attention_plain` at output ``o`` and
    output gradient ``do``, written out in float32 as the kernels compute
    them: the log-sum-exp of the masked scores, delta = rowsum(do * o),
    P = exp(s - LSE), dP = do v^T, dS = P (dP - delta), dq = scale dS k,
    dk = scale dS^T q, dv = P^T do, GQA grouped as the forward groups it.
    A row that sees no key has P = 0.  Each gradient has its input's dtype
    and is contiguous."""
    batched = q.dim() == 4
    if not batched:
        q, k, v, o, do = q[None], k[None], v[None], o[None], do[None]
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    qg = q.float().reshape(B, Sq, Hkv, rep, D)
    dog = do.float().reshape(B, Sq, Hkv, rep, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, kf) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    # a row that sees no key: LSE -inf, P 0 (not exp(-inf + inf))
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                  torch.zeros_like(lse)))
    delta = (dog * o.float().reshape(B, Sq, Hkv, rep, D)).sum(-1)
    dp = torch.einsum("bqkrd,bskd->bkrqs", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkrqs,bskd->bqkrd", ds, kf) * scale
    dk = torch.einsum("bkrqs,bqkrd->bskd", ds, qg) * scale
    dv = torch.einsum("bkrqs,bqkrd->bskd", p, dog)
    out = (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
           dv.to(v.dtype))
    return tuple((t if batched else t[0]).contiguous() for t in out)


def _check(q, k, v, grads: bool = False):
    """Shapes, dtypes and devices of a call (``grads``: of the backward,
    whose inputs may require grad)."""
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
    if grads:
        return
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("the flash_attention wrapper has no backward "
                           "kernel: call it on tensors that do not require "
                           "grad, or kernels.ops.flash_attention (its "
                           "autograd Function) on tensors that do")


def _window_arg(window, Sq: int, Skv: int):
    """(has_window, window) for the kernel; a window of Skv keys or more
    masks nothing, and a window below -(Sq + Skv) masks no more than that."""
    if window is None or int(window) >= Skv:
        return 0, 0
    return 1, max(int(window), -(Sq + Skv))


# ------------------------------------------------------- the sm90 schedule
# A mirror of csrc/flash_attention_sm90.cu's kv_tiles, tile_masked and
# tile_of; a change to one side changes the other.  ``bc`` is the keys of a
# KV tile: the forward's sm90_bc(D, br), the split route's SPLIT_BC, the
# backward's 64.
def _kv_tiles(Sq, Skv, causal, has_window, win, r0, r1, bc):
    """KV tiles [j0, j1) of ``bc`` keys that some query row in [r0, r1)
    may see."""
    off = Skv - Sq
    lo, hi = 0, Skv
    if causal:
        hi = min(hi, off + r1)
    if has_window:
        lo = max(lo, off + r0 - win + 1)
    if hi <= lo:
        return 0, 0
    return lo // bc, -(-hi // bc)


def _tile_masked(Sq, Skv, causal, has_window, win, r0, r1, j, bc):
    """Whether some (row in [r0, r1), key in tile j of ``bc`` keys) pair is
    not visible."""
    off = Skv - Sq
    k0, k1 = j * bc, j * bc + bc - 1
    return bool(k1 >= Skv or (causal and k1 > off + r0)
                or (has_window and k0 <= off + r1 - 1 - win))


def tile_height(B: int, Sq: int, H: int, sms: int = H100_SMS) -> int:
    """Query rows per CTA: 128 (two consumer warpgroups) unless that leaves
    fewer tiles than half the SMs, then 64 (one consumer warpgroup, twice
    the CTAs).  With 32 heads on the H100 that is 64 rows up to S = 256
    and 128 from S = 512, the faster of the two at each serving bucket
    (``flash_variants.py`` times both; ``PERF.md`` has the readings)."""
    return 128 if B * H * -(-Sq // 128) >= sms // 2 else 64


@functools.lru_cache(maxsize=256)
def _q_order(Sq, Skv, causal, has_window, win, br, bc) -> tuple:
    """The q tiles of ``br`` rows longest first (most KV tiles of ``bc``
    keys; later rows first among equals)."""
    n = []
    for qt in range(-(-Sq // br)):
        j0, j1 = _kv_tiles(Sq, Skv, causal, has_window, win, qt * br,
                           min(qt * br + br, Sq), bc)
        n.append(j1 - j0)
    return tuple(sorted(range(len(n)), key=lambda t: (-n[t], -t)))


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The sm90 kernel's schedule for one call.  ``work`` is the list of
    (b, head, q tile) in the order the persistent CTAs take it
    (:meth:`cta_items`); ``kv[qt]`` the (KV tile, masked) pairs q tile qt
    visits, in order."""
    br: int
    bc: int
    q_order: tuple
    work: list
    kv: dict

    def cta_items(self, grid: int) -> list:
        """The work items CTA c of a persistent grid of ``grid`` CTAs runs
        (csrc ``work_item``): item r grid + c in even rounds r and r grid +
        grid - 1 - c in odd ones, a snake over the longest-first list."""
        out = [[] for _ in range(grid)]
        for r in range(-(-len(self.work) // grid)):
            for c in range(grid):
                idx = r * grid + (grid - 1 - c if r & 1 else c)
                if idx < len(self.work):
                    out[c].append(idx)
        return out


def tile_plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
              causal: bool = True, window=None,
              sms: int = H100_SMS) -> TilePlan:
    """The sm90 kernel's tile height, work order and per-tile KV walk for
    these shapes (pure Python; the CPU tests check it).  ``D`` and the
    tile height set the KV tile's keys (:func:`sm90_bc`); ``D`` is checked
    against the kernel's head sizes."""
    if D not in SM90_HEAD_DIMS:
        raise ValueError(f"{SM90} takes head sizes {SM90_HEAD_DIMS}, got {D}")
    if H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv}")
    has_window, win = _window_arg(window, Sq, Skv)
    br = tile_height(B, Sq, H, sms)
    bc = sm90_bc(D, br)
    order = _q_order(Sq, Skv, bool(causal), has_window, win, br, bc)
    work = [(b, h, qt) for qt in order for b in range(B) for h in range(H)]
    kv = {}
    for qt in order:
        r0, r1 = qt * br, min(qt * br + br, Sq)
        j0, j1 = _kv_tiles(Sq, Skv, causal, has_window, win, r0, r1, bc)
        kv[qt] = [(j, _tile_masked(Sq, Skv, causal, has_window, win, r0, r1,
                                   j, bc)) for j in range(j0, j1)]
    return TilePlan(br, bc, order, work, kv)


# --------------------------------------------------- the backward's schedule
# A mirror of csrc/flash_attention_bwd.cu's kv_tiles, q_tiles and
# tile_masked (the same _kv_tiles and _tile_masked as the sm90 forward's,
# over 64-key tiles at every head size) and of both routes' grids and
# walks; a change to one side changes the other.
BWD_TILE = 64


def bwd_route(dtype: torch.dtype, D: int) -> str:
    """The backward's route: ``"sm90"`` (wgmma, TMA, the forward's saved
    LSE) for bf16 at head sizes 64 and 128, else ``"mma"`` (float32;
    bf16 at 16, 32 and 112, whose forward at 112 takes the wgmma kernel
    but whose gradient the mma.sync kernels compute)."""
    return "sm90" if dtype == torch.bfloat16 and D in SM90_BWD_HEAD_DIMS \
        else "mma"


def _q_tiles(Sq, Skv, causal, has_window, win, j):
    """Q tiles [t0, t1) with a row that may see some key of KV tile j."""
    off = Skv - Sq
    k0 = j * BWD_TILE
    k1 = min(Skv, k0 + BWD_TILE)
    lo, hi = 0, Sq
    if causal:
        lo = max(lo, k0 - off)
    if has_window:
        hi = min(hi, k1 - 1 - off + win)
    if hi <= lo:
        return 0, 0
    return lo // BWD_TILE, -(-hi // BWD_TILE)


@functools.lru_cache(maxsize=256)
def _kv_order(Sq, Skv, causal, has_window, win) -> tuple:
    """The KV tiles longest first (most q tiles; later tiles first among
    equals)."""
    n = [t1 - t0 for t0, t1 in (_q_tiles(Sq, Skv, causal, has_window, win, j)
                                for j in range(-(-Skv // BWD_TILE)))]
    return tuple(sorted(range(len(n)), key=lambda j: (-n[j], -j)))


def bwd_tiles(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
              sms: int = H100_SMS) -> tuple:
    """(dq_rows, split) of the sm90 route.  dq CTAs of 128 query rows (two
    warpgroups) unless that leaves fewer than half the SMs busy
    (:func:`tile_height`, the forward's rule).  dkdv CTAs (one warpgroup,
    64 keys) of one KV head, or of one query head (``split``: float32
    shares summed by the reduce kernel) when a KV head serves several and
    one CTA per KV head would leave SMs idle (qwen3-4b at B = 1: 8 KV heads
    x 16 tiles = 128 CTAs).  PERF.md has the readings behind both."""
    dq_rows = tile_height(B, Sq, H, sms)
    split = H > Hkv and B * Hkv * -(-Skv // BWD_TILE) < sms
    return dq_rows, split


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward kernels' schedule for one call.

    ``dq_grid`` is (q tiles, H, B): the dq CTA of (x, h, b) owns the
    ``dq_rows`` rows of q tile ``q_order[x]`` of query head h and walks
    ``dq_walk[q tile]``, its (KV tile, masks) pairs in order, a mask for
    each 64-row slice (a warpgroup).  ``dkdv_grid`` is (KV tiles, heads,
    B): the dkdv CTA of (x, head, b) owns the 64 keys of KV tile
    ``kv_order[x]`` of one KV head (``heads`` = Hkv, walking that KV head's
    H / Hkv query heads in ascending order) or, when ``split``, of one
    query head (``heads`` = H), and walks ``dkdv_walk[KV tile]``, its
    (q tile, masked) pairs in order.  A mask is whether the kernel applies
    the element mask there.  The sm90 kernels take the grid as one
    dimension, tiles slowest (longest first across every head); the
    mma.sync route's kernels (``route`` ``"mma"``: float32 and bf16 head
    sizes 16 and 32) as three, with ``dq_rows = 64`` and ``split`` whenever
    H > Hkv.  ``reduce``: the dkdv CTAs write each query head's share in
    float32 and ``flash_bwd_dkdv_reduce`` sums the H / Hkv shares of each
    KV head in head order."""
    route: str
    B: int
    Sq: int
    Skv: int
    H: int
    Hkv: int
    causal: bool
    window: Optional[int]
    dq_rows: int
    split: bool
    q_order: tuple
    kv_order: tuple
    dq_walk: dict
    dkdv_walk: dict
    tile: int = BWD_TILE

    @property
    def dq_grid(self) -> tuple:
        return (len(self.q_order), self.H, self.B)

    @property
    def dkdv_grid(self) -> tuple:
        return (len(self.kv_order), self.H if self.split else self.Hkv,
                self.B)

    @property
    def reduce(self) -> bool:
        return self.split

    def walk(self) -> dict:
        """The (query head, row, key) pairs each kernel takes into its sums,
        counted in numpy: ``{"dq": n, "dkdv": n}``, each (H, Sq, KV tiles x
        64) int32, the columns past Skv the keys of a ragged last tile.
        An unmasked slice takes every pair of its in-range rows and all
        its keys; a masked one the visible pairs.  The dkdv kernel
        gives rows past Sq an LSE of +inf, so they take no part.  The walk
        is right when both equal the visible mask on every head and are 0
        past Skv."""
        T, Sq, Skv = self.tile, self.Sq, self.Skv
        ncol = -(-Skv // T) * T
        qpos = np.arange(Sq)[:, None] + (Skv - Sq)
        kpos = np.arange(ncol)[None, :]
        vis = (kpos < Skv) & np.ones((Sq, 1), bool)
        if self.causal:
            vis = vis & (kpos <= qpos)
        if self.window is not None:
            vis = vis & (kpos > qpos - self.window)
        rep = self.H // self.Hkv
        out = {}
        for name in ("dq", "dkdv"):
            n = np.zeros((self.H, Sq, ncol), np.int32)
            # (query head, first row, first key, masked) of each 64 x 64
            # slice a kernel takes
            if name == "dq":
                items = [(h, qt * self.dq_rows + T * i, j * T, m)
                         for h in range(self.H) for qt in self.q_order
                         for j, masks in self.dq_walk[qt]
                         for i, m in enumerate(masks)]
            else:
                heads = [[h] for h in range(self.H)] if self.split else \
                    [list(range(hk * rep, hk * rep + rep))
                     for hk in range(self.Hkv)]
                items = [(h, qt * T, j * T, m)
                         for hs in heads for j in self.kv_order for h in hs
                         for qt, m in self.dkdv_walk[j]]
            for h, r0, k0, m in items:
                rows = slice(r0, min(r0 + T, Sq))
                cols = slice(k0, k0 + T)
                n[h, rows, cols] += vis[rows, cols] if m else 1
            out[name] = n
        return out


def bwd_plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
             causal: bool = True, window=None, dtype=torch.bfloat16,
             sms: int = H100_SMS, tiles: Optional[tuple] = None) -> BwdPlan:
    """The backward kernels' grids, orders and per-CTA walks for these
    shapes and dtype (pure Python; the CPU tests walk it): the sm90 route's
    for bf16 at head sizes 64 and 128 (:func:`bwd_tiles`, or ``tiles`` =
    (dq_rows, split) given), the mma.sync route's otherwise.  Causal's uneven
    tiles go longest first, as :func:`tile_plan`'s do."""
    if D not in HEAD_DIMS:
        raise ValueError(f"the backward takes head sizes {HEAD_DIMS}, got "
                         f"{D}")
    if Hkv <= 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv}")
    has_window, win = _window_arg(window, Sq, Skv)
    causal = bool(causal)
    T = BWD_TILE
    rt = bwd_route(dtype, D)
    if rt == "mma":
        dq_rows, split = T, H > Hkv
    else:
        dq_rows, split = tiles or bwd_tiles(B, Sq, Skv, H, Hkv, D, sms)
        if dq_rows not in (64, 128) or (split and H == Hkv):
            raise ValueError(f"no sm90 backward with tiles {tiles}")
    q_order = _q_order(Sq, Skv, causal, has_window, win, dq_rows, T)
    kv_order = _kv_order(Sq, Skv, causal, has_window, win)
    dq_walk = {}
    for qt in q_order:
        r0, r1 = qt * dq_rows, min(qt * dq_rows + dq_rows, Sq)
        j0, j1 = _kv_tiles(Sq, Skv, causal, has_window, win, r0, r1, T)
        dq_walk[qt] = tuple(
            (j, tuple(_tile_masked(Sq, Skv, causal, has_window, win, a,
                                   min(a + T, Sq), j, T)
                      for a in range(r0, r0 + dq_rows, T)))
            for j in range(j0, j1))
    dkdv_walk = {}
    for j in kv_order:
        t0, t1 = _q_tiles(Sq, Skv, causal, has_window, win, j)
        dkdv_walk[j] = tuple(
            (qt, _tile_masked(Sq, Skv, causal, has_window, win, qt * T,
                              min(qt * T + T, Sq), j, T))
            for qt in range(t0, t1))
    return BwdPlan(rt, B, Sq, Skv, H, Hkv, causal,
                   None if not has_window else win, dq_rows, split,
                   q_order, kv_order, dq_walk, dkdv_walk)


def sm90_smem_bytes(D: int, br: int) -> int:
    """Dynamic shared memory of one CTA of the sm90 kernel at head size
    ``D`` (csrc Smem<W, br / 64>, W = :func:`sm90_width`): q, STAGES x
    (k, v) tiles of :func:`sm90_bc` keys and o tiles of W columns in bf16,
    2 + 4 STAGES mbarriers, and 1024 bytes of alignment slack."""
    W = sm90_width(D)
    bc, stages = SM90_TILES[(W, br)]
    return 2 * (2 * br * W + 2 * stages * bc * W) + 8 * (2 + 4 * stages) \
        + 1024


# ----------------------------------------------------- the split-KV route
# A mirror of csrc/flash_attention.cu's split kernels (their rows, ranges
# and split::tile_masked); a change to one side changes the other.
@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The split-KV route's plan for one call.  A KV head's ``rows`` query
    rows (Sq x H / Hkv; row m is query row m // rep of query head hk rep +
    m % rep) go to CTAs of ``mt`` m16 tiles (``16 mt`` rows, in
    ``row_blocks`` blocks); the KV tiles [j0, j0 + n_tiles) of ``bc`` keys
    that some query row may see are cut into ``n_split`` contiguous
    :attr:`ranges`, one a CTA: the grid is (n_split, Hkv, B x row_blocks).
    The combine folds each row's ranges in the order 0, 1, .., n_split - 1.
    :meth:`masked` says whether the kernel applies the element mask on a
    tile."""
    B: int
    Sq: int
    Skv: int
    H: int
    Hkv: int
    causal: bool
    window: Optional[int]
    rows: int
    mt: int
    row_blocks: int
    j0: int
    n_tiles: int
    n_split: int
    bc: int = SPLIT_BC

    @property
    def grid(self) -> tuple:
        return (self.n_split, self.Hkv, self.B * self.row_blocks)

    @property
    def ranges(self) -> tuple:
        """[t0, t1) of each range, in the combine's order (csrc t0, t1)."""
        n, ns = self.n_tiles, self.n_split
        return tuple((self.j0 + s * n // ns, self.j0 + (s + 1) * n // ns)
                     for s in range(ns))

    def masked(self, t: int) -> bool:
        has_window, win = _window_arg(self.window, self.Sq, self.Skv)
        return _tile_masked(self.Sq, self.Skv, self.causal, has_window, win,
                            0, self.Sq, t, self.bc)

    def walk(self) -> np.ndarray:
        """(n_split, Sq, KV tiles x bc) int32: the (row, key) pairs each
        range takes into its sums, counted in numpy (every query head of a
        query row takes the same ones); columns past Skv are the keys of a
        ragged last tile.  An unmasked tile takes all its keys, a masked
        one the visible ones.  The plan is right when the sum over the
        ranges equals the visible mask and each range's keys lie in its
        own tiles."""
        bc, Sq, Skv = self.bc, self.Sq, self.Skv
        ncol = max(-(-Skv // bc), self.j0 + self.n_tiles) * bc
        qpos = np.arange(Sq)[:, None] + (Skv - Sq)
        kpos = np.arange(ncol)[None, :]
        vis = (kpos < Skv) & np.ones((Sq, 1), bool)
        if self.causal:
            vis = vis & (kpos <= qpos)
        if self.window is not None:
            vis = vis & (kpos > qpos - self.window)
        n = np.zeros((self.n_split, Sq, ncol), np.int32)
        for s, (t0, t1) in enumerate(self.ranges):
            for t in range(t0, t1):
                cols = slice(t * bc, t * bc + bc)
                n[s, :, cols] += vis[:, cols] if self.masked(t) else 1
        return n


def split_plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
               causal: bool = True, window=None, sms: int = H100_SMS,
               waves: int = SPLIT_WAVES, bc: int = SPLIT_BC) -> SplitPlan:
    """The split-KV route's plan for these shapes (pure Python; the CPU
    tests walk it): m16 tiles a CTA from the rows of a KV head (1 up to
    16 rows, else 4 and as many blocks of 64 as the rows need), and the most ranges whose CTAs fit ``waves`` waves of ``sms``
    SMs (one at least, at most one a KV tile of ``bc`` keys: the kernel's
    ``split::BC``)."""
    if D not in SPLIT_HEAD_DIMS:
        raise ValueError(f"{SPLIT} takes head sizes {SPLIT_HEAD_DIMS}, got "
                         f"{D}")
    if Hkv <= 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv}")
    has_window, win = _window_arg(window, Sq, Skv)
    causal = bool(causal)
    rows = Sq * (H // Hkv)
    mt = 1 if rows <= 16 else 4
    row_blocks = max(1, -(-rows // (16 * mt)))
    j0, j1 = _kv_tiles(Sq, Skv, causal, has_window, win, 0, Sq, bc)
    ctas = max(1, B * Hkv * row_blocks)
    n_split = max(1, min(j1 - j0, waves * sms // ctas))
    return SplitPlan(B, Sq, Skv, H, Hkv, causal,
                     None if not has_window else win, rows, mt, row_blocks,
                     j0, j1 - j0, n_split, bc)


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window=None, scale=None,
                                with_lse: bool = False,
                                sms: int = H100_SMS):
    """The split route's arithmetic written out in float32 PyTorch, the
    plain version of ``flash_attention_split_fwd``: the masked scores of
    :func:`flash_attention_plain` in base 2, cut at :func:`split_plan`'s
    ranges; each range's max m, sum l and unnormalised output; then the
    ranges folded in order, o = sum 2^(m - M) o_r / sum 2^(m - M) l_r with
    M the largest m (0, and an LSE of -inf, for a row that sees no key).
    ``with_lse`` as :func:`flash_attention_plain`'s.  Bf16 at head sizes
    64 and 128 (:data:`SPLIT_HEAD_DIMS`), the route's inputs; no card path
    takes it."""
    batched = q.dim() == 4
    if not batched:
        q, k, v = q[None], k[None], v[None]
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    plan = split_plan(B, Sq, Skv, H, Hkv, D, causal, window, sms)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    qg = q.float().reshape(B, Sq, Hkv, rep, D)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * (scale * LOG2E)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    parts = []
    for t0, t1 in plan.ranges:
        k0, k1 = t0 * plan.bc, min(t1 * plan.bc, Skv)
        if k1 <= k0:
            m = s.new_full(s.shape[:-1], float("-inf"))
            parts.append((m, torch.zeros_like(m),
                          s.new_zeros(s.shape[:-1] + (D,))))
            continue
        sr = s[..., k0:k1]
        m = sr.amax(-1)
        p = torch.exp2(sr - torch.where(m == float("-inf"),
                                        torch.zeros_like(m), m)[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bkrqs,bskd->bkrqd", p,
                                   v.float()[:, k0:k1])))
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    seen = top > float("-inf")
    base = torch.where(seen, top, torch.zeros_like(top))
    l_sum = torch.zeros_like(top)
    o_sum = torch.zeros_like(parts[0][2])
    for m, l_r, o_r in parts:          # in range order
        f = torch.exp2(m - base)
        l_sum = l_sum + f * l_r
        o_sum = o_sum + f[..., None] * o_r
    inv = torch.where(l_sum > 0, 1.0 / l_sum.clamp_min(1e-30),
                      torch.zeros_like(l_sum))
    out = (o_sum * inv[..., None]).permute(0, 3, 1, 2, 4) \
        .reshape(B, Sq, H, D).to(q.dtype)
    if not with_lse:
        return out if batched else out[0]
    lse = torch.where(seen, top + torch.log2(l_sum.clamp_min(1e-30)),
                      torch.full_like(top, float("-inf"))).reshape(B, H, Sq)
    return (out, lse) if batched else (out[0], lse[0])


_ORDERS: dict = {}


def _order_tensor(key, device, order=_q_order) -> torch.Tensor:
    """``order(*key)`` (the q-tile order by default) as int32 on
    ``device``, made once per shape."""
    t = _ORDERS.get((order, key, device))
    if t is None:
        if len(_ORDERS) >= 256:
            _ORDERS.clear()
        t = torch.tensor(order(*key), dtype=torch.int32, device=device)
        _ORDERS[(order, key, device)] = t
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_shapes(named) -> tuple:
    """(B, Sq, Skv, H, Hkv, D) of a kernel call on ``named``, (tensor,
    name) pairs led by q and k, after checking that each tensor is a CUDA
    tensor the kernels can take: contiguous, on a 16-byte boundary, of a
    head size and lengths they handle."""
    for t, what in named:
        require_cuda_tensor(t, what)
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous (the kernels "
                             f"take no strides)")
    q, k = named[0][0], named[1][0]
    B = int(q.shape[0]) if q.dim() == 4 else 1
    Sq, H, D = (int(s) for s in q.shape[-3:])
    Skv, Hkv = int(k.shape[-3]), int(k.shape[-2])
    _check_head_size(D)
    if max(Sq, Skv) >= 2 ** 30:
        raise ValueError("sequence too long for the kernel's int32 positions")
    return B, Sq, Skv, H, Hkv, D


def launch_kernel(kernel: str, q, k, v, *, causal: bool = True, window=None,
                  scale=None, with_lse: bool = False):
    """:func:`flash_attention` through ``kernel`` (one of ``ROUTES``)
    instead of :func:`route`'s choice; ``chip_smoke.py`` times the first
    kernel with it on the wgmma kernel's bf16 inputs, and the wgmma kernel
    on the split route's.  ``with_lse``: return (o, LSE), the LSE float32
    (B, H, Sq) (or (H, Sq)) written by the ``SM90`` or ``SPLIT`` kernels
    beside o.  CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, with_lse=with_lse)
    B, Sq, Skv, H, Hkv, D = _kernel_shapes(((q, "q"), (k, "k"), (v, "v")))
    o = torch.empty_like(q)
    lse = None
    if with_lse:
        if kernel not in (SM90, SPLIT):
            raise ValueError(f"only {SM90} and {SPLIT} write the "
                             f"log-sum-exp")
        lse = torch.empty(q.shape[:-3] + (H, Sq), dtype=torch.float32,
                          device=q.device)
        if Skv == 0:
            lse.fill_(-math.inf)
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    has_window, win = _window_arg(window, Sq, Skv)
    sc = 1.0 / math.sqrt(D) if scale is None else float(scale)
    common = (B, Sq, Skv, H, Hkv, D, int(bool(causal)), has_window, win, sc)
    if kernel == SM90:
        if q.dtype != torch.bfloat16 or D not in SM90_HEAD_DIMS:
            raise ValueError(f"{SM90} takes bf16 head sizes "
                             f"{SM90_HEAD_DIMS}, got {q.dtype} {D}")
        br = tile_height(B, Sq, H, _sm_count(q.device.index))
        key = (Sq, Skv, bool(causal), has_window, win, br, sm90_bc(D, br))
        order = _order_tensor(key, q.device)
        _build.launch("flash_attention_sm90_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      order.data_ptr(), *common, br, order.numel(),
                      _build.stream_of(q))
        flash_attention.launches_sm90 += 1
    elif kernel == SPLIT:
        if q.dtype != torch.bfloat16 or D not in SPLIT_HEAD_DIMS:
            raise ValueError(f"{SPLIT} takes bf16 head sizes "
                             f"{SPLIT_HEAD_DIMS}, got {q.dtype} {D}")
        plan = split_plan(B, Sq, Skv, H, Hkv, D, causal, window,
                          _sm_count(q.device.index))
        # each range's unnormalised o, max and sum of every row (none for
        # one range: the split kernel writes o itself)
        n = B * Hkv * plan.row_blocks * plan.n_split * 16 * plan.mt \
            if plan.n_split > 1 else 0
        part_o = torch.empty(n * D, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(2 * n, dtype=torch.float32, device=q.device)
        _build.launch("flash_attention_split_fwd", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      part_o.data_ptr() or None, part_ml.data_ptr() or None,
                      *common,
                      plan.j0, plan.n_tiles, plan.n_split, plan.mt,
                      plan.row_blocks, _build.stream_of(q))
        flash_attention.launches_split += 1
    elif kernel == "flash_attention":
        _build.launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), *common,
                      _DTYPE_CODES[q.dtype], _build.stream_of(q))
    else:
        raise ValueError(f"unknown flash kernel {kernel!r}; one of {ROUTES}")
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    scale=None) -> torch.Tensor:
    """q: (Sq, H, D); k, v: (Skv, Hkv, D) with Hkv | H (or all with a
    leading batch dimension).  Returns q's shape and dtype.  The call is
    the operator ``torch.ops.repro_torch.flash_attention``, so that
    ``FakeTensorMode`` (the dry run) allocates its output without running
    it and ``FlopCounterMode`` counts it (:func:`flash_flops`)."""
    return torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), None if window is None else int(window),
        None if scale is None else float(scale))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: Optional[int],
              scale: Optional[float]) -> torch.Tensor:
    return launch_kernel(call_route(q, k), q, k, v, causal=causal,
                         window=window, scale=scale)


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, scale):
    _check(q, k, v)
    _check_head_size(q.shape[-1])
    return torch.empty_like(q)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None,
                        scale=None) -> tuple:
    """(o, LSE): :func:`flash_attention` and each row's base-2 log-sum-exp
    of ``scale log2(e) q k^T`` over its visible keys (-inf for a row that
    sees none), float32 (B, H, Sq) (or (H, Sq)).  The training forward
    (:class:`FlashAttention`) asks for it to hand to the backward; the
    ``SM90`` or ``SPLIT`` kernels write it beside o, which is the same as
    without it.  The call is the operator
    ``torch.ops.repro_torch.flash_attention_lse`` (a fake and
    :func:`flash_flops`, as the forward's).  CUDA tensors must take one of
    those two routes (bf16, head size 64, 112 or 128)."""
    return torch.ops.repro_torch.flash_attention_lse(
        q, k, v, bool(causal), None if window is None else int(window),
        None if scale is None else float(scale))


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def _flash_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: Optional[int],
                  scale: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    return launch_kernel(call_route(q, k), q, k, v, causal=causal,
                         window=window, scale=scale, with_lse=True)


@_flash_lse_op.register_fake
def _flash_lse_fake(q, k, v, causal, window, scale):
    _check(q, k, v)
    _check_head_size(q.shape[-1])
    return (torch.empty_like(q),
            q.new_empty(q.shape[:-3] + (q.shape[-2], q.shape[-3]),
                        dtype=torch.float32))


def flash_flops(q_shape, k_shape) -> int:
    """The operator's FLOPs as the plain version computes them: q k^T and
    p v over every (query, key) pair, 4 B Sq Skv H D (the kernel skips the
    tiles a mask hides; this count does not)."""
    B = q_shape[0] if len(q_shape) == 4 else 1
    Sq, H, D = q_shape[-3:]
    return 4 * B * Sq * k_shape[-3] * H * D


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse])
def _flash_flop_formula(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return flash_flops(q_shape, k_shape)


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention.launches_split = 0


def _check_backward(q, k, v, o, do):
    _check(q, k, v, grads=True)
    for t, what in ((o, "o"), (do, "do")):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} is not like q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")


def _check_lse(q, lse):
    want = q.shape[:-3] + (q.shape[-2], q.shape[-3])
    if lse.shape != want or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device} is not float32 {tuple(want)} on "
                         f"{q.device}")


def launch_backward(q, k, v, o, do, *, causal: bool = True, window=None,
                    scale=None, lse=None) -> tuple:
    """(dq, dk, dv) of attention at output ``o`` and output gradient ``do``
    through ``csrc/flash_attention_bwd.cu`` on :func:`bwd_plan`'s grids and
    orders, counting one launch of the set.  bf16 at head sizes 64 and 128
    takes the sm90 route (``flash_bwd_dq_sm90``, ``flash_bwd_dkdv_sm90``
    and, when the plan splits, ``flash_bwd_dkdv_reduce``), reading ``lse``,
    the forward's saved log-sum-exp (:func:`flash_attention_lse`; without
    it the forward kernel is run once more to write it); the rest the
    mma.sync route's kernels, which compute their own.  CPU tensors take
    :func:`flash_attention_backward_plain`; a CUDA tensor launches the
    kernels or raises."""
    _check_backward(q, k, v, o, do)
    if lse is not None:
        _check_lse(q, lse)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, do, causal=causal,
                                              window=window, scale=scale)
    B, Sq, Skv, H, Hkv, D = _kernel_shapes(
        ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")))
    if q.numel() == 0 or k.numel() == 0:
        # no query or no key: every gradient is 0
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    kw = dict(causal=causal, window=window, scale=scale)
    if bwd_route(q.dtype, D) == "sm90":
        if lse is None:
            lse = launch_kernel(SM90, q, k, v, with_lse=True, **kw)[1]
        got = _launch_backward_sm90(q, k, v, o, do, lse, **kw)
    else:
        got = _launch_backward_mma(q, k, v, o, do, **kw)
    flash_attention_backward.launches += 1
    return got


def _launch_backward_sm90(q, k, v, o, do, lse, *, causal=True, window=None,
                          scale=None, tiles=None) -> tuple:
    """The sm90 route's launches (not counted): ``tiles`` = (dq_rows,
    split) in place of :func:`bwd_tiles`' (the tests' other choices)."""
    B, Sq, Skv, H, Hkv, D = _kernel_shapes(
        ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do"),
         (lse, "lse")))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    has_window, win = _window_arg(window, Sq, Skv)
    causal = bool(causal)
    sc = 1.0 / math.sqrt(D) if scale is None else float(scale)
    dq_rows, split = tiles or bwd_tiles(B, Sq, Skv, H, Hkv, D,
                                        _sm_count(q.device.index))
    delta = torch.empty(B * H * Sq, dtype=torch.float32, device=q.device)
    # each query head's share of dk and dv when the plan splits the KV heads
    parts = [torch.empty(B * Skv * H * D, dtype=torch.float32,
                         device=q.device) for _ in range(2 * bool(split))]
    part_ptrs = [t.data_ptr() for t in parts] or [None, None]
    q_order = _order_tensor((Sq, Skv, causal, has_window, win, dq_rows,
                             BWD_TILE), q.device)
    kv_order = _order_tensor((Sq, Skv, causal, has_window, win), q.device,
                             _kv_order)
    _build.launch("flash_attention_bwd_sm90", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), *part_ptrs, q_order.data_ptr(),
                  kv_order.data_ptr(), q_order.numel(), kv_order.numel(), B,
                  Sq, Skv, H, Hkv, D, int(causal), has_window, win, sc,
                  dq_rows, int(bool(split)), _build.stream_of(q))
    return dq, dk, dv


def _launch_backward_mma(q, k, v, o, do, *, causal=True, window=None,
                         scale=None) -> tuple:
    """The mma.sync route's kernels (``flash_bwd_dq``, ``flash_bwd_dkdv``,
    under GQA ``flash_bwd_dkdv_reduce``; not counted): the route of
    float32 and of bf16 head sizes 16, 32 and 112, and ``chip_smoke.py``'s
    ``prev_ms`` at the sm90 route's shapes."""
    B, Sq, Skv, H, Hkv, D = _kernel_shapes(
        ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse, delta = (torch.empty(B * H * Sq, dtype=torch.float32,
                              device=q.device) for _ in range(2))
    # each query head's share of dk and dv, summed in head order by the
    # reduce kernel when a KV head serves several
    parts = [torch.empty(B * Skv * H * D, dtype=torch.float32,
                         device=q.device) for _ in range(2 * (H > Hkv))]
    part_ptrs = [t.data_ptr() for t in parts] or [None, None]
    has_window, win = _window_arg(window, Sq, Skv)
    causal = bool(causal)
    sc = 1.0 / math.sqrt(D) if scale is None else float(scale)
    q_order = _order_tensor((Sq, Skv, causal, has_window, win, BWD_TILE,
                             BWD_TILE), q.device)
    kv_order = _order_tensor((Sq, Skv, causal, has_window, win), q.device,
                             _kv_order)
    _build.launch("flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), *part_ptrs, q_order.data_ptr(),
                  kv_order.data_ptr(),
                  q_order.numel(), kv_order.numel(), B, Sq, Skv, H, Hkv, D,
                  int(causal), has_window, win, sc, _DTYPE_CODES[q.dtype],
                  _build.stream_of(q))
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window=None, scale=None,
                             lse: Optional[torch.Tensor] = None) -> tuple:
    """(dq, dk, dv) of :func:`flash_attention` at its output ``o`` and the
    output gradient ``do`` (q's shape and dtype); ``lse``: the forward's
    log-sum-exp (:func:`flash_attention_lse`), which the sm90 route reads.
    The call is the operator
    ``torch.ops.repro_torch.flash_attention_backward``, so that the dry
    run's ``FakeTensorMode`` allocates its outputs and ``FlopCounterMode``
    counts it (:func:`flash_bwd_flops`).  Its launches (the kernels of one
    call, one count) are counted in ``flash_attention_backward.launches``."""
    return torch.ops.repro_torch.flash_attention_backward(
        q, k, v, o, do, bool(causal),
        None if window is None else int(window),
        None if scale is None else float(scale), lse)


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, causal: bool,
                  window: Optional[int], scale: Optional[float],
                  lse: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return launch_backward(q, k, v, o, do, causal=causal, window=window,
                           scale=scale, lse=lse)


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, o, do, causal, window, scale, lse=None):
    _check_backward(q, k, v, o, do)
    _check_head_size(q.shape[-1])
    if lse is not None:
        _check_lse(q, lse)
    return tuple(torch.empty_like(t) for t in (q, k, v))


def flash_bwd_flops(q_shape, k_shape) -> int:
    """The backward operator's FLOPs as its plain version computes them:
    q k^T again and four products (do v^T, dS k, dS^T q, P^T do) over every
    (query, key) pair, 10 B Sq Skv H D."""
    return 10 * flash_flops(q_shape, k_shape) // 4


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _flash_bwd_flop_formula(q_shape, k_shape, *args, **kwargs) -> int:
    return flash_bwd_flops(q_shape, k_shape)


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: the forward kernel (on detached inputs, so
    it counts its launch; :func:`flash_attention_lse` where the backward
    takes the sm90 route, which saves the log-sum-exp beside the output,
    else :func:`flash_attention`) and the backward kernels
    (:func:`flash_attention_backward` at the saved output and LSE).
    ``FlashAttention.apply(q, k, v, causal, window, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ins = (q.detach(), k.detach(), v.detach())
        kw = dict(causal=causal, window=window, scale=scale)
        if bwd_route(q.dtype, q.shape[-1]) == "sm90":
            # the backward reads the forward's log-sum-exp
            o, lse = flash_attention_lse(*ins, **kw)
            ctx.save_for_backward(q, k, v, o, lse)
        else:
            o = flash_attention(*ins, **kw)
            ctx.save_for_backward(q, k, v, o)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, scale = ctx.mask
        q, k, v, o, *lse = (t.detach() for t in ctx.saved_tensors)
        # contiguous gradients, as the kernels write them: a DTensor view
        # of a sharded gradient (the sharded step's projections) needs a
        # contiguous local tensor
        got = flash_attention_backward(q, k, v, o, grad_out.contiguous(),
                                       causal=causal, window=window,
                                       scale=scale,
                                       lse=lse[0] if lse else None)
        return tuple(g if n else None for g, n in
                     zip(got, ctx.needs_input_grad[:3])) + (None, None, None)
