"""Core transformer layers (the port of ``repro/models/layers.py``): RMSNorm,
RoPE, GQA attention (prefill through the flash-attention kernel, KV-cache
decode in plain torch), SwiGLU/GELU MLPs.

Everything is a plain function over a params dict; layer params are stacked
along a leading L axis and the caller hands one layer's slice in.  The
reference's ``constrain`` sharding pins sit where it has them (q/k/v and
the attention output, the FFN); they act on DTensors under an ambient mesh
(``models.sharding.constrain``) and are the identity otherwise.  On
DTensors the attention core runs per rank on its shards
(``models.meshed``).  ``cross_attention`` (the audio family's decoder
reading the encoder's K/V) is ``attention`` with ``kv_override`` and no
mask.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import is_fake
from ..kernels import ops as kops
from .config import ModelConfig, torch_dtype
from .meshed import (is_dtensor, sharded_cache_write, sharded_decode_core,
                     sharded_flash, split_heads)
from .sharding import constrain, merge_heads

__all__ = ["rmsnorm", "rope", "attention", "attention_decode", "mlp",
           "init_attn", "init_mlp", "cross_attention", "decode_core"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2) / hd))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(hd: int, theta: float, device: torch.device
                   ) -> torch.Tensor:
    return torch.as_tensor(_rope_freqs(hd, theta), dtype=torch.float32,
                           device=device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) absolute positions."""
    hd = x.shape[-1]
    if is_fake(positions):     # the dry run: no fake tensor is cached
        freqs = torch.as_tensor(_rope_freqs(hd, float(theta)),
                                dtype=torch.float32, device=x.device)
    else:
        freqs = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions[:, None].float() * freqs[None, :]           # (S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
Normal = Callable[[tuple, float], torch.Tensor]


def init_attn(normal: Normal, cfg: ModelConfig, layers: int) -> Dict:
    """Attention weights of ``layers`` stacked layers, scaled as the
    reference scales them; ``normal(shape, std)`` draws them in cfg.dtype."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = 1.0 / np.sqrt(D)
    p = {
        "wq": normal((layers, D, H * hd), s),
        "wk": normal((layers, D, Hkv * hd), s),
        "wv": normal((layers, D, Hkv * hd), s),
        "wo": normal((layers, H * hd, D), s / np.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        ones = torch.ones((layers, hd), dtype=torch_dtype(cfg.dtype),
                          device=p["wq"].device)
        p["q_norm"] = ones
        p["k_norm"] = ones.clone()
    return p


def init_mlp(normal: Normal, cfg: ModelConfig, layers: int,
             d_ff: Optional[int] = None) -> Dict:
    D = cfg.d_model
    F_ = d_ff if d_ff is not None else cfg.d_ff
    s = 1.0 / np.sqrt(D)
    so = 1.0 / np.sqrt(F_) / np.sqrt(2 * cfg.n_layers)
    p = {"w_in": normal((layers, D, F_), s),
         "w_out": normal((layers, F_, D), so)}
    if cfg.mlp_kind == "swiglu":
        p["w_gate"] = normal((layers, D, F_), s)
    return p


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def attention(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              window=None, kv_override=None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill).  x: (B, S, D).  Returns (output,
    (k, v)) so prefill can seed the KV cache.  The attention core is the
    reference's ``_chunked_attn`` function, computed by the flash-attention
    kernel (``kernels.ops.flash_attention``) on the card.
    ``kv_override`` (k, v) feeds the encoder's K/V for cross-attention:
    no rope on q or k, and no k norm, as in the reference."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = constrain(split_heads(x @ p["wq"], H, hd), model_dim=2)
    if kv_override is None:
        k = constrain(split_heads(x @ p["wk"], Hkv, hd), model_dim=2)
        v = constrain(split_heads(x @ p["wv"], Hkv, hd), model_dim=2)
    else:
        k, v = kv_override
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        if kv_override is None:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if kv_override is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if is_dtensor(q):
        out = sharded_flash(q, k, v, causal=causal, window=window)
    else:
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    out = constrain(out, model_dim=2)
    return constrain(merge_heads(out) @ p["wo"]), (k, v)


def cross_attention(x: torch.Tensor, p: Dict, cfg: ModelConfig,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor]
                    ) -> torch.Tensor:
    """Decoder queries over the encoder's (k, v), (B, Se, Hkv, hd) each,
    with no mask (through the flash kernel, at decode too: Sq = 1)."""
    return attention(x, p, cfg, causal=False, kv_override=enc_kv)[0]


def attention_decode(x: torch.Tensor, p: Dict, cfg: ModelConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, window=None):
    """Single-token decode: x (B, 1, D); cache_k/v (B, Smax, Hkv, hd); pos:
    the current absolute position.  Writes this token's k/v into the caches
    in place and returns (out, cache_k, cache_v).

    Grouped-query attention without a repeated cache: q is regrouped to
    (B, Hkv, rep, hd); both contractions run in float32 and the
    probabilities are rounded to the cache dtype first, as in the
    reference."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(x @ p["wq"], H, hd)
    k = split_heads(x @ p["wk"], Hkv, hd)
    v = split_heads(x @ p["wv"], Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    pos_t = torch.full((1,), pos, device=x.device)
    q = rope(q, pos_t, cfg.rope_theta)
    k = rope(k, pos_t, cfg.rope_theta)
    if is_dtensor(cache_k):
        sharded_cache_write(cache_k, k, pos)
        sharded_cache_write(cache_v, v, pos)
        out = sharded_decode_core(q, cache_k, cache_v, pos, window,
                                  decode_core)
    else:
        cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        out = decode_core(q, cache_k, cache_v, pos, window)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache_k, cache_v


def decode_core(q, cache_k, cache_v, pos: int, window, first: int = 0,
                reduce=None):
    """The decode attention of q (B, 1, H, hd) over keys ``first ..
    first + Smax`` of the caches (B, Smax, Hkv, hd) -> (B, 1, H, hd), in
    q's dtype.  ``reduce(t, op)`` combines a softmax statistic over the
    ranks that hold the other keys (``"max"`` / ``"sum"``; the sequence-
    sharded cache of ``models.meshed.sharded_decode_core``): with it the
    softmax is taken in pieces, max and sum combined before the
    probabilities are rounded and the partial outputs summed."""
    B, _, H, hd = q.shape
    Smax, Hkv = cache_k.shape[1], cache_k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep, hd).float()
    s = torch.einsum("bkrd,bskd->bkrs", qg, cache_k.float()) * \
        (1.0 / math.sqrt(hd))
    kpos = torch.arange(first, first + Smax, device=q.device)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    s = s.masked_fill(~mask, -1e30)
    if reduce is None:
        pr = torch.softmax(s, dim=-1)
    else:
        mx = reduce(torch.amax(s, dim=-1, keepdim=True), "max")
        e = torch.exp(s - mx)
        pr = e / reduce(torch.sum(e, dim=-1, keepdim=True), "sum")
    pr = pr.to(cache_v.dtype).float()
    out = torch.einsum("bkrs,bskd->bkrd", pr, cache_v.float())
    if reduce is not None:
        out = reduce(out, "sum")
    return out.to(q.dtype).reshape(B, 1, H, hd)


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------
def mlp(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    h = constrain(x @ p["w_in"], model_dim=2)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(constrain(x @ p["w_gate"], model_dim=2)) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return constrain(h @ p["w_out"])
