"""Core transformer layers (the port of ``repro/models/layers.py``): RMSNorm,
RoPE, GQA attention (prefill through the flash-attention kernel, KV-cache
decode in plain torch), SwiGLU/GELU MLPs.

Everything is a plain function over a params dict; layer params are stacked
along a leading L axis and the caller hands one layer's slice in.  The
reference's ``constrain`` sharding hints have no counterpart on one card and
are left out.  ``cross_attention`` comes with the audio family.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig, torch_dtype

__all__ = ["rmsnorm", "rope", "attention", "attention_decode", "mlp",
           "init_attn", "init_mlp"]


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
              window=None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill).  x: (B, S, D).  Returns (output,
    (k, v)) so prefill can seed the KV cache.  The attention core is the
    reference's ``_chunked_attn`` function, computed by the flash-attention
    kernel (``kernels.ops.flash_attention``) on the card."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = kops.flash_attention(q, k, v, causal=causal, window=window)
    return out.reshape(B, S, H * hd) @ p["wo"], (k, v)


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
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    k = (x @ p["wk"]).reshape(B, 1, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, 1, Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    pos_t = torch.full((1,), pos, device=x.device)
    q = rope(q, pos_t, cfg.rope_theta)
    k = rope(k, pos_t, cfg.rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    Smax = cache_k.shape[1]
    rep = H // Hkv
    qg = q.reshape(B, Hkv, rep, hd).float()
    s = torch.einsum("bkrd,bskd->bkrs", qg, cache_k.float()) * \
        (1.0 / math.sqrt(hd))
    kpos = torch.arange(Smax, device=x.device)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    s = s.masked_fill(~mask, -1e30)
    pr = torch.softmax(s, dim=-1).to(cache_v.dtype).float()
    out = torch.einsum("bkrs,bskd->bkrd", pr, cache_v.float()).to(x.dtype)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache_k, cache_v


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------
def mlp(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    h = x @ p["w_in"]
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return h @ p["w_out"]
