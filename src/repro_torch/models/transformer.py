"""Decoder-only transformer for serving, dense or MoE (the port of the
``block_kind == "transformer"`` path of ``repro/models/transformer.py``).

  init_params     parameters with layer-stacked (L, ...) leaves, under the
                  reference's names
  init_cache      an empty KV cache
  prefill         full-sequence forward -> (last logits, decode cache);
                  every layer's attention goes through the flash kernel
  decode_step     single-token step on the cache (plain torch attention)

A MoE config's feed-forward is ``models.moe.moe_layer`` (star-forest
dispatch through ``DynPlan``), where the reference calls it.  The
reference's ``lax.scan`` over layers is a Python loop over the stacked
leaves.  hymba, xlstm and encoder-decoder configs raise
``NotImplementedError`` naming the ROADMAP item that brings them; the
training ``forward`` comes with the training slice and its backward kernel.
Entry points run on the current CUDA device unless ``device="cpu"`` is
passed (``init_params``, ``init_cache``); the others run where the params
live and raise on inputs placed elsewhere.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import check_payload, resolve_device
from .config import ModelConfig, torch_dtype
from .layers import attention, attention_decode, init_attn, init_mlp, mlp, \
    rmsnorm
from .moe import init_moe, moe_layer

__all__ = ["init_params", "init_cache", "prefill", "decode_step",
           "require_supported", "feed_forward", "layer", "as_tokens"]


def require_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a decoder-only
    transformer, dense or MoE: the block families the port has."""
    if cfg.block_kind in ("hymba", "xlstm"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.block_kind} blocks come with ROADMAP Queue 1 "
            "item 3 (models/ssm.py, models/xlstm.py)")
    if cfg.block_kind != "transformer":
        raise NotImplementedError(f"{cfg.name}: unknown block kind "
                                  f"{cfg.block_kind!r}")
    if cfg.enc_layers or cfg.cross_attention:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models and cross_attention come "
            "with ROADMAP Queue 1 item 3 (the audio family)")


def feed_forward(x: torch.Tensor, bp: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """The block's feed-forward on the pre-normed residual ``h2``: the MoE
    layer (its aux loss dropped, as serving drops it) or the dense MLP."""
    if cfg.is_moe:
        return moe_layer(x, bp, cfg)[0]
    return mlp(x, bp, cfg)


def layer(blocks: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked block leaves (views)."""
    return {name: leaf[i] for name, leaf in blocks.items()}


def as_tokens(tokens, device: torch.device) -> torch.Tensor:
    """Token ids as an int64 tensor on ``device``; a tensor on another
    device raises."""
    if isinstance(tokens, torch.Tensor):
        check_payload(tokens, device, "tokens")
        return tokens.long()
    return torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=device)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_params(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Random parameters from ``generator`` (a ``torch.Generator`` on the
    target device; seed 0 when omitted), scaled as the reference scales
    them.  The random stream is torch's, not ``jax.random``'s: tests that
    compare the packages carry the reference's params across with
    ``convert.params_from_arrays``.  ``device="meta"`` gives the names,
    shapes and dtypes without memory."""
    require_supported(cfg)
    dev = resolve_device(device)
    gen = generator
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
    dt = torch_dtype(cfg.dtype)
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev).mul_(std).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    params: Dict = {"embed": normal((V, D), 0.02), "final_norm": ones(D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), 0.02)
    blocks = {"ln1": ones(L, D), "ln2": ones(L, D),
              **init_attn(normal, cfg, L)}
    if cfg.is_moe:
        blocks.update(init_moe(cfg, L, generator=gen, device=dev))
    elif cfg.d_ff:
        blocks.update(init_mlp(normal, cfg, L))
    params["blocks"] = blocks
    return params


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None, *,
               device=None) -> Dict:
    """Zeroed (L, batch, s_max, Hkv, hd) K and V caches; ``pos`` is a host
    int."""
    require_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------
def _head(params, cfg: ModelConfig, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _last_x(x, last_pos):
    """The per-row last *real* position of (B, S, D) activations:
    right-padded (length-bucketed) prompts read their logits at
    ``plen - 1`` rather than at the pad tail."""
    if last_pos is None:
        return x[:, -1:]
    lp = as_tokens(last_pos, x.device)
    return x[torch.arange(x.shape[0], device=x.device), lp][:, None]


def prefill(params, cfg: ModelConfig, *, tokens, s_max: Optional[int] = None,
            last_pos=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also returns the decode cache.
    tokens: (B, S) -> (logits of the last position (B, V), cache).

    ``last_pos`` (B,) selects a per-row logit position for right-padded
    prompts (causal masking keeps real positions numerically unaffected by
    the pad tail; KV rows past ``last_pos`` hold pad junk that decode
    overwrites before its mask ever exposes them).  The cache is
    left-aligned in (L, B, s_max, Hkv, hd) tensors."""
    require_supported(cfg)
    dev = params["embed"].device
    x = params["embed"][as_tokens(tokens, dev)]
    B, S, _ = x.shape
    s_max = s_max or S
    if S > s_max:
        raise ValueError(f"prompt of {S} tokens exceeds s_max={s_max}")
    window = cfg.attn_window or s_max
    cache = init_cache(cfg, B, s_max, x.dtype, device=dev)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        bp = layer(blocks, i)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        attn_out, (k, v) = attention(h, bp, cfg, window=window)
        x = x + attn_out
        if cfg.is_moe or cfg.d_ff:
            x = x + feed_forward(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp,
                                 cfg)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    cache["pos"] = S
    return _head(params, cfg, _last_x(x, last_pos))[:, 0], cache


def decode_step(params, cfg: ModelConfig, tokens, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B,) -> (logits (B, V), cache').  The
    cache's K/V tensors are updated in place (the returned cache shares
    them); ``pos`` advances by one."""
    require_supported(cfg)
    dev = params["embed"].device
    x = params["embed"][as_tokens(tokens, dev)[:, None]]
    pos = int(cache["pos"])
    s_max = cache["k"].shape[2]
    if pos >= s_max:
        raise ValueError(f"decode position {pos} is past s_max={s_max}")
    window = cfg.attn_window or s_max
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        bp = layer(blocks, i)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        attn_out, _, _ = attention_decode(h, bp, cfg, cache["k"][i],
                                          cache["v"][i], pos, window=window)
        x = x + attn_out
        if cfg.is_moe or cfg.d_ff:
            x = x + feed_forward(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp,
                                 cfg)
    logits = _head(params, cfg, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
