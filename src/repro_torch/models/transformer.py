"""Top-level model definitions for every family of the reference (the port
of ``repro/models/transformer.py``), for inference:

  init_params     parameters with layer-stacked (L, ...) leaves, under the
                  reference's names
  init_cache      an empty decode cache
  forward         full-sequence logits and the MoE aux loss, no gradient
  forward_train   the same, differentiable (every family), each block
                  (and each xlstm pair) under activation checkpointing
                  when ``cfg.remat == "block"``
  prefill         full-sequence forward -> (last logits, decode cache);
                  every attention goes through the flash kernel
  decode_step     single-token step on the cache (plain torch self-
                  attention; cross-attention through the flash kernel)

Families:
  dense / vlm         pre-norm GQA transformer (vlm takes precomputed
                      patch + token embeddings through ``embeds=``; the
                      frontend is stubbed, as in the reference)
  moe                 the same skeleton, FFN -> ``models.moe.moe_layer``
                      (star-forest dispatch through ``DynPlan``)
  hybrid (hymba)      attention and SSM heads in parallel on the same
                      input (``models.ssm``), each output normalized, then
                      summed; per-layer windows (:func:`hymba_windows`)
  ssm (xlstm)         (mLSTM, sLSTM) pair blocks (``models.xlstm``), no
                      attention and no kernel
  audio (whisper)     encoder-decoder: the encoder takes precomputed frame
                      embeddings (``enc_embeds=``, the stubbed frontend)
                      under unmasked attention; the decoder adds cross-
                      attention over the encoder's K/V, kept in the cache

The reference's ``lax.scan`` over layers is a Python loop over the stacked
leaves.  ``forward``, ``prefill`` and ``decode_step`` run without a graph;
``forward_train`` keeps one: the attention core (causal, windowed,
unmasked encoder, cross) goes through the flash kernel's
``autograd.Function`` (forward kernel, plain backward), the MoE dispatch
and combine through ``DynPlan``'s differentiable gathers, hymba's SSM scan
through ``ssm._SelectiveScan`` (graph replays, chunk-boundary states
only), xlstm's cell loops in checkpointed 128-step chunks, and the token
lookup through the gather whose transpose is the sorted segment reduce
(deterministic, no float atomics).  ``cfg.remat == "block"`` wraps each
block body (encoder blocks, decoder blocks with their cross K/V
projections, xlstm pairs) in ``torch.utils.checkpoint`` (non-reentrant),
as ``jax.checkpoint`` wraps the reference's scan bodies.  Entry points run
on the current CUDA device unless ``device="cpu"`` is passed
(``init_params``, ``init_cache``); the others run where the params live
and raise on inputs placed elsewhere.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import check_payload, resolve_device
from ..core.dynplan import gather_rows
from .config import ModelConfig, torch_dtype
from .layers import (attention, attention_decode, cross_attention,
                     init_attn, init_mlp, mlp, rmsnorm)
from .meshed import is_dtensor, sharded_lookup, sharded_set, split_heads
from .moe import init_moe, moe_layer
from .sharding import constrain
from .ssm import init_ssm, ssm_scan, ssm_step
from .xlstm import (init_xlstm_pair, init_xlstm_state, xlstm_pair_scan,
                    xlstm_pair_step)

__all__ = ["init_params", "init_cache", "forward", "forward_train",
           "prefill",
           "decode_step", "hymba_windows", "layer_windows", "hymba_mix",
           "require_supported", "feed_forward", "layer", "as_tokens"]

BLOCK_KINDS = ("transformer", "hymba", "xlstm")


def require_supported(cfg: ModelConfig, grad: bool = False) -> None:
    """Raise ``NotImplementedError`` for a ``block_kind`` the reference
    does not have.  Every family the reference has serves and trains, so
    ``grad`` (kept for the training entry points' calls) changes
    nothing."""
    if cfg.block_kind not in BLOCK_KINDS:
        raise NotImplementedError(f"{cfg.name}: unknown block kind "
                                  f"{cfg.block_kind!r}; the port has "
                                  f"{BLOCK_KINDS}")


def hymba_windows(cfg: ModelConfig, s_max: int) -> np.ndarray:
    """Per-layer attention window: every ``global_layer_every``-th layer is
    global (window = s_max), the rest sliding-window."""
    w = np.full(cfg.n_layers, cfg.attn_window or s_max, dtype=np.int32)
    if cfg.global_layer_every:
        w[:: cfg.global_layer_every] = s_max
    return w


def layer_windows(cfg: ModelConfig, s_max: int) -> List[int]:
    """Each layer's attention window: :func:`hymba_windows` for hymba, else
    ``cfg.attn_window`` (``s_max``, no window, when it is unset)."""
    if cfg.block_kind == "hymba":
        return [int(w) for w in hymba_windows(cfg, s_max)]
    return [int(cfg.attn_window or s_max)] * cfg.n_layers


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

    def normal(shape, std, dtype=None):
        return torch.randn(shape, generator=gen, device=dev).mul_(std) \
            .to(dtype or dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    params: Dict = {"embed": normal((V, D), 0.02), "final_norm": ones(D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), 0.02)
    if cfg.block_kind == "xlstm":
        if L % 2:
            raise ValueError(f"{cfg.name}: xlstm stacks (mLSTM, sLSTM) "
                             f"pairs; {L} layers is odd")
        params["pairs"] = init_xlstm_pair(normal, cfg, L // 2, dev)
        return params
    blocks = {"ln1": ones(L, D), "ln2": ones(L, D),
              **init_attn(normal, cfg, L)}
    if cfg.is_moe:
        blocks.update(init_moe(cfg, L, generator=gen, device=dev))
    elif cfg.d_ff:
        blocks.update(init_mlp(normal, cfg, L))
    if cfg.block_kind == "hymba":
        blocks.update(init_ssm(normal, cfg, L, dev))
        blocks["ln_ssm_out"] = ones(L, D)
        blocks["ln_attn_out"] = ones(L, D)
    params["blocks"] = blocks
    if cfg.enc_layers:
        E = cfg.enc_layers
        params["enc_blocks"] = {
            "ln1": ones(E, D), "ln2": ones(E, D),
            **init_attn(normal, cfg.scaled(n_layers=E), E),
            **init_mlp(normal, cfg, E)}
        params["enc_norm"] = ones(D)
    if cfg.cross_attention:
        params["cross_blocks"] = {"ln": ones(L, D),
                                  **init_attn(normal, cfg, L)}
    return params


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None, *,
               device=None, enc_len: int = 1536) -> Dict:
    """A zeroed decode cache; ``pos`` is a host int.  Attention families
    hold (L, batch, s_max, Hkv, hd) K and V, hymba also its SSM state
    ``h`` (L, batch, Hm, hd, N) in float32, an encoder-decoder the
    encoder's K/V ``ck`` / ``cv`` (L, batch, enc_len, Hkv, hd); xlstm holds
    each pair's recurrent state under ``pairs``."""
    require_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    if cfg.block_kind == "xlstm":
        st = init_xlstm_state(cfg, batch, dev)
        return {"pairs": {n: a.expand((L // 2,) + a.shape).contiguous()
                          for n, a in st.items()}, "pos": 0}
    shape = (L, batch, s_max, Hkv, hd)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}
    if cfg.block_kind == "hymba":
        cache["h"] = torch.zeros((L, batch, cfg.ssm_heads, hd,
                                  cfg.ssm_state), dtype=torch.float32,
                                 device=dev)
    if cfg.cross_attention:
        cshape = (L, batch, enc_len, Hkv, hd)
        cache["ck"] = torch.zeros(cshape, dtype=dt, device=dev)
        cache["cv"] = torch.zeros(cshape, dtype=dt, device=dev)
    return cache


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def _head(params, cfg: ModelConfig, x):
    x = constrain(rmsnorm(x, params["final_norm"], cfg.norm_eps))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(x @ head, model_dim=x.ndim - 1)


def _last_x(x, last_pos):
    """The per-row last *real* position of (B, S, D) activations:
    right-padded (length-bucketed) prompts read their logits at
    ``plen - 1`` rather than at the pad tail."""
    if last_pos is None:
        return x[:, -1:]
    lp = as_tokens(last_pos, x.device)
    return x[torch.arange(x.shape[0], device=x.device), lp][:, None]


def _inputs(params, tokens, embeds) -> torch.Tensor:
    """The decoder's input rows: ``embeds`` (the VLM path) when given, else
    the token embeddings."""
    dev = params["embed"].device
    if embeds is not None:
        return check_payload(embeds, dev, "embeds")
    if tokens is None:
        raise ValueError("pass tokens= or embeds=")
    if is_dtensor(params["embed"]):
        return constrain(sharded_lookup(params["embed"],
                                        as_tokens(tokens, dev)))
    return params["embed"][as_tokens(tokens, dev)]


def hymba_mix(attn_out, ssm_out, bp, cfg: ModelConfig) -> torch.Tensor:
    """hymba's parallel heads: each output normalized, then summed."""
    return rmsnorm(attn_out, bp["ln_attn_out"], cfg.norm_eps) + \
        rmsnorm(ssm_out, bp["ln_ssm_out"], cfg.norm_eps)


def _encoder_kv(enc_out, cbp, cfg: ModelConfig):
    """The cross attention's K and V (B, Se, Hkv, hd) from the encoder's
    output, pinned as ``attention`` pins its own (heads over ``model``)."""
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    return tuple(constrain(split_heads(enc_out @ cbp[w], Hkv, hd),
                           model_dim=2) for w in ("wk", "wv"))


def _run_encoder(params, cfg: ModelConfig, x, remat: bool = False
                 ) -> torch.Tensor:
    """The audio encoder over frame embeddings (B, Se, D): unmasked
    attention (rope at positions 0..Se-1) and the MLP, then its norm; with
    ``remat`` each block under non-reentrant checkpointing."""
    if x is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                         f"enc_embeds=")
    check_payload(x, params["embed"].device, "enc_embeds")
    ecfg = cfg.scaled(n_layers=cfg.enc_layers)
    enc = params["enc_blocks"]
    for i in range(cfg.enc_layers):
        def body(x, bp=layer(enc, i)):
            a, _ = attention(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp, ecfg,
                             causal=False)
            x = x + a
            return x + mlp(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp, cfg)
        x = _remat(body, remat, x)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _remat(body, on: bool, *args):
    """``body(*args)``, under non-reentrant checkpointing when ``on``."""
    return checkpoint(body, *args, use_reentrant=False) if on \
        else body(*args)


def _block(x, bp, cfg: ModelConfig, window, enc_out=None, cbp=None):
    """One decoder block over the full sequence -> (x, the MoE aux loss or
    None, (k, v, SSM state, encoder k, encoder v), None where the family
    has none).  With ``cfg.seq_shard`` the residual stream between blocks
    is sequence-sharded over ``model`` under a mesh (the reference's
    sequence parallelism): the projections take whole sequences, so the
    normed residual is gathered and the block's output scattered again."""
    sd = 1 if cfg.seq_shard else None
    x = constrain(x, model_dim=sd)
    h = constrain(rmsnorm(x, bp["ln1"], cfg.norm_eps))
    attn_out, (k, v) = attention(h, bp, cfg, window=window)
    hst = ek = ev = None
    if cfg.block_kind == "hymba":
        ssm_out, hst = ssm_scan(h, bp, cfg)
        attn_out = hymba_mix(attn_out, ssm_out, bp, cfg)
    x = x + attn_out
    if cbp is not None:
        ek, ev = _encoder_kv(enc_out, cbp, cfg)
        x = x + cross_attention(rmsnorm(x, cbp["ln"], cfg.norm_eps),
                                cbp, cfg, (ek, ev))
    aux = None
    if cfg.is_moe:
        # whole sequences into the router (the reference's pin of xg)
        ff, aux = moe_layer(constrain(rmsnorm(x, bp["ln2"], cfg.norm_eps)),
                            bp, cfg)
        x = x + ff
    elif cfg.d_ff:
        x = x + mlp(constrain(rmsnorm(x, bp["ln2"], cfg.norm_eps)), bp,
                    cfg)
    return constrain(x, model_dim=sd), aux, (k, v, hst, ek, ev)


def _layers(params, cfg: ModelConfig, x, windows, enc_out, with_aux):
    """The decoder stack over the full sequence -> (x, the MoE aux loss
    summed over layers when ``with_aux``, each layer's :func:`_block`
    states)."""
    blocks = params["blocks"]
    cross = params.get("cross_blocks")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    for i in range(cfg.n_layers):
        x, a, st = _block(x, layer(blocks, i), cfg, windows[i], enc_out,
                          None if cross is None else layer(cross, i))
        if with_aux and a is not None:
            aux = aux + a
        outs.append(st)
    return x, aux, outs


def _xlstm_stack(params, cfg: ModelConfig, x):
    """Every (mLSTM, sLSTM) pair over the sequence from a fresh state;
    returns (x, the per-pair states after S steps)."""
    states = []
    for i in range(cfg.n_layers // 2):
        st = init_xlstm_state(cfg, x.shape[0], x.device)
        x, st = xlstm_pair_scan(x, layer(params["pairs"], i), cfg, st)
        states.append(st)
    return x, states


# --------------------------------------------------------------------------
# forward, prefill, decode
# --------------------------------------------------------------------------
@torch.no_grad()
def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            enc_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), aux loss), for inference: no gradient.
    ``embeds`` overrides the token lookup (VLM path); ``enc_embeds`` feeds
    the encoder (audio path)."""
    require_supported(cfg)
    x = _inputs(params, tokens, embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block_kind == "xlstm":
        x, _ = _xlstm_stack(params, cfg, x)
        return _head(params, cfg, x), aux
    S = x.shape[1]
    enc_out = _run_encoder(params, cfg, enc_embeds) if cfg.enc_layers \
        else None
    x, aux, _ = _layers(params, cfg, x, layer_windows(cfg, S), enc_out,
                        with_aux=True)
    return _head(params, cfg, x), aux


def forward_train(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                  enc_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits (B, S, V), aux loss), differentiable: the training
    forward of every family (``embeds`` overrides the token lookup, the
    VLM path; ``enc_embeds`` feeds the encoder, the audio path).  With
    ``cfg.remat == "block"`` each block, encoder block and xlstm pair
    keeps only its input for the backward and recomputes the rest there
    (its flash launches and SSM scan run again)."""
    require_supported(cfg, grad=True)
    dev = params["embed"].device
    if embeds is not None:
        x = check_payload(embeds, dev, "embeds")
    elif tokens is None:
        raise ValueError("pass tokens= or embeds=")
    elif is_dtensor(params["embed"]):
        x = sharded_lookup(params["embed"], as_tokens(tokens, dev))
    else:
        tok = as_tokens(tokens, dev)
        x = gather_rows(params["embed"], tok.reshape(-1)) \
            .reshape(tuple(tok.shape) + (cfg.d_model,))
    x = constrain(x)
    remat = cfg.remat == "block"
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.block_kind == "xlstm":
        for i in range(cfg.n_layers // 2):
            def pair(x, pp=layer(params["pairs"], i)):
                st = init_xlstm_state(cfg, x.shape[0], x.device)
                return xlstm_pair_scan(x, pp, cfg, st)[0]
            x = _remat(pair, remat, x)
        return _head(params, cfg, x), aux
    enc_out = _run_encoder(params, cfg, enc_embeds, remat) \
        if cfg.enc_layers else None
    windows = layer_windows(cfg, x.shape[1])
    blocks, cross = params["blocks"], params.get("cross_blocks")
    for i in range(cfg.n_layers):
        # the cross K/V are projected from enc_out inside the body, so the
        # remat recomputes them as the reference's does
        def body(x, enc_out, i=i):
            y, a, _ = _block(x, layer(blocks, i), cfg, windows[i], enc_out,
                             None if cross is None else layer(cross, i))
            return y, (torch.zeros_like(aux) if a is None else a)
        x, a = _remat(body, remat, x, enc_out)
        aux = aux + a
    return _head(params, cfg, x), aux


@torch.no_grad()
def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            enc_embeds=None, s_max: Optional[int] = None,
            last_pos=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also returns the decode cache.
    tokens: (B, S) (or ``embeds`` (B, S, D)) -> (logits of the last
    position (B, V), cache).

    ``last_pos`` (B,) selects a per-row logit position for right-padded
    prompts (causal masking keeps real positions numerically unaffected by
    the pad tail; KV rows past ``last_pos`` hold pad junk that decode
    overwrites before its mask ever exposes them).  The cache is
    left-aligned in (L, B, s_max, Hkv, hd) tensors."""
    require_supported(cfg)
    x = _inputs(params, tokens, embeds)
    B, S, _ = x.shape
    if cfg.block_kind == "xlstm":
        x, states = _xlstm_stack(params, cfg, x)
        logits = _head(params, cfg, _last_x(x, last_pos))[:, 0]
        return logits, {"pairs": {n: torch.stack([st[n] for st in states])
                                  for n in states[0]}, "pos": S}
    s_max = s_max or S
    if S > s_max:
        raise ValueError(f"prompt of {S} tokens exceeds s_max={s_max}")
    enc_out = _run_encoder(params, cfg, enc_embeds) if cfg.enc_layers \
        else None
    x, _, outs = _layers(params, cfg, x, layer_windows(cfg, s_max), enc_out,
                         with_aux=False)
    if is_dtensor(x):
        return _head(params, cfg, _last_x(x, last_pos))[:, 0], \
            _stacked_cache(cfg, outs, S, s_max)
    cache = init_cache(cfg, B, s_max, x.dtype, device=x.device,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    for i, (k, v, hst, ek, ev) in enumerate(outs):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        if hst is not None:
            cache["h"][i] = hst
        if ek is not None:
            cache["ck"][i] = ek
            cache["cv"][i] = ev
    cache["pos"] = S
    return _head(params, cfg, _last_x(x, last_pos))[:, 0], cache


def _stacked_cache(cfg: ModelConfig, outs, S: int, s_max: int) -> Dict:
    """The decode cache of a prefill on a device mesh: each layer's K and V
    DTensors stacked along L and zero-padded to ``s_max``, hymba's SSM
    state ``h`` and the encoder's ``ck`` / ``cv`` stacked, each placed by
    ``cache_specs``."""
    from ..launch.mesh import mesh_sizes
    from .sharding import NamedSharding, cache_specs
    cache = {"pos": S}
    for n, j in (("k", 0), ("v", 1), ("h", 2), ("ck", 3), ("cv", 4)):
        if outs[0][j] is None:
            continue
        t = torch.stack([o[j] for o in outs])
        if n in ("k", "v") and s_max > S:
            pad = torch.zeros((t.shape[0], t.shape[1], s_max - S)
                              + tuple(t.shape[3:]), dtype=t.dtype,
                              device=t.device)
            t = torch.cat([t, pad], dim=2)
        cache[n] = t
    mesh = cache["k"].device_mesh
    specs = cache_specs(cache, cfg, mesh_sizes(mesh), cache["k"].shape[1],
                        s_max)
    for n in cache:
        if n != "pos":
            want = NamedSharding(mesh, specs[n]).placements
            cache[n] = cache[n].redistribute(mesh, want)
    return cache


def _set(stack, i: int, new) -> None:
    """``stack[i] = new`` for a cache leaf, a DTensor's on each rank's
    shard (``meshed.sharded_set``)."""
    if is_dtensor(stack):
        sharded_set(stack, i, new)
    else:
        stack[i] = new


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, tokens, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  tokens: (B,) -> (logits (B, V), cache').  The
    cache's tensors are updated in place (the returned cache shares them);
    ``pos`` advances by one."""
    require_supported(cfg)
    dev = params["embed"].device
    if is_dtensor(params["embed"]):
        x = constrain(sharded_lookup(params["embed"],
                                     as_tokens(tokens, dev)[:, None]))
    else:
        x = params["embed"][as_tokens(tokens, dev)[:, None]]
    pos = int(cache["pos"])
    if cfg.block_kind == "xlstm":
        pairs = cache["pairs"]
        for i in range(cfg.n_layers // 2):
            x, st = xlstm_pair_step(x, layer(params["pairs"], i), cfg,
                                    layer(pairs, i))
            for n, a in st.items():
                _set(pairs[n], i, a)
        return _head(params, cfg, x)[:, 0], {"pairs": pairs, "pos": pos + 1}
    s_max = cache["k"].shape[2]
    if pos >= s_max:
        raise ValueError(f"decode position {pos} is past s_max={s_max}")
    windows = layer_windows(cfg, s_max)
    blocks = params["blocks"]
    cross = params.get("cross_blocks")
    for i in range(cfg.n_layers):
        bp = layer(blocks, i)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        attn_out, _, _ = attention_decode(h, bp, cfg, cache["k"][i],
                                          cache["v"][i], pos,
                                          window=windows[i])
        if cfg.block_kind == "hymba":
            ssm_out, hst = ssm_step(h, bp, cfg, cache["h"][i])
            _set(cache["h"], i, hst)
            attn_out = hymba_mix(attn_out, ssm_out, bp, cfg)
        x = x + attn_out
        if cross is not None:
            cbp = layer(cross, i)
            x = x + cross_attention(rmsnorm(x, cbp["ln"], cfg.norm_eps),
                                    cbp, cfg, (cache["ck"][i],
                                               cache["cv"][i]))
        if cfg.is_moe or cfg.d_ff:
            x = x + feed_forward(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp,
                                 cfg)
    logits = _head(params, cfg, x)[:, 0]
    return logits, {**cache, "pos": pos + 1}
