"""Plain reference of the training cells: a pre-norm GQA transformer with
top-k experts, trained by AdamW, in float32 with TF32 off, written with
plain ``torch`` operations and nothing of the program.

The model is the one the program trains (its semantics, not its code):

* the token embedding; per layer RMSNorm, q / k / v projections, rotary
  embedding on the two halves of each head, causal softmax attention with
  query head h reading key/value head h // (H / Hkv), the output
  projection and the residual; RMSNorm, the router (softmax over the
  experts, the top k renormalised), each group's picks ranked within their
  expert in (token, pick) order and kept below the capacity
  C = ceil(T k cf / E), SwiGLU experts, the kept picks' outputs weighted
  and summed, the residual;
* the final RMSNorm and the LM head; the token-mean cross-entropy, the
  z-loss on the log-sum-exp, and the load-balance loss E sum(me ce) of
  every layer (me the mean router probability, ce the share of top-1
  picks);
* AdamW with a global-norm clip, bias corrections, decoupled decay on the
  leaves stored with two or more dimensions, and linear warm-up then
  cosine decay of the rate.

``mm`` is the one matrix product every projection, the attention's two
contractions and the head go through, and ``store`` the rounding of a
stored weight (at the start and after every update): float32 and none by
default.  The control stores the weights the program keeps in bfloat16 in
float8 instead and rounds both operands of every product to float8; a
second control rounds the products' operands alone.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["loss", "lr_at", "train", "f32_mm", "fp8_mm", "bf16_mm",
           "round_fp8", "round_bf16", "no_tf32"]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values rounded to float8 e4m3 under one scale for the
    whole tensor (its largest magnitude onto 448), in float32."""
    if t.numel() == 0:
        return t
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _through(t: torch.Tensor, rnd) -> torch.Tensor:
    """``rnd(t)`` in the forward, the rounding invisible to the
    gradient."""
    return t + (rnd(t.detach()) - t.detach())


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_through(a, round_fp8), _through(b, round_fp8))


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_through(a, round_bf16), _through(b, round_bf16))


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x (B, S, H, hd) rotated by position, the halves of each head as
    the pair."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                          device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * freqs[None]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(h, P, l, m, mm):
    B, S, D = h.shape
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(h, P["blocks.wq"][l]).reshape(B, S, H, hd)
    k = mm(h, P["blocks.wk"][l]).reshape(B, S, Hkv, hd)
    v = mm(h, P["blocks.wv"][l]).reshape(B, S, Hkv, hd)
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    rep = H // Hkv
    q = q.permute(0, 2, 1, 3)                               # B H S hd
    k = k.permute(0, 2, 3, 1).repeat_interleave(rep, 1)     # B H hd S
    v = v.permute(0, 2, 1, 3).repeat_interleave(rep, 1)     # B H S hd
    s = mm(q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    o = mm(p, v).permute(0, 2, 1, 3).reshape(B, S, H * hd)
    return mm(o, P["blocks.wo"][l])


def _experts(h, P, l, m, mm):
    """The expert layer over h (B, S, D) -> (y, load-balance loss)."""
    B, S, D = h.shape
    E, k = m["moe_experts"], m["moe_topk"]
    G = B if S > 1 else 1
    T = B * S // G
    C = max(int(math.ceil(T * k * m["moe_capacity"] / E)), 1)
    x = h.reshape(G * T, D)
    probs = torch.softmax(x @ P["blocks.router"][l], dim=-1)   # float32
    wk, eidx = torch.topk(probs, k, dim=-1)
    wk = wk / wk.sum(dim=-1, keepdim=True)
    # rank of each pick within its expert, picks in (token, pick) order
    picks = eidx.reshape(G, T * k)
    onehot = F.one_hot(picks, E)
    rank = (torch.cumsum(onehot, dim=1) - 1).gather(-1, picks[..., None])
    keep = (rank[..., 0] < C).reshape(-1)
    flat_e = picks.reshape(-1)
    w = wk.reshape(-1)
    sels, outs = [], []
    for e in range(E):
        sel = torch.nonzero((flat_e == e) & keep)[:, 0]
        xe = x[sel // k]
        ye = mm(F.silu(mm(xe, P["blocks.w_gate"][l, e]))
                * mm(xe, P["blocks.w_in"][l, e]), P["blocks.w_out"][l, e])
        sels.append(sel)
        outs.append(ye * w[sel, None])
    out = x.new_zeros((G * T * k, D)).index_put((torch.cat(sels),),
                                                torch.cat(outs))
    y = out.reshape(G * T, k, D).sum(dim=1).reshape(B, S, D)
    me = probs.mean(dim=0)
    ce = torch.bincount(eidx[:, 0], minlength=E).float() / (G * T)
    return y, E * torch.sum(me * ce)


def _block(x, P, l, m, mm):
    x = x + _attention(_rms(x, P["blocks.ln1"][l], m["norm_eps"]), P, l, m,
                       mm)
    y, a = _experts(_rms(x, P["blocks.ln2"][l], m["norm_eps"]), P, l, m, mm)
    return x + y, a


def loss(P: Dict[str, torch.Tensor], tokens, labels, m: dict, tc: dict,
         mm: Callable = f32_mm) -> torch.Tensor:
    """The training loss of the float32 leaves ``P`` (dotted names) on
    one batch; each layer's activations are recomputed in the backward,
    so that one layer's attention scores are held at a time."""
    x = P["embed"][tokens]
    aux = x.new_zeros(())
    for l in range(m["n_layers"]):
        x, a = checkpoint(_block, x, P, l, m, mm, use_reentrant=False)
        aux = aux + a
    logits = mm(_rms(x, P["final_norm"], m["norm_eps"]), P["lm_head"])
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    ce = torch.mean(lse - gold) + tc["z_loss"] * torch.mean(lse * lse)
    return ce + tc["aux_loss"] * aux


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["decay_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def train(P0: Dict[str, torch.Tensor], batches: List[dict], m: dict,
          tc: dict, opt: dict, mm: Callable = f32_mm,
          store: Dict[str, Callable] = None,
          probe: Dict[str, torch.Tensor] = None) -> dict:
    """AdamW steps in float32 from the leaves ``P0`` (left as they are),
    one a batch: each step's loss, each leaf's first gradient norm (before
    the clip) and its entries at the flat positions ``probe[name]``, and
    each leaf's change after the last step (float64 norms).
    ``store[name]`` rounds that leaf wherever it is stored."""
    names = list(P0)
    keep = {n: (store or {}).get(n, lambda t: t) for n in names}
    P = {n: keep[n](P0[n].detach().float().clone()) for n in names}
    mom = {n: torch.zeros_like(P[n]) for n in names}
    vel = {n: torch.zeros_like(P[n]) for n in names}
    losses, first, first_probe = [], None, {}
    for step, batch in enumerate(batches, start=1):
        leaves = [P[n].requires_grad_() for n in names]
        val = loss(P, batch["tokens"], batch["labels"], m, tc, mm)
        grads = torch.autograd.grad(val, leaves)
        losses.append(float(val.detach()))
        with torch.no_grad():
            norms = [torch.linalg.vector_norm(g.double()) for g in grads]
            if first is None:
                first = {n: float(x) for n, x in zip(names, norms)}
                first_probe = {n: g.reshape(-1)[probe[n]].clone()
                               for n, g in zip(names, grads)
                               if n in (probe or {})}
            gnorm = float(torch.linalg.vector_norm(torch.stack(norms)))
            clip = min(opt["grad_clip"] / max(gnorm, 1e-12), 1.0) \
                if opt["grad_clip"] else 1.0
            lr = lr_at(opt, step)
            bc1, bc2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
            for n, g in zip(names, grads):
                p = P[n].detach()
                g = g * clip
                mom[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                vel[n].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                delta = (mom[n] / bc1) / (torch.sqrt(vel[n] / bc2)
                                          + opt["eps"])
                if p.dim() >= 2:
                    delta = delta + opt["weight_decay"] * p
                P[n] = keep[n](p - lr * delta)
        del grads, leaves
    change = {n: float(torch.linalg.vector_norm(
        (P[n] - P0[n].float()).double())) for n in names}
    return {"losses": losses, "first_grad_norm": first,
            "first_grad_probe": first_probe, "change_norm": change}
