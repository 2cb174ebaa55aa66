"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory) cells with stabilized exponential gating (the port of
``repro/models/xlstm.py``).

The 24-layer xlstm-350m config alternates mLSTM/sLSTM; the stack runs over
*pairs* (mLSTM block then sLSTM block) with the layer params stacked on a
leading pairs axis.  Both cells are recurrences in float32; decode is one
step on the carried state.

The reference steps the pair as one unit per time step.  Within a step the
sLSTM block reads only the mLSTM block's output at that step, and each
cell's recurrence reads only its own state, so here the mLSTM block runs
over the whole sequence first and the sLSTM block after it: the
projections of every step are one matrix product each, and only the cell
arithmetic is stepped in time.  The scan returns the state after exactly
S steps; the reference pads the time axis to a multiple of its 128-step
chunk and returns the state after the pad steps too, where the forget
gate's bias moves it (ROADMAP Queue 3), which this port does not copy.

State per (batch, head): mLSTM ``mC`` (hd × hd), ``mn`` (hd), ``mm`` ();
sLSTM ``sc``, ``sn``, ``sh`` (hd each) and ``sm`` ().
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig, torch_dtype
from .layers import rmsnorm

__all__ = ["init_xlstm_pair", "init_xlstm_state", "xlstm_pair_scan",
           "xlstm_pair_step"]


def init_xlstm_pair(normal: Callable, cfg: ModelConfig, pairs: int,
                    device: torch.device) -> Dict:
    """Params of ``pairs`` stacked (mLSTM, sLSTM) block pairs on
    ``device``, scaled as the reference scales them; ``normal(shape, std,
    dtype=None)`` draws them (in cfg.dtype unless ``dtype`` is given)."""
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    s = 1.0 / np.sqrt(D)
    so = s / np.sqrt(2 * cfg.n_layers)
    f32 = torch.float32
    dt = torch_dtype(cfg.dtype)

    def ones():
        return torch.ones((pairs, D), dtype=dt, device=device)

    def bias():
        return torch.full((pairs, H), 3.0, dtype=f32, device=device)

    return {
        # ---- mLSTM
        "m_norm": ones(),
        "m_wq": normal((pairs, D, D), s),
        "m_wk": normal((pairs, D, D), s),
        "m_wv": normal((pairs, D, D), s),
        "m_wi": normal((pairs, D, H), s, f32),
        "m_wf": normal((pairs, D, H), s, f32),
        "m_bf": bias(),                          # open forget gates
        "m_wo": normal((pairs, D, D), s),
        "m_out": normal((pairs, D, D), so),
        # ---- sLSTM
        "s_norm": ones(),
        "s_wz": normal((pairs, D, D), s),
        "s_wi": normal((pairs, D, H), s, f32),
        "s_wf": normal((pairs, D, H), s, f32),
        "s_bf": bias(),
        "s_wo": normal((pairs, D, D), s),
        "s_rz": normal((pairs, H, hd, hd), 1.0 / np.sqrt(hd)),
        "s_out": normal((pairs, D, D), so),
    }


def init_xlstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def low(*shape):
        return torch.full(shape, -1e30, dtype=torch.float32, device=device)

    return {"mC": z(batch, H, hd, hd), "mn": z(batch, H, hd),
            "mm": low(batch, H), "sc": z(batch, H, hd),
            "sn": z(batch, H, hd), "sm": low(batch, H),
            "sh": z(batch, H, hd)}


def _log_sigmoid(f_raw):
    return -F.softplus(-f_raw)


def _mlstm_cell(q, k, v, i_raw, f_raw, C, n, m):
    """Stabilized mLSTM update for one step (all heads).
    q / k / v: (B, H, hd); i_raw / f_raw: (B, H)."""
    logf = _log_sigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_g = torch.exp(i_raw - m_new)[..., None]
    f_g = torch.exp(logf + m - m_new)[..., None]
    C = f_g[..., None] * C + i_g[..., None] * (v[..., None] * k[..., None, :])
    n = f_g * n + i_g * k
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    return num / den[..., None], C, n, m_new


def _slstm_cell(z_raw, i_raw, f_raw, o_in, rz, c, n, m, h_prev):
    """Stabilized sLSTM update; the recurrent connection is per-head
    ``rz @ h``."""
    z = torch.tanh(z_raw + torch.einsum("bhd,hde->bhe", h_prev, rz))
    logf = _log_sigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_g = torch.exp(i_raw - m_new)[..., None]
    f_g = torch.exp(logf + m - m_new)[..., None]
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h = torch.sigmoid(o_in) * c / torch.clamp(n, min=1.0)
    return h, c, n, m_new


def _mlstm_block(x, p, cfg: ModelConfig, st: Dict):
    """The mLSTM block (pre-norm residual) over x (B, S, D); returns (x +
    y, (C, n, m) after S steps)."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    f32 = torch.float32
    xa = rmsnorm(x, p["m_norm"], cfg.norm_eps)
    q = (xa @ p["m_wq"]).reshape(B, S, H, hd).to(f32)
    k = ((xa @ p["m_wk"]).reshape(B, S, H, hd) / math.sqrt(hd)).to(f32)
    v = (xa @ p["m_wv"]).reshape(B, S, H, hd).to(f32)
    xf = xa.to(f32)
    i_raw = xf @ p["m_wi"]
    f_raw = xf @ p["m_wf"] + p["m_bf"]
    C, n, m = st["mC"], st["mn"], st["mm"]
    hs = torch.empty((B, S, H, hd), dtype=f32, device=x.device)
    for t in range(S):
        hs[:, t], C, n, m = _mlstm_cell(q[:, t], k[:, t], v[:, t],
                                        i_raw[:, t], f_raw[:, t], C, n, m)
    o_gate = torch.sigmoid(xa @ p["m_wo"])
    y = (hs.reshape(B, S, D).to(x.dtype) * o_gate) @ p["m_out"]
    return x + y, (C, n, m)


def _slstm_block(x, p, cfg: ModelConfig, st: Dict):
    """The sLSTM block (pre-norm residual) over x (B, S, D); returns (x +
    y, (c, n, m, h) after S steps)."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    f32 = torch.float32
    xb = rmsnorm(x, p["s_norm"], cfg.norm_eps)
    z_raw = (xb @ p["s_wz"]).reshape(B, S, H, hd).to(f32)
    xf = xb.to(f32)
    i_raw = xf @ p["s_wi"]
    f_raw = xf @ p["s_wf"] + p["s_bf"]
    o_in = (xb @ p["s_wo"]).reshape(B, S, H, hd).to(f32)
    rz = p["s_rz"].to(f32)
    c, n, m, h = st["sc"], st["sn"], st["sm"], st["sh"]
    hs = torch.empty((B, S, H, hd), dtype=f32, device=x.device)
    for t in range(S):
        h, c, n, m = _slstm_cell(z_raw[:, t], i_raw[:, t], f_raw[:, t],
                                 o_in[:, t], rz, c, n, m, h)
        hs[:, t] = h
    y = hs.reshape(B, S, D).to(x.dtype) @ p["s_out"]
    return x + y, (c, n, m, h)


def xlstm_pair_scan(x: torch.Tensor, p: Dict, cfg: ModelConfig,
                    state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Run one (mLSTM, sLSTM) pair over a sequence.  x: (B, S, D) ->
    (y (B, S, D), the state after exactly S steps)."""
    x, (C, n, m) = _mlstm_block(x, p, cfg, state)
    x, (c, n2, m2, h) = _slstm_block(x, p, cfg, state)
    return x, {"mC": C, "mn": n, "mm": m, "sc": c, "sn": n2, "sm": m2,
               "sh": h}


def xlstm_pair_step(x: torch.Tensor, p: Dict, cfg: ModelConfig,
                    state: Dict) -> Tuple[torch.Tensor, Dict]:
    """Decode: x (B, 1, D) -> ((B, 1, D), state')."""
    return xlstm_pair_scan(x, p, cfg, state)
