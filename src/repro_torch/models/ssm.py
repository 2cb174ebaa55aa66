"""Selective state-space (Mamba-family) heads for the hymba hybrid blocks
(the port of ``repro/models/ssm.py``).

Hymba (arXiv:2411.13676) runs attention heads and SSM heads *in parallel*
inside each block on the same input, then sums their (individually
normalized) outputs.  The SSM is a diagonal selective scan:

    h_t = exp(-softplus(A) * Δ_t) ⊙ h_{t-1} + Δ_t * (u_t ⊗ B_t)
    y_t = (h_t · C_t) * gate

with per-head state (hd × N), kept in float32 and stepped in time order as
the reference's ``lax.scan`` steps it.  The gates and projections of every
step are computed at once; the recurrence itself is two operations a step
(``addcmul`` for the state, a batched matrix-vector product for y).  On a
CUDA device the steps run in chunks of ``time_chunk`` as replays of one
captured CUDA graph (:class:`_ChunkGraph`, one per batch and head shape):
the same operations on the same values, one host launch a chunk instead of
two a step.  A scan shorter than a chunk, and the last chunk of a longer
one, feed the missing steps Δ = 0 (a decay of 1 and no input), which leaves
the state exactly as it was, so the returned state is the state after
exactly S steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["init_ssm", "ssm_scan", "ssm_step"]


def init_ssm(normal: Callable, cfg: ModelConfig, layers: int,
             device: torch.device) -> Dict:
    """SSM weights of ``layers`` stacked layers on ``device``, scaled as
    the reference scales them; ``normal(shape, std, dtype=None)`` draws
    them (in cfg.dtype unless ``dtype`` is given)."""
    D = cfg.d_model
    Hm, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
    P = Hm * hd
    s = 1.0 / np.sqrt(D)
    f32 = torch.float32
    return {
        "in_proj": normal((layers, D, P), s),
        "gate_proj": normal((layers, D, P), s),
        "out_proj": normal((layers, P, D), s / np.sqrt(2 * cfg.n_layers)),
        "w_bc": normal((layers, Hm, hd, 2 * N), 1.0 / np.sqrt(hd)),
        "w_dt": normal((layers, Hm, hd), 0.01, f32),
        "b_dt": torch.full((layers, Hm), float(np.log(np.expm1(0.01))),
                           dtype=f32, device=device),
        "a_log": torch.log(torch.arange(1, N + 1, dtype=f32,
                                        device=device))
        .expand(layers, Hm, N).contiguous(),
    }


def _gates(u: torch.Tensor, p: Dict):
    """u: (B, S, Hm, hd) -> Δ (B, S, Hm, 1), Bc / Cc (B, S, Hm, N) in
    float32, A (Hm, N)."""
    bc = torch.einsum("bshd,hdn->bshn", u, p["w_bc"])
    N = bc.shape[-1] // 2
    Bc, Cc = bc[..., :N], bc[..., N:]
    dt_raw = torch.einsum("bshd,hd->bsh", u.float(), p["w_dt"])
    delta = F.softplus(dt_raw + p["b_dt"][None, None])[..., None]
    A = -torch.exp(p["a_log"])                               # (Hm, N)
    return delta, Bc.float(), Cc.float(), A


def _steps(h, dec, inp, cc, ys) -> None:
    """The recurrence over the leading (time) axis of ``dec`` (T, B, Hm, 1,
    N), ``inp`` (T, B, Hm, hd, N) and ``cc`` (T, B, Hm, N, 1): ``h`` is
    updated in place and ``ys[t]`` (B, Hm, hd, 1) written."""
    for t in range(dec.shape[0]):
        torch.addcmul(inp[t], h, dec[t], out=h)
        torch.matmul(h, cc[t], out=ys[t])


class _ChunkGraph:
    """``time_chunk`` steps of the recurrence captured once as a CUDA graph
    on static buffers, replayed per chunk."""

    def __init__(self, C: int, B: int, Hm: int, hd: int, N: int,
                 device: torch.device):
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
        self.h = z(B, Hm, hd, N)
        self.dec, self.inp = z(C, B, Hm, 1, N), z(C, B, Hm, hd, N)
        self.cc, self.ys = z(C, B, Hm, N, 1), z(C, B, Hm, hd, 1)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):          # warm the kernels first
            _steps(self.h, self.dec[:1], self.inp[:1], self.cc[:1],
                   self.ys[:1])
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _steps(self.h, self.dec, self.inp, self.cc, self.ys)

    def run(self, h, dec, inp, cc, ys) -> None:
        """The steps of one chunk of at most C steps: ``h`` in place, ``ys``
        written; missing steps are fed a decay of 1 and no input."""
        n = dec.shape[0]
        self.h.copy_(h)
        self.dec[:n].copy_(dec)
        self.inp[:n].copy_(inp)
        self.cc[:n].copy_(cc)
        if n < self.dec.shape[0]:
            self.dec[n:].fill_(1.0)
            self.inp[n:].zero_()
        self.graph.replay()
        h.copy_(self.h)
        ys.copy_(self.ys[:n])

    @property
    def nbytes(self) -> int:
        """Bytes of the static buffers the graph keeps allocated."""
        return sum(t.nbytes for t in (self.h, self.dec, self.inp, self.cc,
                                      self.ys))


# one graph per (time_chunk, batch, head shapes, device): a scan of any
# length replays it, the last chunk padded, so the prompt length is no key
_GRAPHS: Dict[tuple, _ChunkGraph] = {}


def _chunk_graph(C, B, Hm, hd, N, device) -> _ChunkGraph:
    key = (C, B, Hm, hd, N, str(device))
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = _ChunkGraph(C, B, Hm, hd, N, device)
    return g


def ssm_scan(x: torch.Tensor, p: Dict, cfg: ModelConfig,
             h0: Optional[torch.Tensor] = None, time_chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), h after S steps (B, Hm, hd, N))."""
    B, S, _ = x.shape
    Hm, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
    u = (x @ p["in_proj"]).reshape(B, S, Hm, hd)
    gate = F.silu(x @ p["gate_proj"]).reshape(B, S, Hm, hd)
    delta, Bc, Cc, A = _gates(u, p)
    h = torch.zeros((B, Hm, hd, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float().clone()
    ys = torch.empty((S, B, Hm, hd, 1), dtype=torch.float32, device=x.device)
    C = time_chunk
    # (inside a caller's own capture the steps are launched one by one: a
    # graph is not captured within another)
    graph = _chunk_graph(C, B, Hm, hd, N, x.device) \
        if x.device.type == "cuda" and S \
        and not torch.cuda.is_current_stream_capturing() else None
    for t0 in range(0, S, C):
        t1 = min(t0 + C, S)
        d = delta[:, t0:t1].transpose(0, 1)                  # (T,B,Hm,1)
        dec = torch.exp(A[None, None] * d)[:, :, :, None, :]
        u_t = u[:, t0:t1].transpose(0, 1).float()
        inp = (d[..., None] * u_t[..., None]) \
            * Bc[:, t0:t1].transpose(0, 1)[:, :, :, None, :]
        cc = Cc[:, t0:t1].transpose(0, 1)[..., None]
        if graph is None:
            _steps(h, dec, inp, cc, ys[t0:t1])
        else:
            graph.run(h, dec, inp, cc, ys[t0:t1])
    y = ys[..., 0].transpose(0, 1).to(x.dtype) * gate
    return y.reshape(B, S, Hm * hd) @ p["out_proj"], h


def ssm_step(x: torch.Tensor, p: Dict, cfg: ModelConfig, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  x: (B, 1, D); h: (B, Hm, hd, N) -> (y (B, 1,
    D), h')."""
    B = x.shape[0]
    Hm, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
    u = (x @ p["in_proj"]).reshape(B, 1, Hm, hd)
    gate = F.silu(x @ p["gate_proj"]).reshape(B, 1, Hm, hd)
    delta, Bc, Cc, A = _gates(u, p)
    u_t, d_t = u[:, 0].float(), delta[:, 0]
    decay = torch.exp(A[None] * d_t)
    h = h * decay[:, :, None, :] + (d_t[:, :, None] * u_t[..., None]) \
        * Bc[:, 0][:, :, None, :]
    y = torch.einsum("bhdn,bhn->bhd", h, Cc[:, 0])[:, None].to(x.dtype) \
        * gate
    return y.reshape(B, 1, Hm * hd) @ p["out_proj"], h
