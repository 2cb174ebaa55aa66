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

Under grad the recurrence is :class:`_SelectiveScan`, an autograd Function
with the reference's remat contract (``jax.checkpoint`` around each chunk):
its forward is the loop above, bit for bit, and keeps only the state at
each chunk's start; its backward walks the chunks in reverse, recomputes a
chunk's states from its start and runs the reverse recurrence

    g_t = dy_t ⊗ C_t + dec_{t+1} ⊙ g_{t+1},   dec_{S+1} ⊙ g_{S+1} = dL/dh_S

from which d inp_t = g_t, d dec_t = Σ_hd g_t ⊙ h_{t-1}, d C_t = Σ_hd dy_t ⊙
h_t and d h_0 = dec_1 ⊙ g_1.  The per-step decay and input are built one
chunk at a time from Δ, u, B and A (forward and backward), so no (S, B,
Hm, hd, N) tensor is ever whole.  On a CUDA device the recompute and the
reverse steps replay captured graphs too (:class:`_ChunkBackGraph`); the
gates' own ops stay ordinary autograd.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import is_fake
from ..launch.op_cost import trips
from .config import ModelConfig
from .graphs import capture
from .meshed import is_dtensor, sharded_heads, split_heads
from .sharding import merge_heads

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


def _one_trip(t: torch.Tensor, T: int) -> bool:
    """Whether a loop of T steps on ``t`` runs one step counted T times
    (the dry run's fake tensors: ``launch.op_cost.trips``)."""
    return T > 1 and is_fake(t)


def _steps(h, dec, inp, cc, ys) -> None:
    """The recurrence over the leading (time) axis of ``dec`` (T, B, Hm, 1,
    N), ``inp`` (T, B, Hm, hd, N) and ``cc`` (T, B, Hm, N, 1): ``h`` is
    updated in place and ``ys[t]`` (B, Hm, hd, 1) written."""
    if _one_trip(h, dec.shape[0]):
        with trips(dec.shape[0]):
            return _steps(h, dec[:1], inp[:1], cc[:1], ys[:1])
    for t in range(dec.shape[0]):
        torch.addcmul(inp[t], h, dec[t], out=h)
        torch.matmul(h, cc[t], out=ys[t])


def _capture(steps, C: int, device: torch.device):
    """``steps(k)`` launches k steps on static buffers: C of them captured
    (``graphs.capture``, warmed with one)."""
    return capture(lambda: steps(C), device, warm=lambda: steps(1))


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
        self.graph = _capture(
            lambda k: _steps(self.h, self.dec[:k], self.inp[:k],
                             self.cc[:k], self.ys[:k]), C, device)

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


class _ChunkBackGraph:
    """The backward of ``time_chunk`` steps as two CUDA graphs on shared
    static buffers: the recompute of a chunk's states from its start
    (``hs[t + 1] = dec[t] ⊙ hs[t] + inp[t]``, the forward's own ``addcmul``)
    and the reverse recurrence (``G[t] = g + dy[t] ⊗ cT[t]``, then ``g =
    dec[t] ⊙ G[t]``), replayed per chunk."""

    def __init__(self, C: int, B: int, Hm: int, hd: int, N: int,
                 device: torch.device):
        z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
        self.hs = z(C + 1, B, Hm, hd, N)
        self.dec, self.inp = z(C, B, Hm, 1, N), z(C, B, Hm, hd, N)
        self.g, self.G = z(B, Hm, hd, N), z(C, B, Hm, hd, N)
        self.dy, self.cT = z(C, B, Hm, hd, 1), z(C, B, Hm, 1, N)
        self.recompute = _capture(
            lambda k: _recompute(self.hs[:k + 1], self.dec[:k],
                                 self.inp[:k]), C, device)
        self.reverse = _capture(
            lambda k: _reverse(self.g, self.dec[:k], self.dy[:k],
                               self.cT[:k], self.G[:k]), C, device)

    def run(self, h0, dec, inp, dy, cT, g):
        """One chunk of at most C steps: -> (its states hs (n + 1, ...),
        G (n, ...)), views of the static buffers valid until the next
        ``run``; ``g`` is updated in place.  Missing steps get a decay of
        1, no input and no output gradient, which leaves g as it was."""
        n = dec.shape[0]
        self.hs[0].copy_(h0)
        self.dec[:n].copy_(dec)
        self.inp[:n].copy_(inp)
        self.dy[:n].copy_(dy)
        self.cT[:n].copy_(cT)
        if n < self.dec.shape[0]:
            self.dec[n:].fill_(1.0)
            self.inp[n:].zero_()
            self.dy[n:].zero_()
        self.recompute.replay()
        self.g.copy_(g)
        self.reverse.replay()
        g.copy_(self.g)
        return self.hs[:n + 1], self.G[:n]

    @property
    def nbytes(self) -> int:
        """Bytes of the static buffers the graphs keep allocated."""
        return sum(t.nbytes for t in (self.hs, self.dec, self.inp, self.g,
                                      self.G, self.dy, self.cT))


def _recompute(hs, dec, inp) -> None:
    """The states of a chunk from ``hs[0]``: ``hs[t + 1]`` written."""
    if _one_trip(hs, dec.shape[0]):
        with trips(dec.shape[0]):
            return _recompute(hs[:2], dec[:1], inp[:1])
    for t in range(dec.shape[0]):
        torch.addcmul(inp[t], hs[t], dec[t], out=hs[t + 1])


def _reverse(g, dec, dy, cT, G) -> None:
    """The reverse recurrence over a chunk, last step first: ``G[t]`` (the
    gradient of step t's state) written, ``g`` updated in place to the
    gradient that reaches the state before the chunk."""
    if _one_trip(g, dec.shape[0]):
        with trips(dec.shape[0]):
            return _reverse(g, dec[-1:], dy[-1:], cT[-1:], G[-1:])
    for t in range(dec.shape[0] - 1, -1, -1):
        torch.addcmul(g, dy[t], cT[t], out=G[t])
        torch.mul(G[t], dec[t], out=g)


# one graph per (kind, time_chunk, batch, head shapes, device): a scan of
# any length replays it, the last chunk padded, so the length is no key
_GRAPHS: Dict[tuple, object] = {}


def _graph(kind, C, B, Hm, hd, N, device):
    key = (kind.__name__, C, B, Hm, hd, N, str(device))
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = kind(C, B, Hm, hd, N, device)
    return g


def _use_graphs(t: torch.Tensor, S: int) -> bool:
    """Replay graphs for a tensor on a CUDA device, except inside a
    caller's own capture (a graph is not captured within another: the
    steps are launched one by one there) and for the dry run's fake
    tensors (no memory to capture)."""
    return t.device.type == "cuda" and S > 0 and not is_fake(t) \
        and not torch.cuda.is_current_stream_capturing()


def _chunk_inputs(delta, u, Bc, A, t0: int, t1: int):
    """Steps t0..t1's decay (T, B, Hm, 1, N) and input (T, B, Hm, hd, N),
    in float32, from Δ (B, S, Hm, 1), u (B, S, Hm, hd), B (B, S, Hm, N)
    and A (Hm, N)."""
    d = delta[:, t0:t1].transpose(0, 1)                      # (T,B,Hm,1)
    dec = torch.exp(A[None, None] * d)[:, :, :, None, :]
    u_t = u[:, t0:t1].transpose(0, 1).float()
    inp = (d[..., None] * u_t[..., None]) \
        * Bc[:, t0:t1].transpose(0, 1)[:, :, :, None, :]
    return dec, inp


def _scan(delta, u, Bc, Cc, A, h, C: int, starts=None) -> torch.Tensor:
    """The recurrence over all S steps in chunks of C: ``h`` (B, Hm, hd, N)
    float32 updated in place; returns ys (S, B, Hm, hd, 1).  ``starts``, a
    list, gets a copy of the state at each chunk's start."""
    B, S = delta.shape[:2]
    Hm, hd, N = h.shape[1:]
    ys = torch.empty((S, B, Hm, hd, 1), dtype=torch.float32, device=h.device)
    graph = _graph(_ChunkGraph, C, B, Hm, hd, N, h.device) \
        if _use_graphs(h, S) else None
    for t0 in range(0, S, C):
        t1 = min(t0 + C, S)
        if starts is not None:
            starts.append(h.clone())
        dec, inp = _chunk_inputs(delta, u, Bc, A, t0, t1)
        cc = Cc[:, t0:t1].transpose(0, 1)[..., None]
        if graph is None:
            _steps(h, dec, inp, cc, ys[t0:t1])
        else:
            graph.run(h, dec, inp, cc, ys[t0:t1])
    return ys


class _SelectiveScan(torch.autograd.Function):
    """``_SelectiveScan.apply(delta, u, Bc, Cc, A, h0, time_chunk) -> (ys
    (S, B, Hm, hd, 1), h after S steps)``, differentiable in all six
    tensors; saves the state at each chunk's start and nothing per step."""

    @staticmethod
    def forward(ctx, delta, u, Bc, Cc, A, h0, time_chunk):
        h = h0.clone()
        starts = []
        ys = _scan(delta, u, Bc, Cc, A, h, time_chunk, starts)
        ctx.time_chunk = time_chunk
        ctx.save_for_backward(delta, u, Bc, Cc, A,
                              torch.stack(starts) if starts
                              else h.new_empty((0,) + tuple(h.shape)))
        return ys, h

    @staticmethod
    def backward(ctx, dys, dh):
        delta, u, Bc, Cc, A, starts = ctx.saved_tensors
        C = ctx.time_chunk
        B, S = delta.shape[:2]
        Hm, hd, N = starts.shape[2:]
        g = dh.detach().float().clone()
        d_delta, d_u, d_Bc, d_Cc, d_A = (torch.zeros_like(t) for t in
                                         (delta, u, Bc, Cc, A))
        A_ = A.detach().requires_grad_()
        graph = _graph(_ChunkBackGraph, C, B, Hm, hd, N, g.device) \
            if _use_graphs(g, S) else None
        for ci in range((S + C - 1) // C - 1, -1, -1):
            t0, t1 = ci * C, min(ci * C + C, S)
            ins = [t[:, t0:t1].detach().requires_grad_()
                   for t in (delta, u, Bc)]
            with torch.enable_grad():
                dec, inp = _chunk_inputs(ins[0], ins[1], ins[2], A_, 0,
                                         t1 - t0)
            dy = dys[t0:t1]
            cT = Cc[:, t0:t1].transpose(0, 1)[:, :, :, None, :]
            if graph is None:
                hs = torch.empty((t1 - t0 + 1, B, Hm, hd, N),
                                 dtype=torch.float32, device=g.device)
                hs[0] = starts[ci]
                G = torch.empty_like(hs[1:])
                _recompute(hs, dec.detach(), inp.detach())
                _reverse(g, dec.detach(), dy, cT, G)
            else:
                hs, G = graph.run(starts[ci], dec.detach(), inp.detach(), dy,
                                  cT, g)
            ddec = torch.sum(G * hs[:-1], dim=3, keepdim=True)
            d_Cc[:, t0:t1] = torch.matmul(dy.transpose(-1, -2), hs[1:]
                                          )[:, :, :, 0].transpose(0, 1)
            got = torch.autograd.grad((dec, inp), ins + [A_], (ddec, G))
            for dst, src in zip((d_delta, d_u, d_Bc), got[:3]):
                dst[:, t0:t1] = src
            d_A += got[3]
        return d_delta, d_u, d_Bc, d_Cc, d_A, g, None


def _scan_heads(u, gate, w_bc, w_dt, b_dt, a_log, h0, time_chunk: int):
    """The scan of heads u, gate (B, S, Hm, hd) from the state h0 (None:
    zeros) -> (y (B, S, Hm, hd) in u's dtype, h after S steps)."""
    B, _, Hm, hd = u.shape
    p = {"w_bc": w_bc, "w_dt": w_dt, "b_dt": b_dt, "a_log": a_log}
    delta, Bc, Cc, A = _gates(u, p)
    h = torch.zeros((B, Hm, hd, a_log.shape[-1]), dtype=torch.float32,
                    device=u.device) if h0 is None else h0.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (delta, u, Bc, Cc, A, h)):
        ys, h = _SelectiveScan.apply(delta, u, Bc, Cc, A, h, time_chunk)
    else:
        h = h.clone()
        ys = _scan(delta, u, Bc, Cc, A, h, time_chunk)
    return ys[..., 0].transpose(0, 1).to(u.dtype) * gate, h


def _step_heads(u, gate, w_bc, w_dt, b_dt, a_log, h):
    """One step of heads u, gate (B, 1, Hm, hd) on the state h (B, Hm, hd,
    N) -> (y (B, 1, Hm, hd), h')."""
    p = {"w_bc": w_bc, "w_dt": w_dt, "b_dt": b_dt, "a_log": a_log}
    delta, Bc, Cc, A = _gates(u, p)
    u_t, d_t = u[:, 0].float(), delta[:, 0]
    decay = torch.exp(A[None] * d_t)
    h = h * decay[:, :, None, :] + (d_t[:, :, None] * u_t[..., None]) \
        * Bc[:, 0][:, :, None, :]
    y = torch.einsum("bhdn,bhn->bhd", h, Cc[:, 0])[:, None].to(u.dtype) \
        * gate
    return y, h


# the roles of _scan_heads's / _step_heads's tensors for
# meshed.sharded_heads: u and gate (B, S, Hm, hd), the per-head weights,
# the state (B, Hm, hd, N); their outputs y and h
_HEAD_ROLES = (("act", 2), ("act", 2), ("param", 0), ("param", 0),
               ("param", 0), ("param", 0))
_HEAD_OUT = (2, 1)


def _heads(fn, x, p, cfg: ModelConfig, h, *extra):
    """``fn`` on the SSM heads of x (B, S, D) -> (y (B, S, D), h): the
    input and gate projections split into heads, on a device mesh each
    rank's batch rows and heads (``meshed.sharded_heads``)."""
    Hm, hd = cfg.ssm_heads, cfg.hd
    u = split_heads(x @ p["in_proj"], Hm, hd)
    gate = split_heads(F.silu(x @ p["gate_proj"]), Hm, hd)
    args = (u, gate, p["w_bc"], p["w_dt"], p["b_dt"], p["a_log"], h)
    if is_dtensor(u):
        y, h = sharded_heads(
            lambda *a: fn(*a, *extra), args,
            _HEAD_ROLES + ((None if h is None else ("act", 1)),),
            _HEAD_OUT, Hm)
    else:
        y, h = fn(*args, *extra)
    return merge_heads(y) @ p["out_proj"], h


def ssm_scan(x: torch.Tensor, p: Dict, cfg: ModelConfig,
             h0: Optional[torch.Tensor] = None, time_chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), h after S steps (B, Hm, hd, N)).
    Differentiable (through :class:`_SelectiveScan`) when grad mode is on
    and the inputs require grad."""
    return _heads(_scan_heads, x, p, cfg, h0, time_chunk)


def ssm_step(x: torch.Tensor, p: Dict, cfg: ModelConfig, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  x: (B, 1, D); h: (B, Hm, hd, N) -> (y (B, 1,
    D), h')."""
    return _heads(_step_heads, x, p, cfg, h)
