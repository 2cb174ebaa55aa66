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

Each cell's time loop collects its steps' outputs in a list and stacks
them.  Under grad it runs in chunks of ``TIME_CHUNK`` (128) steps, each
checkpointed as the reference remats its 128-step chunks: a chunk is one
autograd node (:class:`_CellChunk`) that keeps only its inputs, the state
at its start included, and whose backward recomputes its steps under
autograd and differentiates them, so only the chunk-boundary states stay
alive (the mLSTM matrix memory C is (B, H, hd, hd) float32, 1 MB a batch
row at xlstm-350m, and saved a few times a step).  On a CUDA device the
chunk's forward and its backward (the recompute with it) each replay a
CUDA graph captured once per cell and shapes (:class:`_ChunkGraphs`):
the cells are ~25 small operations a step, which launched one by one
(``torch.utils.checkpoint``) left the card idle 96% of a training step.
Without grad the loop runs whole, as it always did.

State per (batch, head): mLSTM ``mC`` (hd × hd), ``mn`` (hd), ``mm`` ();
sLSTM ``sc``, ``sn``, ``sh`` (hd each) and ``sm`` ().
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import is_fake
from ..launch.op_cost import held, trips
from .config import ModelConfig, torch_dtype
from .graphs import capture
from .layers import rmsnorm
from .meshed import is_dtensor, sharded_heads, split_heads
from .sharding import constrain, merge_heads

__all__ = ["init_xlstm_pair", "init_xlstm_state", "xlstm_pair_scan",
           "xlstm_pair_step", "TIME_CHUNK"]

TIME_CHUNK = 128        # the reference's xlstm_pair_scan time_chunk


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


def _slstm_step(z_raw, i_raw, f_raw, o_in, rz, c, n, m, h):
    """:func:`_slstm_cell` as a time-loop cell: -> (h, c, n, m, h)."""
    h, c, n, m = _slstm_cell(z_raw, i_raw, f_raw, o_in, rz, c, n, m, h)
    return h, c, n, m, h


def _steps(cell, seqs, state, consts=()):
    """``cell(*inputs at t, *consts, *state) -> (out, *state)`` over time
    axis 1 of ``seqs``: -> (the outputs stacked on axis 1, *state after
    them)."""
    T = seqs[0].shape[1]
    if T > 1 and is_fake(seqs[0]):
        # the dry run: one step counted T times (launch.op_cost.trips),
        # the other steps' outputs alive until they are stacked
        with trips(T):
            out, *state = cell(*(a[:, 0] for a in seqs), *consts, *state)
        with held((T - 1) * out.untyped_storage().nbytes()):
            return (torch.stack([out] * T, 1), *state)
    outs = []
    for t in range(T):
        out, *state = cell(*(a[:, t] for a in seqs), *consts, *state)
        outs.append(out)
    return (torch.stack(outs, 1), *state)


def _time_loop(cell, seqs, state, consts=()):
    """:func:`_steps` over the whole sequence; under grad, in chunks of
    ``TIME_CHUNK`` steps, each a :class:`_CellChunk` (only the
    chunk-boundary states are kept for the backward)."""
    if not torch.is_grad_enabled():
        return _steps(cell, seqs, state, consts)
    S = seqs[0].shape[1]
    full = S // TIME_CHUNK
    if full > 1 and is_fake(seqs[0]):
        # the dry run: one whole chunk counted as all of them, forward and
        # backward (launch.op_cost.trips); a last short chunk as it is
        parts = [(0, full)] + ([(full * TIME_CHUNK, 1)]
                               if S % TIME_CHUNK else [])
    else:
        parts = [(t0, 1) for t0 in range(0, S, TIME_CHUNK)]
    outs = []
    for t0, n in parts:
        part = tuple(a[:, t0:t0 + TIME_CHUNK] for a in seqs)
        with trips(n):
            out, *state = _CellChunk.apply(cell, len(part), len(consts), n,
                                           *part, *consts, *state)
        outs += [out] * n
    return (torch.cat(outs, 1), *state)


class _CellChunk(torch.autograd.Function):
    """One chunk of a cell's time loop as one checkpointed autograd node:
    ``_CellChunk.apply(cell, n_seqs, n_consts, n_trips, *seqs, *consts,
    *state) -> (outputs stacked on axis 1, *state after them)``.  The
    forward runs the steps without autograd and saves only its inputs; the
    backward recomputes the steps under autograd from them and
    differentiates.  ``n_trips`` (1 but in the dry run) is the number of
    alike chunks the node stands for, its backward counted that often
    (``launch.op_cost.trips``)."""

    @staticmethod
    def forward(ctx, cell, n_seqs, n_consts, n_trips, *tensors):
        ctx.cell, ctx.split, ctx.trips = cell, (n_seqs, n_consts), n_trips
        ctx.save_for_backward(*tensors)
        return tuple(_runner(cell, n_seqs, n_consts, tensors)
                     .forward(tensors))

    @staticmethod
    def backward(ctx, *gouts):
        tensors = ctx.saved_tensors
        with trips(ctx.trips):
            grads = _runner(ctx.cell, *ctx.split, tensors).backward(
                tensors, gouts)
        return (None, None, None, None) + tuple(
            g if need else None
            for g, need in zip(grads, ctx.needs_input_grad[4:]))


class _EagerChunk:
    """A chunk's forward and backward launched one op at a time (off the
    card, and inside a caller's own CUDA-graph capture)."""

    def __init__(self, cell, n_seqs: int, n_consts: int):
        self.cell, self.n_seqs, self.n_consts = cell, n_seqs, n_consts

    def _run(self, tensors):
        a, b = self.n_seqs, self.n_seqs + self.n_consts
        return _steps(self.cell, tensors[:a], tensors[b:], tensors[a:b])

    def forward(self, tensors):
        with torch.no_grad():
            return self._run(tensors)

    def backward(self, tensors, gouts):
        if is_fake(tensors[0]):
            return self._one_trip_backward(tensors, gouts)
        leaves = [t.detach().requires_grad_() for t in tensors]
        with torch.enable_grad():
            outs = self._run(leaves)
            return torch.autograd.grad(outs, leaves, gouts,
                                       allow_unused=True)

    def _one_trip_backward(self, tensors, gouts):
        """The dry run's backward of a chunk of T steps: one step's
        recompute and backward counted T times (``launch.op_cost.trips``),
        the sequences' gradients made once."""
        a = self.n_seqs
        T = tensors[0].shape[1]
        inputs = {t.untyped_storage()._cdata for t in tensors}
        saved = {}

        def pack(t):
            st = t.untyped_storage()
            if st._cdata not in inputs:
                saved[st._cdata] = st.nbytes()
            return t
        with trips(T):
            leaves = [t[:, 0].detach().requires_grad_() for t in tensors[:a]]
            leaves += [t.detach().requires_grad_() for t in tensors[a:]]
            with torch.enable_grad():
                with torch.autograd.graph.saved_tensors_hooks(pack, _same):
                    outs = self.cell(*leaves)
                # the recompute of the chunk's other steps: their saved
                # activations and outputs, and the outputs stacked, alive
                # as its backward starts; the sequences' gradients there,
                # each accumulated whole and a step's select backward
                # (whole too) added to it
                out = outs[0].untyped_storage().nbytes()
                grads = sum(2 * t.numel() * t.element_size()
                            for t in tensors[:a])
                with held((T - 1) * (sum(saved.values()) + out) + T * out
                          + grads):
                    got = torch.autograd.grad(outs, leaves,
                                              [gouts[0][:, 0], *gouts[1:]],
                                              allow_unused=True)
        return [torch.zeros_like(t) for t in tensors[:a]] + list(got[a:])


class _ChunkGraphs(_EagerChunk):
    """:class:`_EagerChunk`'s forward and backward each captured once as a
    CUDA graph on static buffers (inputs, output gradients), replayed per
    chunk; what a replay returns is copied out of the graph's buffers."""

    def __init__(self, cell, n_seqs: int, n_consts: int, like):
        super().__init__(cell, n_seqs, n_consts)
        self.ins = [torch.zeros_like(t) for t in like]
        self.outs = self.gouts = self.grads = None

        def fwd():
            self.outs = _EagerChunk.forward(self, self.ins)

        def bwd():
            self.grads = _EagerChunk.backward(self, self.ins, self.gouts)
        self.fwd = capture(fwd, like[0].device)
        self.gouts = [torch.zeros_like(o) for o in self.outs]
        self.bwd = capture(bwd, like[0].device)

    def forward(self, tensors):
        for buf, t in zip(self.ins, tensors):
            buf.copy_(t)
        self.fwd.replay()
        return [o.clone() for o in self.outs]

    def backward(self, tensors, gouts):
        for buf, t in zip(self.ins + self.gouts, list(tensors) + list(gouts)):
            buf.copy_(t)
        self.bwd.replay()
        return [None if g is None else g.clone() for g in self.grads]


# one pair of graphs per (cell, input shapes and dtypes, device): every
# chunk of that length in every pair replays them
_GRAPHS: Dict[tuple, _ChunkGraphs] = {}


def _use_graphs(t: torch.Tensor) -> bool:
    """Replay graphs for a tensor on a CUDA device, except inside a
    caller's own capture (a graph is not captured within another) and for
    the dry run's fake tensors (no memory to capture)."""
    return t.device.type == "cuda" and not is_fake(t) \
        and not torch.cuda.is_current_stream_capturing()


def _runner(cell, n_seqs: int, n_consts: int, tensors):
    """The chunk's graphs where :func:`_use_graphs`, else the eager
    chunk."""
    dev = tensors[0].device
    if not _use_graphs(tensors[0]):
        return _EagerChunk(cell, n_seqs, n_consts)
    key = (cell, n_seqs, n_consts, str(dev)) + tuple(
        (tuple(t.shape), t.dtype) for t in tensors)
    g = _GRAPHS.get(key)
    if g is None:
        # the capture's own autograd graph (the backward's) must not reach
        # the saved-tensor hooks of a caller's activation checkpoint: the
        # first chunk of a checkpointed pair captures, its recompute
        # replays, and the checkpoint requires both to save alike
        with torch.autograd.graph.saved_tensors_hooks(_same, _same):
            g = _GRAPHS[key] = _ChunkGraphs(cell, n_seqs, n_consts,
                                            tensors)
    return g


def _same(t):
    return t


def _cells(cell, seqs, state, consts, H: int):
    """:func:`_time_loop` of ``cell``; on a device mesh on each rank's
    batch rows and heads (``meshed.sharded_heads``): the sequences (B, S,
    H[, hd]) and the state (B, H[, ...]) split on their head dimension,
    the per-head constants (H, ...) too."""
    if not any(is_dtensor(t) for t in seqs):
        return _time_loop(cell, seqs, state, consts)
    ns, nc = len(seqs), len(consts)

    def run(*a):
        return _time_loop(cell, a[:ns], a[ns + nc:], a[ns:ns + nc])
    roles = (("act", 2),) * ns + (("param", 0),) * nc + (("act", 1),) * \
        len(state)
    return sharded_heads(run, tuple(seqs) + tuple(consts) + tuple(state),
                         roles, (2,) + (1,) * len(state), H)


def _mlstm_block(x, p, cfg: ModelConfig, st: Dict):
    """The mLSTM block (pre-norm residual) over x (B, S, D); returns (x +
    y, (C, n, m) after S steps).  Under a mesh the residual stream in and
    out is pinned to batch over the dp axes (``sharding.constrain``), as
    the dense blocks pin theirs."""
    x = constrain(x)
    D = x.shape[-1]
    H = cfg.n_heads
    hd = D // H
    f32 = torch.float32
    xa = rmsnorm(x, p["m_norm"], cfg.norm_eps)
    q = split_heads(xa @ p["m_wq"], H, hd).to(f32)
    k = (split_heads(xa @ p["m_wk"], H, hd) / math.sqrt(hd)).to(f32)
    v = split_heads(xa @ p["m_wv"], H, hd).to(f32)
    xf = xa.to(f32)
    i_raw = xf @ p["m_wi"]
    f_raw = xf @ p["m_wf"] + p["m_bf"]
    hs, C, n, m = _cells(_mlstm_cell, (q, k, v, i_raw, f_raw),
                         (st["mC"], st["mn"], st["mm"]), (), H)
    o_gate = torch.sigmoid(xa @ p["m_wo"])
    y = (merge_heads(hs).to(x.dtype) * o_gate) @ p["m_out"]
    return constrain(x + y), (C, n, m)


def _slstm_block(x, p, cfg: ModelConfig, st: Dict):
    """The sLSTM block (pre-norm residual) over x (B, S, D); returns (x +
    y, (c, n, m, h) after S steps)."""
    x = constrain(x)
    D = x.shape[-1]
    H = cfg.n_heads
    hd = D // H
    f32 = torch.float32
    xb = rmsnorm(x, p["s_norm"], cfg.norm_eps)
    z_raw = split_heads(xb @ p["s_wz"], H, hd).to(f32)
    xf = xb.to(f32)
    i_raw = xf @ p["s_wi"]
    f_raw = xf @ p["s_wf"] + p["s_bf"]
    o_in = split_heads(xb @ p["s_wo"], H, hd).to(f32)
    hs, c, n, m, h = _cells(_slstm_step, (z_raw, i_raw, f_raw, o_in),
                            (st["sc"], st["sn"], st["sm"], st["sh"]),
                            (p["s_rz"].to(f32),), H)
    y = merge_heads(hs).to(x.dtype) @ p["s_out"]
    return constrain(x + y), (c, n, m, h)


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
