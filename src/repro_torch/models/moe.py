"""Mixture-of-Experts layer with star-forest capacity dispatch (the port of
``repro/models/moe.py``).

The token→expert-slot assignment is a star forest (tokens = leaves, expert
slots = roots; paper §2): every step the router's top-k picks define the
leaf→root edge list of a :class:`repro_torch.core.DynPlan` — dispatch is a
leaf→root ``reduce`` with capacity-drop semantics (overflowing picks land on
the plan's drop row and vanish), combine is a root→leaf ``bcast`` of the
weighted expert outputs.  Both move their rows through the hand-written
gathers (``sf_pack``'s ``pack`` for hidden-state rows, ``pack_blocked`` for
the gate-weight column), on the runtime-index route: the routing is new
every step, so nothing is read back to the host and nothing is cached per
index.  The plan *skeleton* is cached per ``(G, T, k, E, C, D, dtype)``
(:func:`plan_cache`).  At decode sizes a
:class:`repro_torch.core.FieldBundle` fuses the hidden-state ``(D,)``
payload with the combine-weight column into ONE exchange; at prefill sizes
the reduce composes with the token→pick replication (``leaf_rep``), the
switch being the reference's ``_FUSE_MAX_LEAVES``.

The dense formulation (per-group scatter-add / gather) is kept as
``dispatch="dense"``; both paths share the sort-based slot ranking
(:func:`_capacity_slots`), so drops and weights are identical.  Select with
``cfg.moe_dispatch`` or the ``dispatch=`` override.

Grouping: tokens are dispatched in G independent groups (G = batch rows
for prefill shapes, 1 for decode), so a token's output depends on the other
tokens of its group through the capacity: a served stream is reproduced by
feeding the router exactly what the reference feeds it.

The expert products ``gecd,edf->gecf`` and the router product are plain
large products, left to ``torch.einsum`` as the reference leaves them to
XLA.  The reference's sharding constraints (experts over ``model``) are
kept on a device mesh by :func:`repro_torch.models.meshed.sharded_moe`,
which runs :func:`route` and :func:`experts` on each rank's shards.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import sflog
from ..core.device import resolve_device
from ..core.dynplan import DynPlan, PlanCache
from ..core.fields import FieldBundle
from ..core.unit import _np_dtype
from .config import ModelConfig, torch_dtype
from .meshed import is_dtensor, sharded_moe
from .sharding import constrain

__all__ = ["init_moe", "moe_layer", "plan_cache", "routing_leaf_root",
           "route", "experts", "aux_parts", "aux_loss"]

# module-level skeleton cache: one DynPlan per dispatch signature, shared by
# every layer and step with the same (G, T, k, E, C, D, dtype) problem
_PLANS = PlanCache("moe-dispatch")

# the reference's switch between the dispatch lowerings: up to this many
# leaves (picks) the fused two-field FieldBundle exchange, above it the
# leaf_rep-composed gather; kept as the reference's constant so that the
# sflog event streams match (PERF.md times both on the card)
_FUSE_MAX_LEAVES = 64

# largest float32 block drawn at once when parameters are made: an expert
# stack is drawn a slice at a time, not as one float32 temporary
_INIT_CHUNK = 1 << 26


def plan_cache() -> PlanCache:
    """The process-wide MoE dispatch plan cache."""
    return _PLANS


def _normal(shape, std: float, dtype: torch.dtype, gen, dev) -> torch.Tensor:
    """A ``(shape)`` tensor of ``dtype`` holding N(0, std²) draws from
    ``gen``, filled a leading slice at a time (each at most
    ``_INIT_CHUNK`` float32 values) so that a 13 GB expert stack needs no
    float32 copy of itself."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    k = 0
    while k < len(shape) - 1 and math.prod(shape[k:]) > _INIT_CHUNK:
        k += 1
    rows = out.reshape((math.prod(shape[:k]),) + tuple(shape[k:]))
    for r in rows:
        r.copy_(torch.randn(r.shape, generator=gen, device=dev).mul_(std))
    return out


def init_moe(cfg: ModelConfig, layers: int, *,
             generator: Optional[torch.Generator], device=None) -> Dict:
    """Stacked ``(layers, ...)`` MoE leaves under the reference's names,
    scaled as it scales them: ``router`` (L, D, E) float32, ``w_in`` /
    ``w_gate`` (L, E, D, F), ``w_out`` (L, E, F, D), and with
    ``moe_shared_ff`` the shared expert's ``shared_in`` / ``shared_gate``
    (L, D, Fs) and ``shared_out`` (L, Fs, D), in the config's dtype.
    Draws come from ``generator`` (torch's stream, not ``jax.random``'s;
    ``device="meta"`` takes no generator)."""
    dev = resolve_device(device)
    D, E, F_ = cfg.d_model, cfg.moe_experts, cfg.moe_dff
    dt = torch_dtype(cfg.dtype)
    s = 1.0 / np.sqrt(D)
    so = 1.0 / np.sqrt(F_) / np.sqrt(2 * cfg.n_layers)

    def normal(shape, std, dtype=dt):
        return _normal(shape, std, dtype, generator, dev)

    p = {"router": normal((layers, D, E), s, torch.float32),
         "w_in": normal((layers, E, D, F_), s),
         "w_gate": normal((layers, E, D, F_), s),
         "w_out": normal((layers, E, F_, D), so)}
    if cfg.moe_shared_ff:
        Fs = cfg.moe_shared_ff
        p["shared_in"] = normal((layers, D, Fs), s)
        p["shared_gate"] = normal((layers, D, Fs), s)
        p["shared_out"] = normal((layers, Fs, D), so)
    return p


def _capacity_slots(eidx: torch.Tensor, C: int, E: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot ranking of each group — the shared half of both dispatch paths.

    eidx: (..., T, k) expert ids, one group per leading index.  Returns
    (slot (..., T, k) in [0, E*C] with E*C the drop slot, keep (..., T,
    k)).  A per-group stable sort by expert id replaces the fetch-and-add
    slot allocation: rank within the expert run beyond the capacity C is
    dropped.  Each non-drop slot has exactly ONE writer, which is what
    makes dense and SF dispatch bit-identical."""
    *lead, T, k = eidx.shape
    flat_e = eidx.reshape(*lead, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(E, dtype=sorted_e.dtype, device=eidx.device)
    # rank within the expert run
    first = torch.searchsorted(sorted_e, experts.expand(*lead, E).contiguous())
    pos = torch.arange(T * k, device=eidx.device) - \
        torch.gather(first, -1, sorted_e)
    keep_s = pos < C
    slot_s = torch.where(keep_s, sorted_e * C + pos, E * C)
    # un-sort to (T, k) order through the inverse permutation
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(T * k, device=eidx.device).expand_as(order))
    return (torch.gather(slot_s, -1, inv).reshape(*lead, T, k),
            torch.gather(keep_s, -1, inv).reshape(*lead, T, k))


def _dispatch_dense(xg, slot, keep, C: int, E: int) -> torch.Tensor:
    """Dense dispatch: a per-group scatter-add into the (E*C+1, D) buffer
    (the trailing drop row, the only row with several writers, trimmed)."""
    G, T, k = slot.shape
    D = xg.shape[-1]
    picks = xg[:, :, None].expand(G, T, k, D).reshape(G, T * k, D)
    src = picks * keep.reshape(G, T * k, 1).to(xg.dtype)
    buf = xg.new_zeros((G, E * C + 1, D))
    buf.scatter_add_(1, slot.reshape(G, T * k, 1).expand(G, T * k, D), src)
    return buf[:, :-1]


def routing_leaf_root(slot, keep, C: int, E: int) -> torch.Tensor:
    """Flatten per-group slots to the DynPlan edge list: leaf i (= pick
    ``(g, t, j)`` in row-major order) points at root ``g*E*C + slot`` —
    dropped picks point one past the last root (``G*E*C``)."""
    G = slot.shape[0]
    if G == 1:
        # one group (decode shape): the local drop sentinel E*C already IS
        # the global one
        return slot.reshape(-1)
    base = (torch.arange(G, device=slot.device) * (E * C))[:, None, None]
    return torch.where(keep, slot + base, G * E * C).reshape(-1)


def _moe_plan(G: int, T: int, k: int, E: int, C: int, D: int,
              dtype) -> DynPlan:
    sig = (G, T, k, E, C, D, _np_dtype(dtype).str)
    return _PLANS.get_or_build(
        sig, lambda: DynPlan(G * E * C, G * T * k, label=("moe",) + sig))


def route(xg: torch.Tensor, router: torch.Tensor, k: int, C: int
          ) -> Tuple[torch.Tensor, ...]:
    """The router over groups xg (G, T, D): -> (probs (G, T, E) float32,
    the top-k weights wk (G, T, k) renormalized, in xg's dtype, expert ids
    eidx, and :func:`_capacity_slots`'s slot and keep); in a span
    ``moe.route``."""
    with sflog.span("moe.route"):
        logits = torch.einsum("gtd,de->gte", xg.float(), router)
        probs = torch.softmax(logits, dim=-1)
        wk, eidx = torch.topk(probs, k, dim=-1)             # (G, T, k)
        wk = (wk / wk.sum(dim=-1, keepdim=True)).to(xg.dtype)
        slot, keep = _capacity_slots(eidx, C, router.shape[-1])
        return probs, wk, eidx, slot, keep


def experts(xg: torch.Tensor, wk: torch.Tensor, slot: torch.Tensor,
            keep: torch.Tensor, w_in: torch.Tensor, w_gate: torch.Tensor,
            w_out: torch.Tensor, C: int, mode: str) -> torch.Tensor:
    """Dispatch, expert products and combine for the E experts of the
    stacks ``w_in`` / ``w_gate`` (E, D, F) and ``w_out`` (E, F, D): xg (G,
    T, D), slots in [0, E*C] (E*C drops) -> y (G, T, D), each token the
    weighted sum of its kept picks.  The three stages run in the spans
    ``moe.dispatch``, ``moe.experts`` and ``moe.combine``."""
    G, T, D = xg.shape
    k = slot.shape[-1]
    E = w_in.shape[0]
    with sflog.span("moe.dispatch"):
        if mode == "sf":
            plan = _moe_plan(G, T, k, E, C, D, xg.dtype)
            leaf_root = routing_leaf_root(slot, keep, C, E)
            w_leaf = wk.reshape(G * T * k, 1)
            # capacity slots never repeat -> one writer per root: the
            # reduce is the writer inversion plus a gather (unique=True)
            if G * T * k <= _FUSE_MAX_LEAVES:
                # decode-sized: the leaves carry the pick's hidden state
                # and its combine weight, fused by FieldBundle into ONE
                # exchange of (D + 1)-wide rows
                x_leaf = xg.reshape(G * T, 1, D).expand(G * T, k, D) \
                    .reshape(G * T * k, D)
                bound = plan.bind(leaf_root, unique=True)
                fb = FieldBundle.for_data(bound, [x_leaf, w_leaf])
                buf, sw = fb.reduce_multi(
                    [x_leaf, w_leaf],
                    [xg.new_zeros((G * E * C, D)),
                     xg.new_zeros((G * E * C, 1))], op="sum")
            else:
                # prefill-sized: compose with the token->pick replication
                # (leaf_rep, the PetscSFCompose shortcut) and gather the
                # hidden state straight from the compact token rows
                buf = plan.reduce(xg.reshape(G * T, D), leaf_root, op="sum",
                                  unique=True, leaf_rep=k)
                sw = plan.reduce(w_leaf, leaf_root, op="sum", unique=True)
        else:
            buf = _dispatch_dense(xg, slot, keep, C, E)
        h = buf.reshape(G, E, C, D)

    with sflog.span("moe.experts"):
        up = torch.einsum("gecd,edf->gecf", h, w_in)
        gate = torch.einsum("gecd,edf->gecf", h, w_gate)
        out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, w_out)
        out_flat = out.reshape(G, E * C, D)

    with sflog.span("moe.combine"):
        if mode == "sf":
            # weight at the root (each slot has one writer, so w*out here
            # is bit-identical to weighting at the leaf), then bcast back:
            # dropped picks read the zero drop row; the k picks summed as
            # slice adds, in the reference's order
            scaled = out_flat.reshape(G * E * C, D) * sw
            picks = plan.bcast(scaled, leaf_root).reshape(G, T, k, D)
            y = picks[:, :, 0]
            for j in range(1, k):
                y = y + picks[:, :, j]
            return y
        rows = torch.arange(G, device=xg.device)[:, None, None]
        gathered = out_flat[rows, slot.clamp(max=E * C - 1)]  # (G, T, k, D)
        gathered = gathered * keep[..., None].to(out_flat.dtype)
        return torch.einsum("gtkd,gtk->gtd", gathered,
                            wk.to(out_flat.dtype))


def aux_parts(probs: torch.Tensor, eidx: torch.Tensor, E: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The load-balance loss's statistics of these groups: the mean router
    probability per expert (E,) and the top-1 counts (E,) int64, by an
    integer index_add (exact), never a (G, T, E) one-hot."""
    me = probs.mean(dim=(0, 1))                                 # (E,)
    top1 = eidx[..., 0].reshape(-1)
    cnt = torch.zeros(E, dtype=torch.int64, device=probs.device).index_add_(
        0, top1, torch.ones_like(top1))
    return me, cnt


def aux_loss(me: torch.Tensor, cnt: torch.Tensor, tokens: int, E: int
             ) -> torch.Tensor:
    """Switch's load-balance loss E * sum(me * ce), ce the top-1 counts
    over ``tokens``."""
    ce = cnt.float() / tokens
    return E * torch.sum(me * ce)


def moe_layer(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
              groups: Optional[int] = None,
              dispatch: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Router in float32; top-k softmax over
    the selected logits; capacity C = ceil(T * k * cf / E) per group of T
    tokens.  ``p`` holds one layer's leaves (``transformer.layer``).

    ``dispatch="sf"`` (the default via ``cfg.moe_dispatch``): dispatch is
    the plan's fused leaf→root reduce of the hidden state and combine
    weight, combine the root→leaf bcast of the weighted expert outputs;
    on the card neither reads anything back to the host.
    ``dispatch="dense"`` keeps the per-group scatter/gather formulation
    (same slots, same drops, same weights).  On a DTensor ``x`` (a device
    mesh) the layer is ``models.meshed.sharded_moe``: experts over
    ``model``, each rank's exchange local."""
    mode = dispatch if dispatch is not None \
        else getattr(cfg, "moe_dispatch", "sf")
    if mode not in ("sf", "dense"):
        raise ValueError(f"unknown moe dispatch mode {mode!r}")
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_topk
    G = groups if groups is not None else (B if S > 1 else 1)
    T = (B * S) // G
    C = max(int(np.ceil(T * k * cfg.moe_capacity / E)), 1)
    if is_dtensor(x):
        y, aux = sharded_moe(x, p, G, T, C, k, mode)
    else:
        xg = x.reshape(G, T, D)
        probs, wk, eidx, slot, keep = route(xg, p["router"], k, C)
        y = experts(xg, wk, slot, keep, p["w_in"], p["w_gate"], p["w_out"],
                    C, mode).reshape(B, S, D)
        aux = aux_loss(*aux_parts(probs, eidx, E), G * T, E)

    if cfg.moe_shared_ff:
        # pinned as the dense MLP's products are (the identity off a mesh)
        shared = constrain((F.silu(constrain(x @ p["shared_gate"],
                                             model_dim=2))
                            * constrain(x @ p["shared_in"], model_dim=2))
                           @ p["shared_out"])
        y = y + shared
    return y, aux
