"""AdamW with optional 8-bit quantized moments (the port of
``repro/training/optimizer.py``).

The ``int8`` moment mode stores m and v as int8 with one float32 scale per
trailing-axis row (block-wise absmax quantization, as in 8-bit Adam):
2 bytes a parameter of optimizer state instead of 8.  ``bfloat16`` moments
take 4.

Layer-stacked tensors (``ndim >= 3``, leading axis over 1) are updated one
leading slice at a time, as the reference's ``lax.map`` does: the float32
working set is one layer slice, not a whole stack; a matrix of more than
2^26 elements (qwen3-4b's 389 M-element embedding) goes in blocks of rows,
for the same reason and with the same bits.  ``inplace=True`` writes
the new parameters and moments into the given tensors (the train step's
path, the counterpart of the reference's donated buffers); by default new
tensors are returned and the inputs are left as they were.  Either way the
bits are the same.  Every per-step scalar (step, lr, clip, bias
corrections) stays on the device: an update reads nothing back to the host.

On a device mesh the parameters are DTensors and every moment has its
parameter's layout (``launch.cells._opt_specs``: ZeRO-3; an int8 moment's
scale ``s`` is sharded like its rows and whole along the last axis).  The
shared scalars are plain, replicated tensors (the grad norm summed over
the mesh).  With float32 or bfloat16 moments the update is elementwise, so
each rank updates its local shards as above, with the bits of the
whole-tensor update; int8 moments take their per-row scales over whole
rows, so those leaves are updated as DTensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..core import sflog
from ..models.meshed import is_dtensor, whole, wrap_local
from .pytree import flatten_up_to, tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

__all__ = ["OptConfig", "init_opt_state", "global_norm", "adamw_update",
           "adamw_update_bucketed", "lr_at"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "float32"   # float32 | bfloat16 | int8


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in float32 on
    ``step``'s device (a Python int is taken on the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# ----------------------------------------------------------------- int8 pack
def _q8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Blockwise absmax int8 quantization along the trailing axis."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def _dq8(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return p["q"].float() * p["s"]


def _moment_dtype(kind: str) -> torch.dtype:
    if kind not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"moments_dtype must be float32, bfloat16 or int8, "
                         f"got {kind!r}")
    return torch.bfloat16 if kind == "bfloat16" else torch.float32


def _moment_zero(x: torch.Tensor, kind: str):
    if kind == "int8":
        return {"q": torch.zeros_like(x, dtype=torch.int8),
                "s": _scale_like(x)}
    return torch.zeros_like(x, dtype=_moment_dtype(kind))


def _scale_like(x: torch.Tensor) -> torch.Tensor:
    """An int8 moment's initial scales (1e-12 per trailing row) for ``x``;
    on a DTensor sharded like its rows and replicated along the last
    axis."""
    if not is_dtensor(x):
        return torch.full(tuple(x.shape[:-1]) + (1,), 1e-12,
                          dtype=torch.float32, device=x.device)
    from torch.distributed.tensor import Replicate, Shard
    loc = x.to_local()
    s = torch.full(tuple(loc.shape[:-1]) + (1,), 1e-12,
                   dtype=torch.float32, device=loc.device)
    pl = [Replicate() if p == Shard(x.ndim - 1) else p
          for p in x.placements]
    return wrap_local(s, x.device_mesh, pl, tuple(x.shape[:-1]) + (1,))


def _moment_read(m, kind: str) -> torch.Tensor:
    if kind == "int8":
        return _dq8(m)
    return m.float()


def _moment_write(x: torch.Tensor, kind: str):
    if kind == "int8":
        return _q8(x)
    return x.to(_moment_dtype(kind))


def init_opt_state(params, cfg: OptConfig) -> Dict:
    """Zero moments beside every parameter (on its device) and step 0."""
    kind = cfg.moments_dtype
    _moment_dtype(kind)
    leaves = tree_leaves(params)
    dev = _local(leaves[0]).device if leaves else torch.device("cpu")
    return {"m": tree_map(lambda x: _moment_zero(x, kind), params),
            "v": tree_map(lambda x: _moment_zero(x, kind), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """The norm over every leaf, a plain tensor (a DTensor leaf's sum of
    squares summed over the mesh)."""
    leaves = [whole(torch.sum(torch.square(x.float())))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _local(t):
    """A DTensor's local shard (a moment dict's, entry by entry), else
    ``t``."""
    if isinstance(t, dict):
        return {k: _local(v) for k, v in t.items()}
    return t.to_local() if is_dtensor(t) else t


def _update_scalars(grads, opt_state: Dict, cfg: OptConfig):
    """The per-step scalars every leaf update shares: (step, lr, gnorm,
    clip, bc1, bc2).  ``clip`` comes from the GLOBAL grad norm, so bucketed
    and whole-tree updates see identical scaling."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
    else:
        clip = torch.ones((), dtype=torch.float32, device=gnorm.device)
    sf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** sf
    bc2 = 1 - cfg.b2 ** sf
    return step, lr, gnorm, clip, bc1, bc2


# a matrix larger than this many elements is updated in blocks of rows
_BLOCK_ELEMS = 1 << 26


def _parts(p: torch.Tensor):
    """The pieces a leaf is updated in, or None for the whole leaf:
    layer-stacked tensors one leading slice at a time (the reference's
    ``lax.map``: the float32 working set is one layer), and a large matrix
    (an embedding, a head) in blocks of whole rows.  Every piece holds
    whole trailing rows and at least two dimensions where the leaf has
    them, so the update (the int8 moments' per-row scales and the decay's
    ``ndim >= 2`` test included) gives the bits of the whole-leaf one."""
    if p.dim() >= 3 and p.shape[0] > 1:
        return range(p.shape[0])
    if p.dim() == 2 and p.numel() > _BLOCK_ELEMS:
        rows = max(1, _BLOCK_ELEMS // max(p.shape[1], 1))
        return [slice(r, r + rows) for r in range(0, p.shape[0], rows)]
    return None


def _index(m, i):
    return {k: t[i] for k, t in m.items()} if isinstance(m, dict) else m[i]


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


def _empty_like(m):
    if isinstance(m, dict):
        return {k: torch.empty_like(t) for k, t in m.items()}
    return torch.empty_like(m)


def _make_leaf_updater(cfg: OptConfig, lr, clip, bc1, bc2):
    """One-leaf AdamW update shared by :func:`adamw_update` and
    :func:`adamw_update_bucketed`: ``upd(p, g, m, v, inplace)`` ->
    ``(p', m', v')``."""
    kind = cfg.moments_dtype

    def upd_flat(p, g, m, v):
        g = g.float() * clip
        mf = _moment_read(m, kind)
        vf = _moment_read(v, kind)
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, _moment_write(mf, kind), _moment_write(vf, kind)

    def upd(p, g, m, v, inplace: bool):
        if is_dtensor(p):
            return upd_dtensor(p, g, m, v, inplace)
        out = (p, m, v) if inplace else \
            (torch.empty_like(p), _empty_like(m), _empty_like(v))
        parts = _parts(p)
        if parts is None:
            for dst, src in zip(out, upd_flat(p, g, m, v)):
                _copy_into(dst, src)
            return out
        for i in parts:
            new = upd_flat(p[i], g[i], _index(m, i), _index(v, i))
            for dst, src in zip(out, new):
                _copy_into(_index(dst, i), src)
        return out

    def upd_dtensor(p, g, m, v, inplace: bool):
        """A DTensor leaf: its local shards through ``upd`` (elementwise
        moments), or the DTensor itself under implicit replication (int8
        moments, whose scales span whole rows)."""
        if g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        if kind != "int8":
            out = (p, m, v) if inplace else \
                (torch.empty_like(p), _empty_like(m), _empty_like(v))
            for dst, src in zip(out, (p, m, v)):
                if dst is not src:
                    dst.to_local().copy_(src.to_local())
            upd(*(t.to_local() for t in (out[0], g, out[1], out[2])),
                True)
            return out
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            new = upd_flat(p, g, m, v)
            if not inplace:
                return new
            for dst, src in zip((p, m, v), new):
                _copy_into(dst, src)
            return p, m, v

    return upd


def _flat(params, grads, opt_state):
    flat_p, tdef = tree_flatten(params)
    return (flat_p, tdef, flatten_up_to(tdef, grads),
            flatten_up_to(tdef, opt_state["m"]),
            flatten_up_to(tdef, opt_state["v"]))


@torch.no_grad()
def adamw_update(params, grads, opt_state: Dict, cfg: OptConfig, *,
                 inplace: bool = False) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step, in a span ``optim.update``.  Returns (params',
    opt_state', metrics)."""
    with sflog.span("optim.update"):
        step, lr, gnorm, clip, bc1, bc2 = _update_scalars(grads, opt_state,
                                                          cfg)
        upd = _make_leaf_updater(cfg, lr, clip, bc1, bc2)
        flat_p, tdef, flat_g, flat_m, flat_v = _flat(params, grads,
                                                     opt_state)
        out = [upd(p, g, m, v, inplace) for p, g, m, v in
               zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_unflatten(tdef, [o[0] for o in out])
    new_m = tree_unflatten(tdef, [o[1] for o in out])
    new_v = tree_unflatten(tdef, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics


@torch.no_grad()
def adamw_update_bucketed(params, grads, opt_state: Dict, cfg: OptConfig,
                          bucket_plan, *, inplace: bool = False
                          ) -> Tuple[Dict, Dict, Dict]:
    """AdamW consuming grads bucket-by-bucket: parameters are updated in
    ``bucket_plan``'s reverse-backward bucket order (the sharded-update
    half of DDP-style training; see :mod:`repro_torch.training.ddp`).

    Bit-identical to :func:`adamw_update`: per-leaf updates are
    independent given the shared global-norm clip, which is computed over
    the full grads tree before any bucket is consumed.  A plan that does
    not cover every leaf exactly once raises ``ValueError``.  The update
    runs in a span ``optim.update``.
    """
    with sflog.span("optim.update"):
        step, lr, gnorm, clip, bc1, bc2 = _update_scalars(grads, opt_state,
                                                          cfg)
        upd = _make_leaf_updater(cfg, lr, clip, bc1, bc2)
        flat_p, tdef, flat_g, flat_m, flat_v = _flat(params, grads,
                                                     opt_state)
        covered = sorted(i for b in bucket_plan.buckets for i in b.leaves)
        if covered != list(range(len(flat_p))):
            raise ValueError(f"bucket plan covers {len(covered)} of "
                             f"{len(flat_p)} param leaves")
        new_p, new_m, new_v = list(flat_p), list(flat_m), list(flat_v)
        for b in bucket_plan.buckets:
            for i in b.leaves:
                new_p[i], new_m[i], new_v[i] = upd(
                    flat_p[i], flat_g[i], flat_m[i], flat_v[i], inplace)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (tree_unflatten(tdef, new_p),
            {"m": tree_unflatten(tdef, new_m),
             "v": tree_unflatten(tdef, new_v), "step": step}, metrics)
