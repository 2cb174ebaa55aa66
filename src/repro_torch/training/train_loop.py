"""Training step factory: loss, microbatched gradient accumulation and the
DDP step over the allreduce star forest (the port of
``repro/training/train_loop.py``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves
(:func:`value_and_grad`, the counterpart of ``jax.value_and_grad``): the
parameter tensors themselves never hold a graph or a ``.grad``.  The
reference's ``lax.scan`` over microbatches and ``vmap`` over grains are
Python loops here: ``torch.func.vmap`` has no rule for the hand kernels'
calls, and a loop keeps each grain's gradient the same computation at any
``world``, which is what elastic bit-stability needs.  The reference's
sharding constraints (``param_shardings`` / ``batch_shardings``) are the
identity on one device and are left out.

``donate=True`` (the reference launcher's ``donate_argnums=(0, 1)``):
the step updates the given parameters and optimizer state in place and
returns them, so a step holds no second copy of either; the caller must
not reuse the inputs.  By default the inputs are left as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import sflog
from ..core.device import resolve_device
from ..models import transformer as T
from ..models.meshed import is_dtensor, sharded_pick, whole, wrap_local
from ..launch.mesh import mesh_sizes
from ..models.sharding import NamedSharding, batch_spec, constrain
from ..models.config import ModelConfig, torch_dtype
from .optimizer import (OptConfig, adamw_update, adamw_update_bucketed,
                        init_opt_state)
from .pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainConfig", "cross_entropy", "make_loss_fn",
           "value_and_grad", "make_train_step", "make_ddp_train_step",
           "TrainState", "batch_to"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    grad_dtype: str = "float32"      # float32 | bfloat16
    z_loss: float = 1e-4
    aux_loss: float = 1e-2


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_coef: float = 0.0) -> torch.Tensor:
    """Token-mean CE with float32 accumulation; labels < 0 are masked.

    The reference's numerics: the max shift (held out of the gradient),
    float32 log-sum-exp, the z-loss on the full lse.  The gold logit comes
    from ``torch.gather``, one logit read a token (the reference takes it
    by a masked reduction over the vocab so that GSPMD can shard that
    axis).  On DTensor logits (a device mesh) each rank gathers from its
    own vocabulary shard and the picks are summed over the vocabulary's
    mesh dimensions (``models.meshed.sharded_pick``: the vocab-parallel
    cross-entropy, which gathers no logits); with the vocabulary whole it
    is the same gather.  The per-token statistics are pinned to the batch
    layout (``constrain``), so the vocab reductions end in an all-reduce
    and the logit gradients keep the logits' layout."""
    m = constrain(torch.amax(logits, dim=-1, keepdim=True).detach())
    shifted = (logits - m).float()
    sumexp = torch.sum(torch.exp(shifted), dim=-1)
    lse_rel = constrain(torch.log(constrain(sumexp)))
    labels = labels.long()
    gold_at = labels.clamp(min=0)[..., None]
    if is_dtensor(logits):
        gold_rel = constrain(sharded_pick(shifted, gold_at))
    else:
        gold_rel = torch.gather(shifted, -1, gold_at)[..., 0]
    mask = (labels >= 0).float()
    ce = (lse_rel - gold_rel) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(ce) / denom
    if z_coef:
        full_lse = lse_rel + m[..., 0].float()
        loss = loss + z_coef * torch.sum(torch.square(full_lse) * mask) \
            / denom
    return loss


def batch_to(batch: Dict, device: torch.device,
             float_dtype: Optional[torch.dtype] = None
             ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors already on ``device``) as
    tensors on ``device``: integer arrays as int64, float arrays as they
    are, or in ``float_dtype`` where given (the stubbed frontends'
    float32 embeddings for a bf16 model)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            if v.device != device:
                raise ValueError(f"batch[{k!r}] is on {v.device}, the "
                                 f"params on {device}")
            out[k] = v
            continue
        a = np.asarray(v)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        out[k] = torch.as_tensor(a, device=device)
        if float_dtype is not None and out[k].is_floating_point():
            out[k] = out[k].to(float_dtype)
    return out


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, {"ce", "aux"})`` through
    ``transformer.forward_train``: ``tokens`` (or ``embeds``), ``labels``,
    and ``enc_embeds`` for an encoder-decoder."""
    def loss_fn(params, batch):
        kwargs = {}
        if "embeds" in batch:
            kwargs["embeds"] = batch["embeds"]
        else:
            kwargs["tokens"] = batch["tokens"]
        if "enc_embeds" in batch:
            kwargs["enc_embeds"] = batch["enc_embeds"]
        logits, aux = T.forward_train(params, cfg, **kwargs)
        loss = cross_entropy(logits, batch["labels"], tcfg.z_loss)
        return loss + tcfg.aux_loss * aux, {"ce": loss, "aux": aux}
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Dict]:
    """``((loss, aux), grads)`` of ``loss_fn(params, batch) -> (loss,
    aux dict)`` with respect to every floating parameter leaf, as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them.  The
    parameters are differentiated through detached aliases, so they gain
    no graph and no ``.grad``; a leaf the loss does not reach gets
    zeros."""
    flat, td = tree_flatten(params)
    leaves = [p.detach().requires_grad_(p.is_floating_point())
              for p in flat]
    with torch.enable_grad():
        with sflog.span("train.forward"):
            loss, aux = loss_fn(tree_unflatten(td, leaves), batch)
        wrt = [p for p in leaves if p.requires_grad]
        with sflog.span("train.backward"):
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in leaves:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()}), \
        tree_unflatten(td, grads)


def _params_device(params) -> torch.device:
    leaves = tree_leaves(params)
    if not leaves:
        raise ValueError("empty params tree")
    return leaves[0].device


def make_train_step(cfg: ModelConfig, ocfg: OptConfig,
                    tcfg: TrainConfig = TrainConfig(), *,
                    donate: bool = False, param_shardings=None,
                    batch_shardings=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params', opt',
    metrics)``.

    ``batch`` holds arrays with a leading global-batch axis (numpy, or
    tensors on the params' device); with ``tcfg.microbatches = G > 1`` the
    step runs G microbatches accumulating gradients in ``grad_dtype``,
    divides by G and takes one optimizer update (gradient accumulation).

    On a device mesh the parameters and optimizer state are DTensors
    placed by ``param_shardings`` (a ``models.sharding.NamedSharding``
    tree, the ZeRO layout), and every gradient and the microbatch
    accumulator are pinned to that layout, as the reference's
    ``constrain_g`` pins them.  ``batch_shardings`` (a ``NamedSharding``
    per batch key; default: ``batch_spec``, batch over the dp axes) places
    each microbatch, cut from the global batch as the plain step cuts it.
    The step runs with its mesh ambient (``launch.mesh.use_mesh``) and
    under ``implicit_replication()``: the plain tensors the model makes
    (rope tables, positions, masks, the optimizer's scalars) count as
    replicated.  Metrics are plain tensors."""
    loss_fn = make_loss_fn(cfg, tcfg)
    gdt = torch_dtype(tcfg.grad_dtype)
    mesh = None
    if param_shardings is not None:
        mesh = tree_leaves(param_shardings)[0].mesh

    def constrain_g(tree):
        if param_shardings is None:
            return tree
        return tree_map(_pin, tree, param_shardings)

    def place(batch):
        """The batch's leaves as DTensors (each whole leaf distributed by
        its sharding; a DTensor leaf as it is)."""
        if mesh is None:
            return batch
        out = {}
        for k, v in batch.items():
            sh = (batch_shardings or {}).get(k) or NamedSharding(
                mesh, batch_spec(mesh_sizes(mesh)))
            out[k] = v if is_dtensor(v) else sh.distribute(v)
        return out

    def step(params, opt_state, batch):
        with sflog.span("train.step"):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        dev = _params_device(params)
        batch = place(batch_to(batch, dev))
        G = tcfg.microbatches
        if G == 1:
            (loss, met), grads = value_and_grad(loss_fn, params, batch)
            grads = constrain_g(grads)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % G:
                raise ValueError(f"batch axis {B} not divisible by {G} "
                                 f"microbatches")
            acc = constrain_g(tree_map(
                lambda p: torch.zeros_like(p, dtype=gdt), params))
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for g in range(G):
                mb = {k: _microbatch(v, g, G) for k, v in batch.items()}
                (l, _), gr = value_and_grad(loss_fn, params, mb)
                acc = constrain_g(tree_map(lambda a, b: a + b.to(gdt), acc,
                                           gr))
                lsum = lsum + whole(l)
            grads = constrain_g(tree_map(lambda a: (a / G).to(gdt), acc))
            loss = lsum / G
            met = {"ce": loss, "aux": torch.zeros_like(loss)}
        params, opt_state, omet = adamw_update(params, grads, opt_state,
                                               ocfg, inplace=donate)
        return params, opt_state, {
            "loss": whole(loss), **{k: whole(v) for k, v in met.items()},
            **omet}

    def train_step(params, opt_state, batch):
        if mesh is None:
            return step(params, opt_state, batch)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        from ..launch.mesh import use_mesh
        with use_mesh(mesh), implicit_replication():
            return step(params, opt_state, batch)

    return train_step


def _microbatch(v: torch.Tensor, g: int, G: int) -> torch.Tensor:
    """Microbatch ``g`` of ``G`` of a batch leaf: rows ``g B/G .. (g+1)
    B/G`` of a plain tensor.  A DTensor leaf (batch over the dp axes) is
    cut on each rank's own rows, so microbatch ``g`` is the ``g``-th part
    of every rank's rows and no row moves between ranks; on one rank that
    is the plain cut, and with every microbatch's labels unmasked (the
    token mean's denominator the same in each) the accumulated gradient is
    the plain step's up to rounding."""
    if not is_dtensor(v):
        B = v.shape[0]
        return v[g * (B // G):(g + 1) * (B // G)]
    loc = v.to_local()
    n = loc.shape[0]
    if n % G:
        raise ValueError(f"{n} local batch rows not divisible by {G} "
                         f"microbatches")
    return wrap_local(loc[g * (n // G):(g + 1) * (n // G)], v.device_mesh,
                      v.placements,
                      (v.shape[0] // G,) + tuple(v.shape[1:]))


def _pin(t, sharding):
    """``t`` in ``sharding``'s layout (a DTensor redistributed if it is
    not)."""
    want = sharding.placements
    if is_dtensor(t) and tuple(t.placements) != want:
        return t.redistribute(sharding.mesh, want)
    return t


def make_ddp_train_step(cfg: Optional[ModelConfig], ocfg: OptConfig,
                        tcfg: TrainConfig = TrainConfig(), *,
                        world: int, byte_budget: Optional[int],
                        grains: Optional[int] = None,
                        backend: str = "cuda",
                        loss_fn: Optional[Callable] = None,
                        params_template=None, device=None,
                        donate: bool = False):
    """DDP-style train step: per-grain gradients, bucketed SF allreduce,
    bucket-ordered update.

    Returns ``(train_step, reducer_fn)``; ``reducer_fn()`` yields the live
    :class:`repro_torch.training.ddp.DDPGradReducer` (``None`` until the
    first step when no ``params_template`` is given).  ``train_step(params,
    opt_state, batch)`` splits the global batch into ``grains`` equal
    shards, computes each grain's gradient in turn (a loop, where the
    reference vmaps), stacks them ``(grains, *shape)``, fires one fused
    ``reduce_multi_begin`` per byte-budgeted bucket in reverse-backward
    order, completes them, and applies
    :func:`repro_torch.training.optimizer.adamw_update_bucketed` in the
    same bucket order.

    ``grains`` (default ``world``) is the FIXED data-parallel
    decomposition that makes elastic shrink/grow bit-stable: the step's
    math depends only on ``grains``, while ``world`` re-partitions the SF
    through :func:`repro_torch.training.ddp.ddp_plan_cache`.
    ``loss_fn(params, batch) -> (loss, aux_dict)`` overrides the model
    loss (``cfg`` may then be ``None``).  ``params_template`` (tensors,
    meta tensors or numpy arrays shaped like the params) pins the bucket
    plan at factory time; ``device`` is where the gradients live (default:
    the template's, else the params' at the first step).
    """
    from .ddp import BucketPlan, DDPGradReducer

    if loss_fn is None:
        if cfg is None:
            raise ValueError("need a ModelConfig or an explicit loss_fn")
        loss_fn = make_loss_fn(cfg, tcfg)
    G = world if grains is None else int(grains)

    state = {"reducer": None}

    def build(tree, dev):
        return DDPGradReducer(BucketPlan.for_tree(tree, byte_budget), world,
                              grains=G, backend=backend, device=dev)

    if params_template is not None:
        leaf = tree_leaves(params_template)[0]
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor)
            and leaf.device.type != "meta" else None)
        state["reducer"] = build(params_template, dev)

    def train_step(params, opt_state, batch):
        dev = _params_device(params)
        if state["reducer"] is None:
            state["reducer"] = build(params, device if device is not None
                                     else dev)
        red = state["reducer"]
        batch = batch_to(batch, dev)
        B = next(iter(batch.values())).shape[0]
        if B % G:
            raise ValueError(f"batch axis {B} not divisible by {G} grains")
        # grain g's gradient into row g of a (grains, *shape) stack
        stack = tree_map(lambda p: torch.empty((G,) + tuple(p.shape),
                                               dtype=p.dtype, device=dev),
                         params)
        losses, mets = [], []
        for g in range(G):
            gb = {k: v[g * (B // G):(g + 1) * (B // G)]
                  for k, v in batch.items()}
            (l, m), gr = value_and_grad(loss_fn, params, gb)
            tree_map(lambda s, x: s[g].copy_(x), stack, gr)
            losses.append(l)
            mets.append(m)
            del gr
        # reverse-backward bucket order: the optimizer consumes the buckets
        # in the order they were fired
        pendings = red.bucket_reduce_begin(stack)
        grads = red.bucket_reduce_end(pendings, stack, average=True)
        del stack, pendings
        params, opt_state, omet = adamw_update_bucketed(
            params, grads, opt_state, ocfg, red.plan, inplace=donate)
        metrics = {"loss": torch.mean(torch.stack(losses)),
                   **{k: torch.mean(torch.stack([m[k] for m in mets]))
                      for k in mets[0]}, **omet}
        return params, opt_state, metrics

    def reducer():
        return state["reducer"]

    train_step.reducer = reducer
    return train_step, reducer


@dataclasses.dataclass
class TrainState:
    params: Dict
    opt_state: Dict
    step: int = 0

    @staticmethod
    def create(cfg: ModelConfig, ocfg: OptConfig, *,
               generator: Optional[torch.Generator] = None,
               device=None) -> "TrainState":
        """Random parameters (``transformer.init_params``; seed 0 without
        a generator) and zero optimizer state, on the card unless
        ``device="cpu"``."""
        params = T.init_params(cfg, generator=generator,
                               device=resolve_device(device))
        return TrainState(params, init_opt_state(params, ocfg), 0)
