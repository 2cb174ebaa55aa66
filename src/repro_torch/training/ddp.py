"""DDP-style bucketed gradient exchange on the star-forest layer (the port
of ``repro/training/ddp.py``).

Per-layer gradient all-reduces are exactly the communication pattern the
paper argues one SF abstraction should carry: every parameter tensor is a
field moving over the SAME allreduce-pattern star forest, so fusing them is
the VecScatter argument applied to training.

* :func:`allreduce_sf` — the allreduce-pattern SF: one canonical root row,
  ``grains`` leaf rows distributed rank-major over ``world`` ranks.  A
  leaf→root ``reduce(sum)`` is the reduce half of an allreduce; the
  root→leaf ``bcast`` is the broadcast half.
* :class:`BucketPlan` — walks the grad tree **in reverse-backward order**
  (the last parameters finish differentiating first) and groups tensors
  into byte-budgeted buckets; a tensor larger than the budget gets a
  bucket of its own.
* :class:`DDPGradReducer` — lowers each bucket to ONE
  :meth:`repro_torch.core.fields.FieldBundle.reduce_multi_begin` over the
  allreduce SF, with split-phase :meth:`bucket_reduce_begin` /
  :meth:`bucket_reduce_end`.

**Grains and elastic bit-stability.**  The leaf space is ``grains`` fixed
data-parallel shards, not devices: ``world`` only re-partitions which rank
owns which grains, and the global edge order (and so the deterministic
reduction order) stays grain-major for every world.  An elastic
shrink/grow resume therefore reproduces the uninterrupted loss trajectory
bit for bit.  ``world`` is the SF's rank count in this one process, as in
the reference's in-process backends.

On the card the reduce takes the ``"cuda"`` backend (the default): each
bucket's leaf rows are packed by the strided pack (the allreduce SF's
sorted leaves are one contiguous run) and folded by the segment-reduce
kernels (one segment of ``grains`` rows, as wide as the bucket), then
combined into the root row.  On CPU tensors the same backend runs the
kernels' plain versions, bitwise the ``"global"`` backend.

Re-derived plans flow through a :class:`repro_torch.core.dynplan.
PlanCache`: shrinking to a new world misses (plans rebuilt), growing back
to a previously-seen world hits; ``metrics()`` surfaces the counters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import sflog
from ..core.backend import SFComm
from ..core.device import check_payload, resolve_device
from ..core.dynplan import PlanCache
from ..core.fields import FieldBundle, FieldSpec
from ..core.graph import StarForest
from .pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "allreduce_sf", "Bucket", "BucketPlan", "DDPGradReducer",
    "ddp_plan_cache", "reset_ddp_plan_cache",
]


# --------------------------------------------------------------------------
# the allreduce-pattern star forest
# --------------------------------------------------------------------------
def allreduce_sf(world: int, grains: Optional[int] = None) -> StarForest:
    """The allreduce-pattern SF: ``grains`` leaves (grain-major global
    order), all pointing at one root row owned by rank 0, with leaves
    distributed contiguously over ``world`` ranks.  Because ranks own
    contiguous grain ranges in rank order, the global edge list is
    ``0..grains`` for every ``world``."""
    world = int(world)
    grains = world if grains is None else int(grains)
    if world < 1 or grains < 1:
        raise ValueError(f"need world >= 1 and grains >= 1, got "
                         f"world={world} grains={grains}")
    if grains % world:
        raise ValueError(f"grains ({grains}) must be divisible by world "
                         f"({world}) so every rank owns whole grains")
    per = grains // world
    sf = StarForest(world)
    for r in range(world):
        remote = np.stack([np.zeros(per, np.int64),
                           np.zeros(per, np.int64)], axis=1)
        sf.set_graph(r, 1 if r == 0 else 0, np.arange(per), remote,
                     nleafspace=per)
    return sf.setup()


# --------------------------------------------------------------------------
# bucket planning
# --------------------------------------------------------------------------
def _leaf_meta(x) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, torch dtype) of a tensor, numpy array or numpy scalar."""
    if isinstance(x, torch.Tensor):
        return tuple(int(d) for d in x.shape), x.dtype
    a = np.asarray(x)
    return tuple(int(d) for d in a.shape), \
        torch.from_numpy(np.empty(0, a.dtype)).dtype


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fused gradient exchange: a run of grad-tree leaves (indices in
    flatten order), grouped under a byte budget.  ``nbytes`` counts one
    copy of the payload (what one exchange moves per grain row)."""

    index: int
    leaves: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]            # torch dtype names
    nbytes: int

    @property
    def specs(self) -> List[FieldSpec]:
        return [FieldSpec((_numel(s),), getattr(torch, d))
                for s, d in zip(self.shapes, self.dtypes)]

    def signature(self) -> tuple:
        return (self.shapes, self.dtypes)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Byte-budgeted bucketing of a gradient tree, in reverse-backward
    order: bucket 0 holds the LAST leaves of the tree (the first gradients
    the backward pass finishes), so it is the first exchange to fire."""

    buckets: Tuple[Bucket, ...]
    byte_budget: Optional[int]
    nleaves: int

    @staticmethod
    def for_tree(tree, byte_budget: Optional[int]) -> "BucketPlan":
        """Plan buckets for ``tree`` (tensors, meta tensors or numpy
        arrays).  A ``None`` / non-positive budget fuses everything into
        one bucket; a tensor alone larger than the budget gets its own
        bucket; the final bucket is ragged."""
        metas = [_leaf_meta(x) for x in tree_leaves(tree)]
        if not metas:
            raise ValueError("cannot bucket an empty gradient tree")
        budget = None if byte_budget is None or byte_budget <= 0 \
            else int(byte_budget)
        buckets: List[Bucket] = []
        cur: List[int] = []
        cur_bytes = 0

        def close():
            nonlocal cur, cur_bytes
            if not cur:
                return
            buckets.append(Bucket(
                index=len(buckets), leaves=tuple(cur),
                shapes=tuple(metas[i][0] for i in cur),
                dtypes=tuple(_dtype_name(metas[i][1]) for i in cur),
                nbytes=cur_bytes))
            cur, cur_bytes = [], 0

        for i in reversed(range(len(metas))):
            shape, dt = metas[i]
            nb = _numel(shape) * dt.itemsize
            if budget is not None and cur and cur_bytes + nb > budget:
                close()
            cur.append(i)
            cur_bytes += nb
            if budget is not None and cur_bytes >= budget:
                close()
        close()
        return BucketPlan(tuple(buckets), budget, len(metas))

    def signature(self) -> tuple:
        return tuple(b.signature() for b in self.buckets)

    @property
    def nbuckets(self) -> int:
        return len(self.buckets)

    @property
    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)


# --------------------------------------------------------------------------
# plan cache (module-level, shared across elastic restarts)
# --------------------------------------------------------------------------
_PLAN_CACHE = PlanCache("ddp-buckets")


def ddp_plan_cache() -> PlanCache:
    """The process-wide cache of allreduce SFs and bucket bundles, keyed by
    ``(world, grains, backend, device, bucket signature)``.  A new world
    misses and re-derives; a previously-seen world hits."""
    return _PLAN_CACHE


def reset_ddp_plan_cache() -> None:
    _PLAN_CACHE.clear()


# --------------------------------------------------------------------------
# the reducer
# --------------------------------------------------------------------------
def _on(g, device: torch.device, what: str) -> torch.Tensor:
    """A tensor on ``device`` (raises if it lies elsewhere), or a numpy
    array copied there."""
    if isinstance(g, torch.Tensor):
        return check_payload(g, device, what)
    return torch.as_tensor(np.asarray(g), device=device)


def _average(r: torch.Tensor, grains: int) -> torch.Tensor:
    if r.dtype.is_floating_point:
        return r / grains
    return torch.div(r, grains, rounding_mode="floor")


class DDPGradReducer:
    """Bucketed gradient allreduce over the star-forest layer.

    Construction is where SF plans and fused bundles are derived — or
    re-derived after an elastic world change — through
    :func:`ddp_plan_cache`.  Input gradients are *per-grain*: every leaf
    carries a leading ``grains`` axis.  ``bucket_reduce_begin`` fires one
    fused ``reduce_multi_begin`` per bucket in reverse-backward order;
    ``bucket_reduce_end`` completes them and returns the tree of summed
    (or grain-averaged) gradients in the original leaf shapes.  ``device``
    is where the gradients live (the card unless ``"cpu"`` is asked for).
    """

    def __init__(self, plan: BucketPlan, world: int,
                 grains: Optional[int] = None, *,
                 backend: str = "cuda",
                 cache: Optional[PlanCache] = None, device=None):
        self.plan = plan
        self.world = int(world)
        self.grains = self.world if grains is None else int(grains)
        self.backend = backend
        self.device = resolve_device(device)
        cache = cache if cache is not None else _PLAN_CACHE
        self._cache = cache
        dev = str(self.device)
        self.comm: SFComm = cache.get_or_build(
            ("sf", self.world, self.grains, backend, dev),
            lambda: SFComm(allreduce_sf(self.world, self.grains),
                           backend=backend, device=self.device))
        self._bundles: List[FieldBundle] = [
            cache.get_or_build(
                ("bundle", self.world, self.grains, backend, dev,
                 b.signature()),
                lambda b=b: FieldBundle(self.comm, b.specs))
            for b in plan.buckets]

    # ------------------------------------------------------------ helpers
    def _flat(self, grain_grads) -> List[torch.Tensor]:
        flat = tree_leaves(grain_grads)
        if len(flat) != self.plan.nleaves:
            raise ValueError(f"grads tree has {len(flat)} leaves, plan has "
                             f"{self.plan.nleaves}")
        return flat

    def _bucket_fields(self, flat: Sequence[torch.Tensor], b: Bucket
                       ) -> List[torch.Tensor]:
        """Per-grain grads -> (grains, numel) leaf fields for bucket b."""
        out = []
        for i, shape in zip(b.leaves, b.shapes):
            g = _on(flat[i], self.device, f"grain grads leaf {i}")
            if tuple(g.shape[:1]) != (self.grains,) or \
                    tuple(g.shape[1:]) != tuple(shape):
                raise ValueError(
                    f"grain grads leaf {i} has shape {tuple(g.shape)}; "
                    f"expected ({self.grains}, *{tuple(shape)})")
            out.append(g.reshape(self.grains, -1))
        return out

    # ---------------------------------------------------------- split phase
    def bucket_reduce_begin(self, grain_grads) -> List[Tuple[Bucket, Any]]:
        """Fire one fused ``reduce_multi_begin`` per bucket, in
        reverse-backward order (bucket 0 first)."""
        flat = self._flat(grain_grads)
        t0 = sflog.op_begin() if sflog.enabled() else None
        pendings = []
        for b, bundle in zip(self.plan.buckets, self._bundles):
            fields = self._bucket_fields(flat, b)
            pendings.append((b, bundle.reduce_multi_begin(fields, "sum")))
        if t0 is not None:
            sflog.op_end(
                "DDPBucketReduceBegin", t0, None,
                nbytes=float(self.grains) * self.plan.total_bytes,
                tags={"nbuckets": self.plan.nbuckets, "world": self.world})
        return pendings

    def bucket_reduce_end(self, pendings, grain_grads, *,
                          average: bool = True):
        """Complete every in-flight bucket; returns the reduced grads tree
        with the grain axis folded away (summed over grains, divided by
        ``grains`` when ``average``)."""
        t0 = sflog.op_begin() if sflog.enabled() else None
        _, treedef = tree_flatten(grain_grads)
        flat_out: List[Optional[torch.Tensor]] = [None] * self.plan.nleaves
        for b, pending in pendings:
            roots = [torch.zeros((1, _numel(s)), dtype=getattr(torch, d),
                                 device=self.device)
                     for s, d in zip(b.shapes, b.dtypes)]
            reduced = pending.end(roots)
            for i, shape, r in zip(b.leaves, b.shapes, reduced):
                r = r.reshape(shape)
                flat_out[i] = _average(r, self.grains) if average else r
        out = tree_unflatten(treedef, flat_out)
        if t0 is not None:
            sflog.op_end(
                "DDPBucketReduceEnd", t0, flat_out,
                tags={"nbuckets": self.plan.nbuckets, "world": self.world})
        return out

    def allreduce(self, grain_grads, *, average: bool = True):
        """One-shot bucketed allreduce: begin + end."""
        return self.bucket_reduce_end(self.bucket_reduce_begin(grain_grads),
                                      grain_grads, average=average)

    def reduce_per_tensor(self, grain_grads, *, average: bool = True):
        """The unfused reference: one SF reduce per tensor (what bucketing
        replaces).  Bit-matches :meth:`allreduce`: fusion only widens the
        payload row; each column's reduction order is unchanged."""
        def one(g):
            g = _on(g, self.device, "grain grads")
            cols = g.reshape(self.grains, -1)
            r = self.comm.reduce(cols, cols.new_zeros((1, cols.shape[1])),
                                 "sum").reshape(g.shape[1:])
            return _average(r, self.grains) if average else r
        return tree_map(one, grain_grads)

    def bcast_grads(self, grads):
        """Broadcast canonical grads back to every grain (the allreduce
        broadcast half)."""
        def one(g):
            g = _on(g, self.device, "grads")
            row = g.reshape(1, -1)
            out = self.comm.bcast(row,
                                  row.new_zeros((self.grains, row.shape[1])))
            return out.reshape((self.grains,) + tuple(g.shape))
        return tree_map(one, grads)

    # ------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, Any]:
        """Host-side stats for step metrics: bucket layout + the plan-cache
        hit/miss counters that witness elastic re-planning."""
        stats = self._cache.stats()
        return {
            "ddp_world": self.world,
            "ddp_grains": self.grains,
            "ddp_nbuckets": self.plan.nbuckets,
            "ddp_bucket_bytes": [b.nbytes for b in self.plan.buckets],
            "ddp_plan_cache_hits": stats["hits"],
            "ddp_plan_cache_misses": stats["misses"],
            "ddp_plan_cache_entries": stats["entries"],
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DDPGradReducer(world={self.world}, grains={self.grains}, "
                f"nbuckets={self.plan.nbuckets}, backend={self.backend!r})")
