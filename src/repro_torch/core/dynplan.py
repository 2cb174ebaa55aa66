"""Dynamic-index star-forest plans — SF topology built from runtime data
(the port of ``repro/core/dynplan.py``).

Every static plan (:mod:`repro_torch.core.plan`) comes from host-side
metadata fixed at setup, which is right for meshes and halos.  Expert
routing keeps the star-forest *shape* but not the edges: roots are the
``E × C`` capacity-padded expert slots, leaves are the per-token top-k
picks, and the router decides which leaf points at which root **every
step** — the edge list is a device tensor, not setup metadata.

:class:`DynPlan` is the plan family for that case.  Its *skeleton* (root
count, leaf count, payload unit) is static and cached (:class:`PlanCache`);
only the edge list ``leaf_root`` is an argument of each operation.
``leaf_root[i] == nroots`` marks a dropped edge (capacity overflow), whose
payload lands on a trailing drop row that is trimmed from the result.

Every row movement goes through the hand-written gathers
(``kernels.ops.pack_rows(..., dynamic=True)``): the index is new on every
call, so it is used as it is — no host read of its range and no cache
entry — and the gather kernels check every index against their source
rows on the device.  The one-writer reduce (``unique=True``, MoE dispatch)
is a writer inversion (an int32 ``scatter_`` whose only duplicate writes
land in the trimmed drop slot) and then a gather; the root→leaf ``bcast``
is a gather from the roots padded with a zero drop row.  The general
commutative reduce sorts ``leaf_root`` stably on the device and folds each
root's leaves in leaf order through ``kernels.ops.segment_reduce_rows``
(no float atomics), which makes it bitwise equal to the port's
``SFComm(star_forest_from_assignment(leaf_root, nroots))`` reduce; it reads
its segment bounds back to the host once per call (MoE never takes it).

The reference's ``custom_vjp`` on the gather (training through the plan)
comes with the training slice.  ``star_forest_from_assignment``
materializes a concrete routing as a real :class:`StarForest`, the bridge
the tests use to hold DynPlan against the ``SFComm`` oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import numpy as np
import torch

from .graph import StarForest
from .mpiops import get_op
from .unit import UnitSpec, resolve_unit
from . import sflog
from ..kernels import ops as kops
from ..kernels._index import segment_meta

__all__ = ["DynPlan", "BoundDynSF", "PlanCache",
           "star_forest_from_assignment"]


# --------------------------------------------------------------------------
# plan cache
# --------------------------------------------------------------------------
class PlanCache:
    """Signature-keyed cache for plan skeletons and prepared programs.

    Callers hash the *static* part of a problem (for MoE dispatch:
    ``(G, T, k, E, C, D, dtype)``; for the serving engine:
    ``("prefill", bucket)`` / ``("decode", batch)``) and get back the cached
    entry, so repeated steps never rebuild it.  Hit/miss counters live in
    the sflog registry (one pair per cache instance), so ``log_view`` and
    ``dump_json`` report them; ``.hits`` / ``.misses`` stay readable and
    assignable.
    """

    def __init__(self, name: str = "plans"):
        self.name = name
        self._entries: Dict[Any, Any] = {}
        self._c_hits = sflog.counter(f"plancache.{name}.hits", unique=True)
        self._c_misses = sflog.counter(f"plancache.{name}.misses",
                                       unique=True)

    @property
    def hits(self) -> int:
        return self._c_hits.value

    @hits.setter
    def hits(self, v: int) -> None:
        self._c_hits.value = int(v)

    @property
    def misses(self) -> int:
        return self._c_misses.value

    @misses.setter
    def misses(self, v: int) -> None:
        self._c_misses.value = int(v)

    def get_or_build(self, key, make: Callable[[], Any]):
        try:
            out = self._entries[key]
        except KeyError:
            self._c_misses.add(1)
            out = self._entries[key] = make()
            return out
        self._c_hits.add(1)
        return out

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"name": self.name, "entries": len(self._entries),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0}

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0


# the op's binary form: folds the unique-writer gather into rootdata, and
# the general reduce's segment rows into the roots that have leaves
_COMBINE = {"add": torch.add, "multiply": torch.mul,
            "max": torch.maximum, "min": torch.minimum}
_FOLDS = ("sum", "prod", "max", "min")


def _gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``data[idx]`` through the pack kernels' runtime-index route."""
    return kops.pack_rows(data, idx, dynamic=True)


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row mask shaped to broadcast over ``like``'s unit dims."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


# --------------------------------------------------------------------------
# the dynamic plan
# --------------------------------------------------------------------------
class DynPlan:
    """A star-forest communication plan whose edge list is runtime data.

    Static skeleton: ``nroots`` root slots, ``nleaves`` leaf slots, payload
    ``unit``.  Each operation takes ``leaf_root`` — an ``(nleaves,)``
    integer tensor on the payload's device (or a numpy array) giving the
    root of every leaf, with ``nroots`` meaning *dropped*.  An entry
    outside ``[0, nroots]`` raises on the CPU and fails the CUDA context
    on the card (a device-side check; nothing is read back to the host).

    ``tune_key`` is the plan's static signature, named as in the reference
    (whose autotuner keys on it; the port routes by a fixed rule).
    """

    def __init__(self, nroots: int, nleaves: int, *, unit=None,
                 label: Any = None):
        self.nroots = int(nroots)
        self.nleaves = int(nleaves)
        self.unit = resolve_unit(unit)
        self.label = label
        self.tune_key = ("dynplan", self.nroots, self.nleaves,
                         self.unit.shape,
                         None if self.unit.dtype is None
                         else self.unit.dtype.str, label)

    # ---------------------------------------------------------------- utils
    def _edges(self, leaf_root, device=None) -> torch.Tensor:
        """``leaf_root`` as an integer tensor (on ``device`` when given),
        after the shape check; on the CPU also the range check."""
        if not isinstance(leaf_root, torch.Tensor):
            leaf_root = torch.as_tensor(np.asarray(leaf_root),
                                        device=device)
        if device is not None and leaf_root.device != device:
            raise ValueError(f"leaf_root is on {leaf_root.device}, the "
                             f"payload on {device}; move it there "
                             f"explicitly")
        if leaf_root.dtype.is_floating_point or \
                leaf_root.dtype == torch.bool:
            raise TypeError(f"leaf_root must hold integers, got "
                            f"{leaf_root.dtype}")
        if leaf_root.dim() != 1 or leaf_root.shape[0] != self.nleaves:
            raise ValueError(
                f"leaf_root has shape {tuple(leaf_root.shape)}, plan has "
                f"{self.nleaves} leaves")
        if leaf_root.device.type == "cpu" and leaf_root.numel():
            lo, hi = (int(v) for v in torch.aminmax(leaf_root))
            if lo < 0 or hi > self.nroots:
                raise ValueError(
                    f"leaf_root entries lie in [{lo}, {hi}]; they must lie "
                    f"in [0, {self.nroots}] (== {self.nroots} marks a "
                    f"dropped leaf)")
        return leaf_root

    def valid(self, leaf_root) -> torch.Tensor:
        """Boolean mask of connected (non-dropped) leaves."""
        return self._edges(leaf_root) < self.nroots

    def _row_bytes(self, data: torch.Tensor) -> float:
        """Logical message volume: every leaf moves one row."""
        return float(self.nleaves) * math.prod(data.shape[1:]) \
            * data.element_size()

    # ----------------------------------------------------------------- ops
    def reduce(self, leafdata, leaf_root, rootdata=None, op="sum",
               unique: bool = False, leaf_rep: int = 1):
        if not sflog.enabled():
            return self._reduce_impl(leafdata, leaf_root, rootdata, op,
                                     unique, leaf_rep)
        t0 = sflog.op_begin()
        out = self._reduce_impl(leafdata, leaf_root, rootdata, op,
                                unique, leaf_rep)
        sflog.op_end("SFDynReduce", t0, out,
                     nbytes=self._row_bytes(leafdata),
                     tags={"op": get_op(op).name, "unique": unique,
                           "label": str(self.label)})
        return out

    def _reduce_impl(self, leafdata, leaf_root, rootdata=None, op="sum",
                     unique: bool = False, leaf_rep: int = 1):
        """Leaf→root reduction with capacity-drop semantics: dropped edges
        (``leaf_root == nroots``) never touch a real root.  Only the
        commutative arithmetic ops.

        ``unique=True`` asserts each root has at most ONE writer (true by
        construction for capacity-slot routing): the reduce is then the
        writer inversion plus one gather.  With duplicate writers under
        ``unique=True`` one arbitrary contributor wins; that is the
        caller's contract to keep.

        ``leaf_rep=r`` (unique path only) declares that runs of ``r``
        consecutive leaves carry the SAME payload row: ``leafdata`` has
        ``nleaves // r`` rows and leaf ``i`` carries row ``i // r`` (the
        ``PetscSFCompose`` shortcut, paper §2.3: MoE dispatch gathers
        straight from the compact token rows, skipping the k-way repeat).
        """
        opn = get_op(op)
        if opn.name not in _FOLDS:
            raise NotImplementedError(
                f"DynPlan.reduce supports commutative arithmetic ops "
                f"(sum/prod/max/min), not {opn.name!r}: a runtime edge "
                f"list carries no deterministic reduction order")
        if leaf_rep != 1 and not unique:
            raise NotImplementedError(
                "leaf_rep composition requires the unique-writer lowering")
        if not isinstance(leafdata, torch.Tensor):
            raise TypeError("leafdata must be a torch.Tensor")
        dev = leafdata.device
        if rootdata is not None and rootdata.device != dev:
            raise ValueError(f"rootdata is on {rootdata.device}, leafdata "
                             f"on {dev}; move it there explicitly")
        leaf_root = self._edges(leaf_root, dev)
        dtype = leafdata.dtype if rootdata is None else rootdata.dtype
        ident = opn.identity_of(dtype)
        if unique:
            if self.nleaves % leaf_rep or \
                    leafdata.shape[0] * leaf_rep != self.nleaves:
                raise ValueError(
                    f"leaf_rep={leaf_rep} needs "
                    f"{self.nleaves} % rep == 0 and "
                    f"leafdata rows * rep == nleaves, got "
                    f"{leafdata.shape[0]} rows")
            # writer[root] = its leaf, or nleaves (the identity pad row);
            # duplicate writes land only in the drop slot, which is trimmed
            # before it is read.  scatter_ checks the range on the device.
            writer = torch.full((self.nroots + 1,), self.nleaves,
                                dtype=torch.int32, device=dev)
            writer.scatter_(0, leaf_root.long(),
                            torch.arange(self.nleaves, dtype=torch.int32,
                                         device=dev))
            pad = torch.cat([leafdata.to(dtype),
                             torch.full((1,) + tuple(leafdata.shape[1:]),
                                        ident, dtype=dtype, device=dev)])
            src = writer[:-1]
            if leaf_rep != 1:
                # the pad row nleaves // rep stays the pad row
                src = torch.div(src, leaf_rep, rounding_mode="floor")
            got = _gather(pad, src)
            if rootdata is None:
                return got
            return _COMBINE[opn.at_update](rootdata, got)
        self.unit.check(leafdata, "leafdata")
        if rootdata is None:
            rootdata = torch.full((self.nroots,) + tuple(leafdata.shape[1:]),
                                  ident, dtype=dtype, device=dev)
        return self._sorted_reduce(leafdata, leaf_root, rootdata, opn)

    def _sorted_reduce(self, leafdata, leaf_root, rootdata, opn):
        """The general reduce: leaves sorted stably by root (drops last),
        each root's leaves folded in leaf order by the segment-reduce
        kernels, the fold combined into the roots that have leaves.  The
        same arithmetic as ``SortedUnpack`` on the SF of this routing, the
        one-leaf-per-root shortcut included."""
        if self.nleaves == 0:
            return rootdata.clone()
        dev = leafdata.device
        order = torch.argsort(leaf_root, stable=True)
        sroot = leaf_root[order]
        # out-of-range roots sort before root 0 or after the drop slot
        torch._assert_async((sroot[0] >= 0) & (sroot[-1] <= self.nroots),
                            "DynPlan.reduce: leaf_root outside [0, nroots]")
        roots = torch.arange(self.nroots, dtype=sroot.dtype, device=dev)
        first = torch.searchsorted(sroot, roots)
        length = torch.searchsorted(sroot, roots, side="right") - first
        first, length = first.to(torch.int32), length.to(torch.int32)
        # the call's one host read: the segments' bounds
        _, _, _, lmax = segment_meta(first, length, dev)
        sv = _gather(leafdata, order)
        if lmax <= 1:
            # one leaf a root: the leaf itself, no fold from the identity
            seg = _gather(sv, torch.where(length > 0, first, 0))
        else:
            seg = kops.segment_reduce_rows(sv, first, length, op=opn.name,
                                           dynamic=True)
        upd = _COMBINE[opn.at_update](rootdata, seg.to(rootdata.dtype))
        return torch.where(_rows(length > 0, upd), upd, rootdata)

    def bcast(self, rootdata, leaf_root, leafdata=None):
        if not sflog.enabled():
            return self._bcast_impl(rootdata, leaf_root, leafdata)
        t0 = sflog.op_begin()
        out = self._bcast_impl(rootdata, leaf_root, leafdata)
        sflog.op_end("SFDynBcast", t0, out,
                     nbytes=self._row_bytes(rootdata),
                     tags={"label": str(self.label)})
        return out

    def _bcast_impl(self, rootdata, leaf_root, leafdata=None):
        """Root→leaf broadcast (replace).  Dropped edges read the zero drop
        row when ``leafdata`` is None (fresh buffer), otherwise keep their
        prior ``leafdata`` value — the static-SF convention for leaves
        outside the graph."""
        if not isinstance(rootdata, torch.Tensor):
            raise TypeError("rootdata must be a torch.Tensor")
        self.unit.check(rootdata, "rootdata")
        leaf_root = self._edges(leaf_root, rootdata.device)
        rootpad = torch.cat([rootdata, rootdata.new_zeros(
            (1,) + tuple(rootdata.shape[1:]))])
        out = _gather(rootpad, leaf_root)
        if leafdata is not None:
            if leafdata.device != rootdata.device:
                raise ValueError(f"leafdata is on {leafdata.device}, "
                                 f"rootdata on {rootdata.device}")
            ok = _rows(leaf_root < self.nroots, out)
            out = torch.where(ok, out, leafdata.to(out.dtype))
        return out

    def bind(self, leaf_root, unique: bool = False) -> "BoundDynSF":
        """Fix an edge list, yielding the backend-shaped view that
        :class:`repro_torch.core.fields.FieldBundle` fuses multi-field
        exchanges over (``reduce_multi`` with k payloads = ONE exchange).
        ``unique`` selects the one-writer-per-root reduce for every reduce
        issued through the view."""
        return BoundDynSF(self, self._edges(leaf_root), unique=unique)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DynPlan(nroots={self.nroots}, nleaves={self.nleaves}, "
                f"label={self.label!r})")


@dataclasses.dataclass(frozen=True)
class _Sizes:
    """The size surface FieldBundle reads off a StarForest."""

    nroots_total: int
    nleafspace_total: int
    nedges_total: int = 0


class BoundDynSF:
    """A :class:`DynPlan` with its edge list fixed — duck-types the
    ``SFComm`` surface that :class:`repro_torch.core.fields.FieldBundle`
    drives (``.sf`` sizes, ``.unit``, ``.backend.bcast/reduce``), so the
    fused multi-field exchange works on runtime-routed plans without a
    second implementation."""

    name = "dyn"

    def __init__(self, plan: DynPlan, leaf_root, unique: bool = False):
        self.plan = plan
        self.leaf_root = leaf_root
        self.unique = unique
        self.sf = _Sizes(plan.nroots, plan.nleaves, plan.nleaves)
        self.backend = self
        self.unit = UnitSpec()     # fused payloads widen the row unit

    def bcast(self, rootdata, leafdata, op="replace"):
        if get_op(op).name != "replace":
            raise NotImplementedError("bound dyn bcast is replace-only")
        return self.plan.bcast(rootdata, self.leaf_root, leafdata)

    def reduce(self, leafdata, rootdata, op="sum"):
        return self.plan.reduce(leafdata, self.leaf_root, rootdata, op,
                                unique=self.unique)


# --------------------------------------------------------------------------
# bridge to the static SF world
# --------------------------------------------------------------------------
def star_forest_from_assignment(leaf_root, nroots: int) -> StarForest:
    """Materialize a concrete (host-side) routing as a 1-rank StarForest.

    ``leaf_root`` is an ``(nleaves,)`` assignment (numpy, or a tensor read
    back here) with ``nroots`` marking dropped leaves; dropped leaves become
    *isolated* leaves (holes in the leaf space, paper §3.1): roots = expert
    slots, leaves = token picks.
    """
    if isinstance(leaf_root, torch.Tensor):
        leaf_root = leaf_root.cpu().numpy()
    leaf_root = np.asarray(leaf_root, dtype=np.int64)
    if leaf_root.ndim != 1:
        raise ValueError("leaf_root must be 1-D")
    if leaf_root.size and (leaf_root.min() < 0
                           or leaf_root.max() > int(nroots)):
        raise ValueError(f"leaf_root entries must lie in [0, {nroots}] "
                         f"(== {nroots} marks a dropped leaf)")
    connected = np.flatnonzero(leaf_root < int(nroots))
    remote = np.stack([np.zeros(connected.size, np.int64),
                       leaf_root[connected]], axis=1)
    sf = StarForest(1)
    sf.set_graph(0, int(nroots), connected, remote,
                 nleafspace=int(leaf_root.size))
    return sf.setup()
