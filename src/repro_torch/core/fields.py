"""Fused multi-field exchange — the VecScatter analogue on star forests (the
port of ``repro/core/fields.py``).

Paper §2 lists the workloads stacked on SF: DMDA ghost exchange, VecScatter
and MatMult halos.  All of them move *several* fields over the *same*
communication pattern — coordinates plus labels in mesh migration, k RHS
columns in multi-vector SpMV, velocity/pressure/temperature in a staggered
solver.  Issuing one SF op per field wastes launch and latency budget (the
observation of "Toward performance-portable PETSc", arXiv:2011.00715: widen
the unit, fuse the exchanges).

:class:`FieldBundle` is the fusion plan: given k same-length fields, it
groups them at setup time into *byte-compatible groups* and at run time
moves each group through **one** pack → exchange → unpack on any registered
backend, by widening the row unit to the group's concatenated width.

Grouping rules (per reduction op), exactly the reference's:

* ``replace`` moves bits, not numbers — fields whose dtypes share a
  1/2/4-byte itemsize fuse into one group; mixed dtypes ride bitcast
  (``Tensor.view(dtype)``) to the common unsigned integer carrier of that
  width (exact round trip, NaN payloads included).  8-byte dtypes group by
  exact dtype, as in the reference, whose x64-disabled stack has no u64
  carrier.  bool fuses by exact dtype only.
* arithmetic ops (``sum``/``prod``/``max``/``min``/…) must compute in the
  payload dtype, so fields fuse only with an *exactly* matching dtype.

The per-call fused transform is a trailing-axis concat of ``(n, u_i)``
views; the SF sees a single ``(n, U)`` payload, so every backend's pack
kernel and unpack runs exactly once per group.  ``SFComm.bcast_multi`` /
``reduce_multi`` construct and cache bundles automatically.  The
``fields.*`` counters are always live; with event logging on, each fused
exchange records one ``SF{Bcast,Reduce}Multi`` event (bytes: plan edges x
fused row bytes) and the split forms one ``...MultiBegin`` / ``...MultiEnd``
pair, as in the reference.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from .mpiops import get_op, torch_dtype
from .unit import UnitSpec
from . import sflog

__all__ = ["FieldSpec", "FieldBundle", "PendingMulti"]

# fusion counters: multi calls issued, fused exchanges executed, fields
# they carried
_C_CALLS = sflog.counter("fields.multi_calls")
_C_EXCH = sflog.counter("fields.fused_exchanges")
_C_FIELDS = sflog.counter("fields.fields_moved")
# the registry events (and span names) of a split fused exchange's halves
_MULTI_EVENTS = {"bcast": ("SFBcastMultiBegin", "SFBcastMultiEnd"),
                 "reduce": ("SFReduceMultiBegin", "SFReduceMultiEnd")}

# bitcast carrier per itemsize for mixed-dtype REPLACE groups
_CARRIER = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32}


@dataclasses.dataclass(frozen=True)
class FieldSpec(UnitSpec):
    """One field's unit: a fully *pinned* :class:`UnitSpec` (both the
    trailing row shape and the dtype are required)."""

    def __post_init__(self):
        if self.shape is None or self.dtype is None:
            raise ValueError("FieldSpec pins both shape and dtype")
        super().__post_init__()

    @property
    def unit(self) -> UnitSpec:
        return self

    @property
    def torch_dtype(self) -> torch.dtype:
        """The field's torch dtype (``UnitSpec`` keeps bfloat16, which
        numpy lacks, as a 2-byte void)."""
        if self.dtype == np.dtype("V2"):
            return torch.bfloat16
        return torch_dtype(self.dtype)

    @staticmethod
    def of(data: torch.Tensor) -> "FieldSpec":
        return FieldSpec(tuple(int(d) for d in data.shape[1:]), data.dtype)


@dataclasses.dataclass(frozen=True)
class _Group:
    """One fused exchange: member field ids + the carrier layout."""

    members: Tuple[int, ...]       # field indices, in user order
    widths: Tuple[int, ...]        # flat unit width per member
    offsets: Tuple[int, ...]       # exclusive column offsets in the carrier
    carrier: torch.dtype           # dtype the fused payload travels as
    bitcast: bool                  # members need a view change to carrier

    @property
    def width(self) -> int:
        return self.offsets[-1]


def _plan_groups(specs: Sequence[FieldSpec], by_bytes: bool) -> List[_Group]:
    """Partition fields into fusable groups, preserving user order within
    each group.  ``by_bytes`` groups on itemsize (REPLACE semantics),
    otherwise on exact dtype."""
    buckets: dict = {}
    for i, sp in enumerate(specs):
        # bool fuses by exact dtype only, as in the reference (whose
        # bitcast rejects bool operands)
        if by_bytes and sp.dtype.kind != "b" \
                and sp.dtype.itemsize in _CARRIER:
            key = ("b", sp.dtype.itemsize)
        else:
            key = ("d", sp.dtype.str)
        buckets.setdefault(key, []).append(i)
    groups = []
    for key, members in buckets.items():
        widths = tuple(specs[i].size for i in members)
        offsets = (0,) + tuple(np.cumsum(widths).tolist())
        dtypes = {specs[i].dtype.str for i in members}
        if len(dtypes) == 1:
            carrier, bitcast = specs[members[0]].torch_dtype, False
        else:
            carrier, bitcast = _CARRIER[key[1]], True
        groups.append(_Group(tuple(members), widths, offsets, carrier,
                             bitcast))
    return groups


def _to_carrier(x: torch.Tensor, n: int, width: int, carrier: torch.dtype,
                bitcast: bool) -> torch.Tensor:
    """(n, *unit) -> (n, width) columns in the group's carrier dtype."""
    x = x.reshape(n, width)
    if bitcast and x.dtype != carrier:
        x = x.view(carrier)
    return x


def _from_carrier(cols: torch.Tensor, spec: FieldSpec, n: int,
                  bitcast: bool) -> torch.Tensor:
    if bitcast and cols.dtype != spec.torch_dtype:
        cols = cols.view(spec.torch_dtype)
    return cols.reshape((n,) + spec.shape).contiguous()


@dataclasses.dataclass
class PendingMulti:
    """In-flight fused multi-field exchange: one backend token per fusable
    group, returned by :meth:`FieldBundle.bcast_multi_begin` /
    :meth:`FieldBundle.reduce_multi_begin`.  Work issued between begin and
    end is independent of the packed payloads (the paper's
    ``SFBcastBegin/End`` split applied to the fused multi-field path)."""

    kind: str                        # "bcast" | "reduce"
    bundle: "FieldBundle"
    op: Any                          # resolved Op
    items: List[Tuple[_Group, Any]]  # group -> backend pending

    def end(self, dstfields):
        """Complete every group against the destination fields."""
        return self.bundle._multi_end(self, dstfields)


class FieldBundle:
    """Fusion plan for k same-pattern, same-length field exchanges.

    Built once per field-list signature (``SFComm`` caches bundles); each
    ``bcast_multi``/``reduce_multi`` then issues exactly ``ngroups(op)``
    backend exchanges — one per fusable group — instead of k.  The split
    ``*_begin``/``*_end`` forms return a :class:`PendingMulti`.
    """

    def __init__(self, comm, specs: Sequence[FieldSpec]):
        if not specs:
            raise ValueError("FieldBundle needs at least one field")
        self.comm = comm
        self.specs = [sp if isinstance(sp, FieldSpec) else FieldSpec(*sp)
                      for sp in specs]
        if comm.unit.constrained:
            for sp in self.specs:
                comm.unit.check(torch.empty((0,) + sp.shape,
                                            dtype=sp.torch_dtype),
                                "bundle field")
        # setup-time fusion plans for both op classes
        self._byte_groups = _plan_groups(self.specs, by_bytes=True)
        self._dtype_groups = _plan_groups(self.specs, by_bytes=False)
        # the executing backend: shared with the comm unless its unit is
        # pinned (the fused payload unit is the group width, not the field
        # unit), in which case a sibling backend reuses the same plan arrays
        # with the unit constraint lifted.
        self._exec = comm.backend
        if comm.unit.constrained:
            self._exec = _sibling_backend(comm.backend)

    @staticmethod
    def for_data(comm, fields) -> "FieldBundle":
        return FieldBundle(comm, [FieldSpec.of(f) for f in fields])

    def ngroups(self, op="replace") -> int:
        """Backend exchanges one multi-op issues (1 = fully fused)."""
        return len(self._groups(get_op(op).name))

    def _groups(self, opname: str) -> List[_Group]:
        return self._byte_groups if opname == "replace" \
            else self._dtype_groups

    def _check(self, fields, what: str, nrows: int) -> None:
        if len(fields) != len(self.specs):
            raise ValueError(f"bundle has {len(self.specs)} fields, got "
                             f"{len(fields)} {what} arrays")
        for f, sp in zip(fields, self.specs):
            sp.unit.check(f, what)
        lengths = {int(f.shape[0]) for f in fields}
        if lengths - {nrows}:
            raise ValueError(f"{what} fields have lengths {sorted(lengths)}; "
                             f"bundles fuse same-length exchanges over the "
                             f"SF's {nrows} rows only")

    def _fused(self, g: _Group, fields, n: int) -> torch.Tensor:
        """The group's payload: the lone field as it is, or the members'
        carrier columns side by side."""
        if len(g.members) == 1:
            return fields[g.members[0]]
        return torch.cat([_to_carrier(fields[i], n, w, g.carrier, g.bitcast)
                          for i, w in zip(g.members, g.widths)], dim=1)

    def _split(self, g: _Group, fused: torch.Tensor, n: int, out) -> None:
        if len(g.members) == 1:
            out[g.members[0]] = fused
            return
        for k, i in enumerate(g.members):
            cols = fused[:, g.offsets[k]: g.offsets[k + 1]]
            out[i] = _from_carrier(cols, self.specs[i], n, g.bitcast)

    def _count(self, groups) -> None:
        _C_CALLS.add(1)
        _C_EXCH.add(len(groups))
        _C_FIELDS.add(len(self.specs))

    def _group_bytes(self, g: _Group) -> float:
        """Comm volume of one fused exchange: plan edges x fused row bytes
        (the carrier width for multi-member groups)."""
        ne = float(self.comm.sf.nedges_total)
        if len(g.members) == 1:
            sp = self.specs[g.members[0]]
            return ne * sp.size * sp.dtype.itemsize
        return ne * g.width * g.carrier.itemsize

    def _run(self, srcs, dsts, op, exchange, nsrc: int, ndst: int,
             event: str):
        opname = get_op(op).name
        groups = self._groups(opname)
        self._count(groups)
        logging = sflog.enabled()
        out: List[Any] = [None] * len(self.specs)
        for g in groups:
            src, dst = self._fused(g, srcs, nsrc), self._fused(g, dsts, ndst)
            with sflog.span(event):
                t0 = sflog.op_begin() if logging else 0.0
                fused = exchange(src, dst, op)
                if logging:
                    sflog.op_end(event, t0, fused,
                                 nbytes=self._group_bytes(g),
                                 tags={"op": opname,
                                       "fields": len(g.members)})
            self._split(g, fused, ndst, out)
        return out

    def bcast_multi(self, rootfields, leaffields, op="replace"):
        """k root→leaf broadcasts as one fused exchange per group; returns
        the updated leaf fields (user order)."""
        nroot = self.comm.sf.nroots_total
        nleaf = self.comm.sf.nleafspace_total
        self._check(rootfields, "rootdata", nroot)
        self._check(leaffields, "leafdata", nleaf)
        return self._run(rootfields, leaffields, op, self._exec.bcast,
                         nroot, nleaf, "SFBcastMulti")

    def reduce_multi(self, leaffields, rootfields, op="sum"):
        """k leaf→root reductions as one fused exchange per group; returns
        the updated root fields (user order)."""
        nroot = self.comm.sf.nroots_total
        nleaf = self.comm.sf.nleafspace_total
        self._check(leaffields, "leafdata", nleaf)
        self._check(rootfields, "rootdata", nroot)
        return self._run(leaffields, rootfields, op, self._exec.reduce,
                         nleaf, nroot, "SFReduceMulti")

    # ------------------------------------------------- split-phase (begin/end)
    def _multi_begin(self, kind: str, srcs, op, nsrc: int) -> PendingMulti:
        opn = get_op(op)
        begin = getattr(self._exec, f"{kind}_begin")
        groups = self._groups(opn.name)
        ev_begin, ev_end = _MULTI_EVENTS[kind]
        with sflog.span(ev_begin):
            logging = sflog.enabled()
            t0 = sflog.op_begin() if logging else 0.0
            self._count(groups)
            items = [(g, begin(self._fused(g, srcs, nsrc), opn))
                     for g in groups]
            pend = PendingMulti(kind, self, opn, items)
            if logging:
                nb = sum(self._group_bytes(g) for g in groups)
                tags = {"op": opn.name, "groups": len(groups),
                        "fields": len(self.specs)}
                sflog.op_end(ev_begin, t0, None, nbytes=nb, tags=tags)
                sflog.stash_pending(pend, ev_end, nb, tags, tracing=t0 < 0)
            return pend

    def _multi_end(self, pending: PendingMulti, dsts):
        with sflog.span(_MULTI_EVENTS[pending.kind][1]):
            info = sflog.claim_pending(pending)
            if info is None:
                return self._multi_end_impl(pending, dsts)
            t0 = time.perf_counter()
            out = self._multi_end_impl(pending, dsts)
            sflog.pending_end(info, t0, out)
            return out

    def _multi_end_impl(self, pending: PendingMulti, dsts):
        kind = pending.kind
        what = "leafdata" if kind == "bcast" else "rootdata"
        ndst = self.comm.sf.nleafspace_total if kind == "bcast" \
            else self.comm.sf.nroots_total
        self._check(dsts, what, ndst)
        out: List[Any] = [None] * len(self.specs)
        for g, tok in pending.items:
            self._split(g, tok.end(self._fused(g, dsts, ndst)), ndst, out)
        return out

    def bcast_multi_begin(self, rootfields, op="replace") -> PendingMulti:
        """Issue the packed root→leaf payloads for every fusable group and
        return the in-flight token; complete with
        ``pending.end(leaffields)``."""
        self._check(rootfields, "rootdata", self.comm.sf.nroots_total)
        return self._multi_begin("bcast", rootfields, op,
                                 self.comm.sf.nroots_total)

    def bcast_multi_end(self, pending: PendingMulti, leaffields):
        return self._multi_end(pending, leaffields)

    def reduce_multi_begin(self, leaffields, op="sum") -> PendingMulti:
        """Issue the packed leaf→root payloads for every fusable group and
        return the in-flight token; complete with
        ``pending.end(rootfields)``."""
        self._check(leaffields, "leafdata", self.comm.sf.nleafspace_total)
        return self._multi_begin("reduce", leaffields, op,
                                 self.comm.sf.nleafspace_total)

    def reduce_multi_end(self, pending: PendingMulti, rootfields):
        return self._multi_end(pending, rootfields)


def _sibling_backend(backend):
    """A shallow copy of ``backend`` with only the plan's unit constraint
    lifted: the device index tensors and caches stay shared (for
    ``"dist"``, those of its ``DistSF``; group, lowering and sync mode
    too)."""
    dist_sf = getattr(backend, "dist", None)      # the "dist" facade
    if dist_sf is not None:
        sib = copy.copy(backend)
        sib.dist = copy.copy(dist_sf)
        sib.dist.plan = dataclasses.replace(dist_sf.plan, unit=UnitSpec())
        return sib
    plan = getattr(backend, "plan", None)
    if plan is None:
        raise TypeError(f"cannot derive an unconstrained sibling of "
                        f"{type(backend).__name__}")
    sib = copy.copy(backend)
    sib.plan = dataclasses.replace(plan, unit=UnitSpec())
    return sib
