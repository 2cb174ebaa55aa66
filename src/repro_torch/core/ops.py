"""SF communication operations (paper §3.2) in plain torch on global arrays.

The ``"global"`` backend: every operation is a few torch gathers and
scatters over the concatenated root and leaf arrays, with the index lists
of the :class:`repro_torch.core.plan.GlobalPlan` uploaded to the device once,
at construction.  The kernel backend (:mod:`repro_torch.core.backend`,
``"cuda"``) must agree with it.

All operations come in fused form (``bcast``) and split begin/end form
(``bcast_begin`` / ``bcast_end``), the paper's mechanism for overlapping
communication with independent computation: work issued between begin and
end is independent of the in-flight buffer.

Operations are functional: they return new tensors and leave the caller's
``rootdata`` / ``leafdata`` untouched.

Two pieces here serve both backends.  :class:`SortedUnpack` finishes every
reduction the same way on each: the buffer sorted by destination root is
folded segment by segment in buffer order (the ``sf_unpack`` kernel on the
card), then written with one duplicate-free scatter, so a float reduction
is the same bits on every run and on either backend.  :func:`unsigned_payloads`
carries uint16 / uint32 payloads, which torch can neither gather nor
combine, through signed types, and bool payloads through uint8.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional, Tuple

import torch

from .device import check_payload, index_tensor, kernel_index, resolve_device
from .graph import StarForest
from .mpiops import SUM, Op, get_op
from .plan import GlobalPlan, build_global_plan
from .redplan import ReductionPlan
from .unit import check_plan_unit
from . import sflog
from ..kernels import ops as kops
from ..kernels import sf_unpack

__all__ = ["SFOps", "PendingComm", "SortedUnpack", "unsigned_payloads"]

_AT = {"add": torch.add, "multiply": torch.mul, "max": torch.maximum,
       "min": torch.minimum}


@dataclasses.dataclass
class PendingComm:
    """In-flight communication token returned by *Begin operations."""
    kind: str
    payload: torch.Tensor
    op: Op
    owner: object = None
    dtype: Optional[torch.dtype] = None   # the payload's own dtype

    def end(self, data: torch.Tensor) -> torch.Tensor:
        """Complete the operation against the destination array (and
        record the End event its begin stashed, once), in a span of the
        End's name."""
        bcast = self.kind == "bcast"
        with sflog.span("SFBcastEnd" if bcast else "SFReduceEnd"):
            info = sflog.claim_pending(self)
            t0 = time.perf_counter() if info is not None else 0.0
            if bcast:
                out = self.owner.bcast_end(self, data)
            else:
                out = self.owner.reduce_end(self, data)
            if info is not None:
                sflog.pending_end(info, t0, out)
            return out

    def converted(self, fn, dtype: torch.dtype) -> "PendingComm":
        """This token with its payload rows mapped by ``fn``, now of
        ``dtype`` (:func:`unsigned_payloads`' conversion by value)."""
        return dataclasses.replace(self, payload=fn(self.payload),
                                   dtype=dtype)


def _apply_unique(target: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  op: Op) -> torch.Tensor:
    """A copy of ``target`` with ``vals`` combined in at the duplicate-free
    rows ``idx`` by the op's ``at_update`` method."""
    out = target.clone()
    vals = vals.to(target.dtype)
    if op.at_update == "set":
        out[idx] = vals
    else:
        out[idx] = _AT[op.at_update](out[idx], vals)
    return out


class SortedUnpack:
    """The unpack of a reduction without atomics (paper §5.3; the
    reference's sort-segment plan, :mod:`repro_torch.core.redplan`).

    ``sv`` holds one row per slot in ``red.perm`` order, so the slots of one
    root form a segment.  Replace takes each segment's last writer; sum,
    prod, max and min fold each segment in buffer order through
    ``kops.segment_reduce_rows`` (the ``sf_unpack`` kernel on a CUDA
    tensor, its plain version on the CPU), then one duplicate-free scatter
    combines the segment rows into a copy of ``rootdata``.  Logical ops
    reduce through the plain segment ops over their int32 view.
    ``red`` is a :class:`ReductionPlan`, or any object with its segment
    fields (``nseg``, ``duplicate_free``, ``win_src`` / ``win_dst``,
    ``dst_sorted``, ``seg_dst``, ``seg_of_slot``, ``seg_first``,
    ``seg_len``).  ``plain=True`` folds through the kernels' plain version
    on any device (the distributed lowering's ``use_kernels=False``).
    ``key`` (the plan's ``comm_signature()``) scopes the segment reduce's
    autotuned winner.
    """

    def __init__(self, red: ReductionPlan, device: torch.device,
                 plain: bool = False, key=None):
        self.plain, self.key = plain, key
        self.nseg, self.duplicate_free = red.nseg, red.duplicate_free
        self.win_src = index_tensor(red.win_src, device)
        self.win_dst = index_tensor(red.win_dst, device)
        self.dst_sorted = index_tensor(red.dst_sorted, device)
        self.seg_dst = index_tensor(red.seg_dst, device)
        self.seg_of_slot = index_tensor(red.seg_of_slot, device)
        self.seg_first = kernel_index(red.seg_first, device)
        self.seg_len = kernel_index(red.seg_len, device)
        sf_unpack.prepare(self.seg_first, self.seg_len, device)

    def __call__(self, rootdata: torch.Tensor, sv: torch.Tensor,
                 op: Op) -> torch.Tensor:
        if sv.shape[0] == 0:
            return rootdata.clone()
        if op.name == "replace":
            out = rootdata.clone()
            out[self.win_dst] = sv[self.win_src].to(rootdata.dtype)
            return out
        if op.name in _FOLDS and math.prod(sv.shape[1:]):
            if self.duplicate_free:
                # one slot per root: the unpack scatter is the reduction
                return _apply_unique(rootdata, self.dst_sorted, sv, op)
            if self.plain:
                seg = sf_unpack.segment_reduce_plain(sv, self.seg_first,
                                                     self.seg_len, op.name)
            else:
                seg = kops.segment_reduce_rows(sv, self.seg_first,
                                               self.seg_len, op=op.name,
                                               key=self.key)
        else:
            seg = op.segment(sv, self.seg_of_slot, self.nseg)
        return _apply_unique(rootdata, self.seg_dst, seg, op)


_FOLDS = ("sum", "prod", "max", "min")

# torch implements no gather, scatter or arithmetic for uint16 / uint32 on
# the CPU.  Replace, sum and prod give the same bits in two's complement, so
# they move such payloads as same-width signed views; max, min and the
# logical ops compare, so they widen them (and narrow the result back).  A
# bool payload rides uint8 0/1 either way: there max and min are logical or
# and and, bit for bit, and the segment reduce takes uint8.
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.bool: torch.uint8}
_WIDE = {torch.uint16: torch.int32, torch.uint32: torch.int64,
         torch.bool: torch.uint8}
# the reference's TypeError for a sum or product into bool (jnp's add and
# multiply take no bool)
_NO_BOOL = {"sum": "add", "prod": "multiply"}


def _keeps_bits(op) -> bool:
    return get_op(op).name in ("replace", "sum", "prod")


def _carry(t, view: bool):
    if not isinstance(t, torch.Tensor) or t.dtype not in _SIGNED:
        return t      # (a payload that is no tensor raises in the backend)
    return t.view(_SIGNED[t.dtype]) if view else t.to(_WIDE[t.dtype])


def _dtype(t):
    return getattr(t, "dtype", None)


def _uncarry(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype not in _SIGNED or t.dtype == dtype:
        return t
    return t.view(dtype) if t.dtype == _SIGNED[dtype] else t.to(dtype)


def _check_bool_dst(op, dst) -> None:
    name = _NO_BOOL.get(get_op(op).name)
    if name is not None and _dtype(dst) == torch.bool:
        raise TypeError(f"{name} does not accept dtype bool: an SF "
                        f"{get_op(op).name} into a bool destination")


def unsigned_payloads(cls):
    """Class decorator for an SF backend: every operation takes uint16,
    uint32 and bool payloads, carried as signed views (replace, sum, prod,
    between payloads of one dtype) or widened (otherwise) — a bool as
    uint8 either way — its result returned in the caller's dtype.  A
    payload of another dtype than a bool destination is first converted
    to bool by value, and a bool payload to a non-bool destination's dtype
    (so a sum gives the counts in that dtype), as a reduction that casts
    first would.  A begin records its payload's dtype on the pending
    token; an end whose destination has another dtype, and one of the two
    is carried, first converts the payload to it by value through the
    token's ``converted``.  A sum or product into bool raises
    ``TypeError``, as the reference does.  Methods the class lacks are
    left out."""
    def pair(f, default):
        @functools.wraps(f)
        def run(self, src, dst, op=default):
            _check_bool_dst(op, dst)
            if torch.bool in (_dtype(src), _dtype(dst)) \
                    and None not in (_dtype(src), _dtype(dst)):
                src = src.to(dst.dtype)
            view = _keeps_bits(op) and _dtype(src) == _dtype(dst)
            return _uncarry(f(self, _carry(src, view), _carry(dst, view), op),
                            _dtype(dst))
        return run

    def begin(f, default):
        @functools.wraps(f)
        def run(self, src, op=default):
            pend = f(self, _carry(src, _keeps_bits(op)), op)
            pend.dtype = src.dtype           # f checked that it is a tensor
            return pend
        return run

    def end(f):
        @functools.wraps(f)
        def run(self, pending, dst):
            _check_bool_dst(pending.op, dst)
            view, dt, src = _keeps_bits(pending.op), _dtype(dst), \
                pending.dtype
            if dt is not None and src not in (None, dt) and (
                    src in _SIGNED or dt in _SIGNED):
                pending = pending.converted(
                    lambda v: _carry(_uncarry(v, src).to(dt), view), dt)
            return _uncarry(f(self, pending, _carry(dst, view)), dt)
        return run

    def fetch(f):
        @functools.wraps(f)
        def run(self, rootdata, leafdata, op="sum"):
            view = _dtype(rootdata) == _dtype(leafdata)
            root, leaf = f(self, _carry(rootdata, view),
                           _carry(leafdata, view), op)
            return (_uncarry(root, rootdata.dtype),
                    _uncarry(leaf, leafdata.dtype))
        return run

    def gather(f):
        @functools.wraps(f)
        def run(self, leafdata):
            return _uncarry(f(self, _carry(leafdata, True)), _dtype(leafdata))
        return run

    def scatter(f):
        @functools.wraps(f)
        def run(self, multirootdata, leafdata=None):
            like = multirootdata if leafdata is None else leafdata
            view = _dtype(like) == _dtype(multirootdata)
            return _uncarry(f(self, _carry(multirootdata, view),
                              _carry(leafdata, view)), _dtype(like))
        return run

    for name, wrap in (("bcast", lambda f: pair(f, "replace")),
                       ("reduce", lambda f: pair(f, "sum")),
                       ("bcast_begin", lambda f: begin(f, "replace")),
                       ("reduce_begin", lambda f: begin(f, "sum")),
                       ("bcast_end", end), ("reduce_end", end),
                       ("fetch_and_op", fetch), ("gather", gather),
                       ("scatter", scatter)):
        if hasattr(cls, name):
            setattr(cls, name, wrap(getattr(cls, name)))
    return cls


@unsigned_payloads
class SFOps:
    """Executable operations bound to one StarForest template.

    The constructor performs the setup-time analysis (``GlobalPlan``) and
    uploads the plan's index lists to ``device``.  Payload rows are
    ``(*unit)`` dof blocks of any rank and dtype (paper §3.2's
    ``MPI_Datatype unit``); passing ``unit=`` pins the plan's unit and
    validates payloads at the SF boundary.
    """

    def __init__(self, sf: StarForest, plan: Optional[GlobalPlan] = None,
                 unit=None, *, device=None):
        sf.setup()
        self.sf = sf
        self.device = resolve_device(device)
        if plan is not None:
            check_plan_unit(plan, unit)
            self.plan = plan
        else:
            self.plan = build_global_plan(sf, unit=unit)
        p, d = self.plan, self.device
        self._gr = index_tensor(p.gr, d)
        self._gl = index_tensor(p.gl, d)
        self._perm = index_tensor(p.red_perm, d)
        self._inv_perm = index_tensor(p.red.inv_perm, d)
        self._gr_sorted = index_tensor(p.gr[p.red_perm], d)
        self._seg_start = index_tensor(p.red_seg_start, d)
        self._multi_slot = index_tensor(p.multi_slot, d)
        self._unpack = SortedUnpack(p.red, d, key=p.comm_signature())

    @property
    def unit(self):
        """The plan's payload unit spec (paper §3.2 ``MPI_Datatype``)."""
        return self.plan.unit

    def _arg(self, t, what: str) -> torch.Tensor:
        return check_payload(t, self.device, what)

    # ------------------------------------------------------------- bcast
    def bcast_begin(self, rootdata: torch.Tensor, op="replace") -> PendingComm:
        """Roots push values toward leaves; returns the in-flight buffer."""
        op = get_op(op)
        rootdata = self._arg(rootdata, "rootdata")
        self.plan.unit.check(rootdata, "rootdata")
        vals = rootdata.index_select(0, self._gr)   # pack == gather
        return PendingComm("bcast", vals, op, self)

    def bcast_end(self, pending: PendingComm,
                  leafdata: torch.Tensor) -> torch.Tensor:
        assert pending.kind == "bcast"
        leafdata = self._arg(leafdata, "leafdata")
        # each leaf has exactly one root -> unique destinations
        return _apply_unique(leafdata, self._gl, pending.payload, pending.op)

    def bcast(self, rootdata, leafdata, op="replace"):
        return self.bcast_end(self.bcast_begin(rootdata, op), leafdata)

    # ------------------------------------------------------------- reduce
    def reduce_begin(self, leafdata: torch.Tensor, op="sum") -> PendingComm:
        """Leaves push values toward roots."""
        op = get_op(op)
        leafdata = self._arg(leafdata, "leafdata")
        self.plan.unit.check(leafdata, "leafdata")
        vals = leafdata.index_select(0, self._gl)
        return PendingComm("reduce", vals, op, self)

    def reduce_end(self, pending: PendingComm,
                   rootdata: torch.Tensor) -> torch.Tensor:
        assert pending.kind == "reduce"
        rootdata = self._arg(rootdata, "rootdata")
        # values cast to the root dtype, sorted by root: the deterministic
        # sorted-segment unpack (no atomics on the card)
        sv = pending.payload.to(rootdata.dtype).index_select(0, self._perm)
        return self._unpack(rootdata, sv, pending.op)

    def reduce(self, leafdata, rootdata, op="sum"):
        return self.reduce_end(self.reduce_begin(leafdata, op), rootdata)

    # -------------------------------------------------------- fetch-and-op
    def fetch_and_op(self, rootdata: torch.Tensor, leafdata: torch.Tensor,
                     op="sum") -> Tuple[torch.Tensor, torch.Tensor]:
        """Paper §3.2 FetchAndOp (op must be ``sum``): every leaf receives the
        root's value as of all earlier edges (deterministic order); roots end
        up fully reduced.  Returns ``(rootdata', leafupdate)``."""
        op = get_op(op)
        if op.name != "sum":
            raise NotImplementedError("fetch_and_op supports op='sum' "
                                      "(fetch-and-add), as used by the paper")
        rootdata = self._arg(rootdata, "rootdata")
        leafdata = self._arg(leafdata, "leafdata")
        vals = leafdata.index_select(0, self._gl)
        sv = vals.index_select(0, self._perm)            # sorted by root
        excl = exclusive_segment_prefix(sv, self._seg_start)
        base = rootdata.index_select(0, self._gr_sorted)
        fetched_sorted = base + excl.to(rootdata.dtype)
        # un-permute: fetched[perm[i]] = fetched_sorted[i]
        fetched = fetched_sorted.index_select(0, self._inv_perm)
        leafupdate = leafdata.clone()
        leafupdate[self._gl] = fetched.to(leafdata.dtype)
        return self._unpack(rootdata, sv.to(rootdata.dtype), SUM), leafupdate

    # ------------------------------------------------------ gather/scatter
    @property
    def nmulti(self) -> int:
        return self.plan.nmulti

    def gather(self, leafdata: torch.Tensor) -> torch.Tensor:
        """SFGather: leaf values land in per-edge multi-root slots."""
        leafdata = self._arg(leafdata, "leafdata")
        out = leafdata.new_zeros((self.plan.nmulti,) + leafdata.shape[1:])
        out[self._multi_slot] = leafdata.index_select(0, self._gl)
        return out

    def scatter(self, multirootdata: torch.Tensor,
                leafdata: Optional[torch.Tensor] = None) -> torch.Tensor:
        """SFScatter: inverse of gather."""
        multirootdata = self._arg(multirootdata, "multirootdata")
        vals = multirootdata.index_select(0, self._multi_slot)
        if leafdata is None:
            out = multirootdata.new_zeros((self.plan.nleafspace,)
                                          + multirootdata.shape[1:])
        else:
            out = self._arg(leafdata, "leafdata").clone()
        out[self._gl] = vals.to(out.dtype)
        return out

    # ------------------------------------------------------------- degrees
    def compute_degrees(self) -> torch.Tensor:
        """Root degrees via SFReduce of ones — the paper's degree routine."""
        ones = torch.ones((self.plan.nleafspace,), dtype=torch.int32,
                          device=self.device)
        zeros = torch.zeros((self.plan.nroots,), dtype=torch.int32,
                            device=self.device)
        return self.reduce(ones, zeros)


def exclusive_segment_prefix(sv: torch.Tensor,
                             seg_start: torch.Tensor) -> torch.Tensor:
    """Exclusive in-segment prefix sums of a segment-sorted buffer:
    ``csum - sv - (csum[head] - sv[head])`` as in the reference."""
    csum = torch.cumsum(sv, dim=0, dtype=sv.dtype)
    head = csum.index_select(0, seg_start) - sv.index_select(0, seg_start)
    return csum - sv - head
