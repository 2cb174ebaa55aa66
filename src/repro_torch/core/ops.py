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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .device import check_payload, index_tensor, resolve_device
from .graph import StarForest
from .mpiops import Op, expand_rows, get_op
from .plan import GlobalPlan, build_global_plan
from .unit import check_plan_unit

__all__ = ["SFOps", "PendingComm"]

_AT = {"add": torch.add, "multiply": torch.mul, "max": torch.maximum,
       "min": torch.minimum}


@dataclasses.dataclass
class PendingComm:
    """In-flight communication token returned by *Begin operations."""
    kind: str
    payload: torch.Tensor
    op: Op
    owner: object = None

    def end(self, data: torch.Tensor) -> torch.Tensor:
        """Complete the operation against the destination array."""
        if self.kind == "bcast":
            return self.owner.bcast_end(self, data)
        return self.owner.reduce_end(self, data)


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
        win_edges = p.red_perm[p.replace_last]
        self._gr = index_tensor(p.gr, d)
        self._gl = index_tensor(p.gl, d)
        self._perm = index_tensor(p.red_perm, d)
        self._inv_perm = index_tensor(p.red.inv_perm, d)
        self._gr_sorted = index_tensor(p.gr[p.red_perm], d)
        self._win_edges = index_tensor(win_edges, d)
        self._win_dst = index_tensor(p.gr[win_edges], d)
        self._seg_of_edge = index_tensor(p.red_seg_of_edge, d)
        self._seg_start = index_tensor(p.red_seg_start, d)
        self._seg_root = index_tensor(p.red_seg_root, d)
        self._multi_slot = index_tensor(p.multi_slot, d)

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
        op = pending.op
        rootdata = self._arg(rootdata, "rootdata")
        vals = pending.payload.to(rootdata.dtype)
        if op.name == "replace":
            # deterministic last-writer wins, precomputed at setup
            out = rootdata.clone()
            out[self._win_dst] = vals.index_select(0, self._win_edges)
            return out
        if op.name == "sum":
            return rootdata.clone().index_add_(0, self._gr, vals)
        if op.name in ("prod", "max", "min"):
            how = {"prod": "prod", "max": "amax", "min": "amin"}[op.name]
            return rootdata.clone().scatter_reduce_(
                0, expand_rows(self._gr, vals), vals, how,
                include_self=True)
        # logical ops: reduce via segment machinery for exactness
        sorted_vals = pending.payload.index_select(0, self._perm)
        seg = op.segment(sorted_vals, self._seg_of_edge,
                         int(self.plan.red_seg_root.shape[0]))
        return _apply_unique(rootdata, self._seg_root, seg, op)

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
        root_out = rootdata.clone().index_add_(0, self._gr,
                                               vals.to(rootdata.dtype))
        return root_out, leafupdate

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
