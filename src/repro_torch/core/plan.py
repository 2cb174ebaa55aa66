"""Communication plans: the setup-time products that make SF ops fast.

``PetscSFSetUp`` is where the paper amortizes all index analysis (two-sided
info, §5.1; pack pattern discovery, §5.2).  ``GlobalPlan`` collects those
products for execution on *global* concatenated arrays: the edge arrays in
the deterministic (leaf rank, edge index) order, the multi-root layout of
gather/scatter, and the sort-segment reduction machinery of
:mod:`repro_torch.core.redplan`.  The arrays are numpy; the backends upload
the ones they use to their device once, at construction.

``PaddedPlan`` holds the per-rank, uniformly padded pack / unpack index
matrices of the distributed lowering (:mod:`repro_torch.core.distributed`),
with the sort-segment reduction machinery built once per root rank over
its padded slot space.  Padding convention: data shards get one trailing
*garbage row*, and every padded index points at it.

A numpy copy of ``repro.core.plan``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .graph import StarForest
from .redplan import ReductionPlan, build_reduction_plan
from .unit import UnitSpec, resolve_unit
from . import patterns as pat

__all__ = ["GlobalPlan", "PaddedPlan", "build_global_plan",
           "build_padded_plan"]

# Deterministic order key: (leaf rank, edge index) packed into one int64.
_RANK_STRIDE = 10 ** 12


@dataclasses.dataclass(frozen=True)
class GlobalPlan:
    """Setup products for executing SF ops on *global* concatenated arrays.

    Reduce determinism comes from the shared sort-segment machinery in
    ``red``; the ``red_*``/``replace_last`` accessors below are views of it
    under the names the execution paths use.
    """

    nroots: int
    nleafspace: int
    gr: np.ndarray            # (E,) global root id per edge (deterministic order)
    gl: np.ndarray            # (E,) global leaf id per edge
    # Multi-SF layout (paper §3.2): slot of each edge in multi-root space.
    nmulti: int
    multi_slot: np.ndarray    # (E,)
    degrees: np.ndarray       # (nroots,) root degrees
    red: ReductionPlan        # shared sort-segment reduction machinery
    pattern: pat.PatternReport = None
    # paper §3.2: the MPI_Datatype unit of payload rows.  Unconstrained by
    # default; pinned units validate payloads at the SF boundary.
    unit: UnitSpec = UnitSpec()

    @property
    def nedges(self) -> int:
        return int(self.gr.shape[0])

    def comm_signature(self) -> tuple:
        """Hashable (pattern, unit) signature of this plan's shapes."""
        return ("global", self.nroots, self.nleafspace, self.nedges,
                self.red.nseg, self.red.max_valid_seg_len,
                self.red.duplicate_free, self.unit.shape,
                None if self.unit.dtype is None else self.unit.dtype.str,
                None if self.pattern is None else self.pattern.kind)

    # views of the shared machinery (single source of truth: ``red``)
    @property
    def red_perm(self) -> np.ndarray:
        """(E,) edge order sorted by (gr, edge order)."""
        return self.red.perm

    @property
    def red_seg_root(self) -> np.ndarray:
        """(S,) destination root of each segment."""
        return self.red.seg_dst

    @property
    def red_seg_of_edge(self) -> np.ndarray:
        """(E,) segment id of sorted edge."""
        return self.red.seg_of_slot

    @property
    def red_seg_start(self) -> np.ndarray:
        """(E,) index (into sorted order) of segment head."""
        return self.red.seg_start_of_slot

    @property
    def replace_last(self) -> np.ndarray:
        """(S,) sorted-position of last edge per segment."""
        return self.red.win_src


def build_global_plan(sf: StarForest, unit=None) -> GlobalPlan:
    edges = sf.edges_global()
    gr, gl = edges[:, 0], edges[:, 1]
    E = gr.shape[0]
    red = build_reduction_plan(gr)

    degrees = np.bincount(gr, minlength=sf.nroots_total).astype(np.int64)
    base = np.zeros(sf.nroots_total + 1, dtype=np.int64)
    np.cumsum(degrees, out=base[1:])
    # occurrence index of each sorted edge within its root = pos - seg_start
    occ = np.arange(E, dtype=np.int64) - red.seg_start_of_slot
    multi_slot = np.zeros(E, dtype=np.int64)
    multi_slot[red.perm] = base[red.dst_sorted] + occ

    return GlobalPlan(
        nroots=sf.nroots_total,
        nleafspace=sf.nleafspace_total,
        gr=gr, gl=gl,
        nmulti=int(degrees.sum()),
        multi_slot=multi_slot,
        degrees=degrees,
        red=red,
        pattern=pat.analyze(sf),
        unit=resolve_unit(unit),
    )


@dataclasses.dataclass(frozen=True)
class PaddedPlan:
    """Uniform per-rank arrays for the distributed lowering.

    Shard shapes: root shards ``(root_pad, *unit)`` and leaf shards
    ``(leaf_pad, *unit)``; both include a final garbage row, i.e.
    ``root_pad = max(nroots) + 1``.  ``P`` is the max per-pair message count
    (the padded slot count of the dense all-to-all buffer).
    """

    nranks: int
    root_pad: int             # incl. garbage row
    leaf_pad: int             # incl. garbage row
    nroots: np.ndarray        # (R,)
    nleafspace: np.ndarray    # (R,)
    P: int                    # padded per-pair slot count
    counts: np.ndarray        # (R, R) counts[p, q], p=root rank, q=leaf rank
    send_root_idx: np.ndarray  # (R, R, P) [p][q] root offsets (pad->garbage)
    recv_leaf_idx: np.ndarray  # (R, R, P) [q][p] leaf positions (pad->garbage)
    # self/local edges (paper §5.2 local/remote split)
    self_pad: int
    self_root_idx: np.ndarray  # (R, self_pad)
    self_leaf_idx: np.ndarray  # (R, self_pad)
    # Deterministic duplicate reduction at root side (sort-segment, §3.3):
    # flattened recv buffer on rank r has R*P slots; self edges are appended
    # after them (slots R*P .. R*P+self_pad-1) so one machinery covers both.
    red_nslots: int
    red_perm: np.ndarray       # (R, red_nslots) slot permutation (pad last)
    red_inv_perm: np.ndarray   # (R, red_nslots) inverse permutation
    red_dst: np.ndarray        # (R, red_nslots) root offset per sorted slot
    red_seg_id: np.ndarray     # (R, red_nslots) segment id per sorted slot
    red_seg_dst: np.ndarray    # (R, red_nslots) root offset per segment id
    red_seg_start: np.ndarray  # (R, red_nslots) segment-head position
    red_is_valid: np.ndarray   # (R, red_nslots) bool
    replace_win_src: np.ndarray  # (R, win_pad) sorted-slot of winner
    replace_win_dst: np.ndarray  # (R, win_pad) destination root offset
    pattern: pat.PatternReport = None
    permute_dst: Optional[List[int]] = None
    # segment-reduce kernel metadata (garbage segments get length 0, so
    # the kernel never touches padding runs)
    red_seg_first: np.ndarray = None  # (R, red_nslots) segment head position
    red_seg_len: np.ndarray = None    # (R, red_nslots) valid segment lengths
    red_Lmax: int = 1                 # longest valid segment across ranks
    red_dup_free: bool = False        # every rank's segments have length 1
    # paper §3.2 unit of payload rows (see GlobalPlan.unit)
    unit: UnitSpec = UnitSpec()

    def comm_signature(self) -> tuple:
        """Hashable (pattern, unit) signature of this plan's shapes (see
        :meth:`GlobalPlan.comm_signature`)."""
        return ("padded", self.nranks, self.root_pad, self.leaf_pad, self.P,
                self.self_pad, self.red_nslots, self.red_Lmax,
                self.red_dup_free, self.unit.shape,
                None if self.unit.dtype is None else self.unit.dtype.str,
                None if self.pattern is None else self.pattern.kind)


def build_padded_plan(sf: StarForest, unit=None) -> PaddedPlan:
    R = sf.nranks
    nroots = np.array([sf.graph(r).nroots for r in range(R)], dtype=np.int64)
    nleaf = np.array([sf.graph(r).nleafspace for r in range(R)],
                     dtype=np.int64)
    root_pad = int(nroots.max(initial=0)) + 1
    leaf_pad = int(nleaf.max(initial=0)) + 1
    root_garbage = root_pad - 1
    leaf_garbage = leaf_pad - 1

    counts = np.zeros((R, R), dtype=np.int64)
    for pi in sf.pairs:
        if pi.root_rank != pi.leaf_rank:
            counts[pi.root_rank, pi.leaf_rank] = pi.count
    P = max(int(counts.max(initial=0)), 1)

    send_root_idx = np.full((R, R, P), root_garbage, dtype=np.int64)
    recv_leaf_idx = np.full((R, R, P), leaf_garbage, dtype=np.int64)
    self_counts = np.zeros(R, dtype=np.int64)
    self_pairs = {}
    for pi in sf.pairs:
        p, q = pi.root_rank, pi.leaf_rank
        if p == q:
            self_counts[p] = pi.count
            self_pairs[p] = pi
        else:
            send_root_idx[p, q, : pi.count] = pi.root_idx
            recv_leaf_idx[q, p, : pi.count] = pi.leaf_idx
    self_pad = max(int(self_counts.max(initial=0)), 1)
    self_root_idx = np.full((R, self_pad), root_garbage, dtype=np.int64)
    self_leaf_idx = np.full((R, self_pad), leaf_garbage, dtype=np.int64)
    for p, pi in self_pairs.items():
        self_root_idx[p, : pi.count] = pi.root_idx
        self_leaf_idx[p, : pi.count] = pi.leaf_idx

    # ---- deterministic reduce machinery (per root rank) ------------------
    # Virtual slot space on rank r: R*P remote slots + self_pad local slots.
    nslots = R * P + self_pad
    red_perm = np.zeros((R, nslots), dtype=np.int64)
    red_inv_perm = np.zeros((R, nslots), dtype=np.int64)
    red_dst = np.full((R, nslots), root_garbage, dtype=np.int64)
    red_seg_id = np.zeros((R, nslots), dtype=np.int64)
    red_seg_dst = np.full((R, nslots), root_garbage, dtype=np.int64)
    red_seg_start = np.zeros((R, nslots), dtype=np.int64)
    red_is_valid = np.zeros((R, nslots), dtype=bool)
    red_seg_first = np.zeros((R, nslots), dtype=np.int64)
    red_seg_len = np.zeros((R, nslots), dtype=np.int64)
    rank_reds: List[ReductionPlan] = []
    for r in range(R):
        dst = np.full(nslots, root_garbage, dtype=np.int64)
        # order key: the deterministic (leaf rank q, edge index) order.
        order = np.full(nslots, np.iinfo(np.int64).max, dtype=np.int64)
        for q in range(R):
            pi = sf.pair(r, q)
            if pi is None or q == r:
                continue
            slots = q * P + np.arange(pi.count)
            dst[slots] = pi.root_idx
            order[slots] = q * _RANK_STRIDE + pi.edge_idx
        pi = self_pairs.get(r)
        if pi is not None:
            slots = R * P + np.arange(pi.count)
            dst[slots] = pi.root_idx
            order[slots] = r * _RANK_STRIDE + pi.edge_idx
        red = build_reduction_plan(dst, order, garbage=root_garbage)
        rank_reds.append(red)
        red_perm[r] = red.perm
        red_inv_perm[r] = red.inv_perm
        red_dst[r] = red.dst_sorted
        red_seg_id[r] = red.seg_of_slot
        red_seg_start[r] = red.seg_start_of_slot
        red_is_valid[r] = red.valid_sorted
        red_seg_dst[r, : red.nseg] = red.seg_dst
        red_seg_first[r, : red.nseg] = red.seg_first
        # garbage segments keep length 0: a segment reduce over them emits
        # identities, absorbed by the garbage row.
        red_seg_len[r, : red.nseg_valid] = red.seg_len[: red.nseg_valid]

    win_pad = max(max((red.nseg_valid for red in rank_reds), default=0), 1)
    replace_win_src = np.zeros((R, win_pad), dtype=np.int64)
    replace_win_dst = np.full((R, win_pad), root_garbage, dtype=np.int64)
    for r, red in enumerate(rank_reds):
        replace_win_src[r, : red.nseg_valid] = red.win_src
        replace_win_dst[r, : red.nseg_valid] = red.win_dst

    rep = pat.analyze(sf)
    return PaddedPlan(
        nranks=R,
        root_pad=root_pad,
        leaf_pad=leaf_pad,
        nroots=nroots,
        nleafspace=nleaf,
        P=P,
        counts=counts,
        send_root_idx=send_root_idx,
        recv_leaf_idx=recv_leaf_idx,
        self_pad=self_pad,
        self_root_idx=self_root_idx,
        self_leaf_idx=self_leaf_idx,
        red_nslots=nslots,
        red_perm=red_perm,
        red_inv_perm=red_inv_perm,
        red_dst=red_dst,
        red_seg_id=red_seg_id,
        red_seg_dst=red_seg_dst,
        red_seg_start=red_seg_start,
        red_is_valid=red_is_valid,
        replace_win_src=replace_win_src,
        replace_win_dst=replace_win_dst,
        pattern=rep,
        permute_dst=rep.permute_dst,
        red_seg_first=red_seg_first,
        red_seg_len=red_seg_len,
        red_Lmax=max(max((red.max_valid_seg_len for red in rank_reds),
                         default=1), 1),
        red_dup_free=all(red.duplicate_free for red in rank_reds),
        unit=resolve_unit(unit),
    )
