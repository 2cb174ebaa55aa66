"""Communication plans: the setup-time products that make SF ops fast.

``PetscSFSetUp`` is where the paper amortizes all index analysis (two-sided
info, §5.1; pack pattern discovery, §5.2).  ``GlobalPlan`` collects those
products for execution on *global* concatenated arrays: the edge arrays in
the deterministic (leaf rank, edge index) order, the multi-root layout of
gather/scatter, and the sort-segment reduction machinery of
:mod:`repro_torch.core.redplan`.  The arrays are numpy; the backends upload
the ones they use to their device once, at construction.

A numpy copy of ``GlobalPlan`` / ``build_global_plan`` from
``repro.core.plan``; the padded per-rank plan of the distributed lowering
is not part of this package yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graph import StarForest
from .redplan import ReductionPlan, build_reduction_plan
from .unit import UnitSpec, resolve_unit
from . import patterns as pat

__all__ = ["GlobalPlan", "build_global_plan"]


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
