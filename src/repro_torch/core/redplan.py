"""Shared sort-segment reduction machinery (DESIGN.md §3.3).

Deterministic SF reductions replace atomics with a setup-time sort: slots (edges, or padded receive-buffer positions) are ordered by
destination root with the deterministic (leaf rank, edge index) key as the
tiebreak; runs with equal destination form *segments*; a segment reduction
plus one duplicate-free scatter then realizes any reduction op, and the last
valid slot of each segment is the precomputed REPLACE winner.

The plan builder, the ``cuda`` backend and the segment-reduce kernel
metadata all consume this single implementation (a numpy copy of
``repro.core.redplan``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ReductionPlan", "build_reduction_plan", "seg_block_candidates"]


def seg_block_candidates(nseg: int, lmax: int,
                         max_panel_rows: int = 65536) -> tuple:
    """Segments-per-block candidates of the blocked segment reduce for
    ``nseg`` segments whose longest has ``lmax`` rows: 8, 32 and 128 (and
    every segment in one block when there are at most 1,024), each held to
    ``nseg``, keeping those whose ``(segs_per_block, lmax)`` panel stays
    within ``max_panel_rows`` rows (the reference's rule, which the
    autotuner's ``segred`` kind sweeps)."""
    S = max(int(nseg), 1)
    L = max(int(lmax), 1)
    cands = {min(S, b) for b in (8, 32, 128)}
    if S <= 1024:
        cands.add(S)
    fit = tuple(sorted(b for b in cands if b * L <= max_panel_rows))
    return fit or (min(S, 8),)


@dataclasses.dataclass(frozen=True)
class ReductionPlan:
    """Setup products of one sorted slot space.

    ``nslots`` slots each carry a destination (``garbage`` marks padding
    slots) and a deterministic order key.  Slots are sorted by
    ``(destination, order)`` with invalid slots last; equal destinations form
    segments.  Compact per-segment arrays (``seg_dst``/``seg_first``/
    ``seg_len``) drive the segment-reduce kernel; the per-slot arrays
    (``seg_of_slot``/``seg_start_of_slot``) drive plain segment ops and the
    fetch-and-op prefix logic; ``win_src``/``win_dst`` are the REPLACE
    last-writer winners.
    """

    nslots: int
    garbage: int | None         # destination value marking invalid slots
    perm: np.ndarray            # (n,) slot ids in sorted order
    inv_perm: np.ndarray        # (n,) inverse permutation
    dst_sorted: np.ndarray      # (n,) destination per sorted slot
    valid_sorted: np.ndarray    # (n,) bool
    seg_of_slot: np.ndarray     # (n,) segment id per sorted slot
    seg_start_of_slot: np.ndarray  # (n,) sorted position of the slot's
    #                                    segment head
    nseg: int                   # total segments (incl. garbage segment)
    nseg_valid: int             # segments with a real destination
    seg_dst: np.ndarray         # (nseg,) destination per segment
    seg_first: np.ndarray       # (nseg,) sorted position of segment head
    seg_len: np.ndarray         # (nseg,) segment length
    win_src: np.ndarray         # (nseg_valid,) sorted position of REPLACE
    #                                           winner per valid segment
    win_dst: np.ndarray         # (nseg_valid,) its destination

    @property
    def max_valid_seg_len(self) -> int:
        """Longest valid segment (at least 1)."""
        if self.nseg_valid == 0:
            return 1
        return max(int(self.seg_len[: self.nseg_valid].max()), 1)

    def seg_block_candidates(self, max_panel_rows: int = 65536) -> tuple:
        """Segments-per-block candidates for the blocked segment reduce
        (:func:`seg_block_candidates` of this plan's segments)."""
        return seg_block_candidates(self.nseg, self.max_valid_seg_len,
                                    max_panel_rows)

    @property
    def duplicate_free(self) -> bool:
        """True when every valid segment has exactly one slot — reductions
        degenerate to a plain scatter (no segment reduction needed)."""
        if self.nseg_valid == 0:
            return True
        return bool((self.seg_len[: self.nseg_valid] == 1).all())


def build_reduction_plan(dst, order=None, *, garbage=None) -> ReductionPlan:
    """Build the deterministic reduction machinery for one slot space.

    ``dst[i]``   destination root of slot ``i`` (``garbage`` for padding),
    ``order[i]`` deterministic tiebreak key (default: slot index — the
                 (leaf rank, edge index) order when slots are edges).

    Valid segments always precede garbage slots in the sorted order (invalid
    slots sort with an infinite key), so ``seg_dst[:nseg_valid]`` are exactly
    the real destinations.
    """
    dst = np.asarray(dst, dtype=np.int64)
    n = int(dst.size)
    order = np.arange(n, dtype=np.int64) if order is None \
        else np.asarray(order, dtype=np.int64)
    if order.shape != dst.shape:
        raise ValueError("dst and order must have the same length")
    if garbage is None:
        valid = np.ones(n, dtype=bool)
        key = dst
    else:
        valid = dst != garbage
        key = np.where(valid, dst, np.iinfo(np.int64).max)

    perm = np.lexsort((order, key))
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)
    dst_s = dst[perm]
    valid_s = valid[perm]

    if n:
        change = np.empty(n, dtype=bool)
        change[0] = True
        change[1:] = dst_s[1:] != dst_s[:-1]
        seg_of = (np.cumsum(change) - 1).astype(np.int64)
        heads = np.flatnonzero(change).astype(np.int64)
        seg_start_of_slot = heads[seg_of]
        seg_dst = dst_s[heads]
        seg_len = np.diff(np.append(heads, n)).astype(np.int64)
        nseg = int(heads.size)
        nseg_valid = int(valid_s[heads].sum())
    else:
        seg_of = np.zeros(0, dtype=np.int64)
        heads = np.zeros(0, dtype=np.int64)
        seg_start_of_slot = np.zeros(0, dtype=np.int64)
        seg_dst = np.zeros(0, dtype=np.int64)
        seg_len = np.zeros(0, dtype=np.int64)
        nseg = 0
        nseg_valid = 0

    # REPLACE winners: last valid sorted position of each valid segment.
    v_pos = np.flatnonzero(valid_s)
    if v_pos.size:
        d = dst_s[v_pos]
        is_last = np.append(d[1:] != d[:-1], True)
        win_src = v_pos[is_last].astype(np.int64)
        win_dst = d[is_last]
    else:
        win_src = np.zeros(0, dtype=np.int64)
        win_dst = np.zeros(0, dtype=np.int64)

    return ReductionPlan(
        nslots=n,
        garbage=garbage,
        perm=perm.astype(np.int64),
        inv_perm=inv_perm,
        dst_sorted=dst_s,
        valid_sorted=valid_s,
        seg_of_slot=seg_of,
        seg_start_of_slot=seg_start_of_slot,
        nseg=nseg,
        nseg_valid=nseg_valid,
        seg_dst=seg_dst,
        seg_first=heads,
        seg_len=seg_len,
        win_src=win_src,
        win_dst=win_dst,
    )
