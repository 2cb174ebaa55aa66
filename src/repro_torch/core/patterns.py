"""Index-pattern discovery (paper §5.2) lifted to collective selection.

PETSc inspects pack/unpack index lists to skip packing (contiguous), use
parametric multi-strided packs (3D subdomains), and split local from remote
traffic.  The same analysis classifies the whole SF (allgather, block
permutation, local-only, general) so that backend selection and the kernel
backend's routing (fused local bcast, strided pack) can read it.  A numpy
copy of ``repro.core.patterns``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import StarForest

__all__ = [
    "Strided3D",
    "PatternReport",
    "is_contiguous",
    "detect_strided",
    "analyze",
]

# Lowering kinds, in order of preference.
LOCAL_ONLY = "local_only"       # no inter-rank edges: pure on-device scatter
ALLGATHER = "allgather"         # every rank's leaves = all roots, rank-major
PERMUTE = "permute"             # one send + one recv peer per rank, whole-block
GENERAL = "general"             # packed (ragged/padded) all-to-all
EMPTY = "empty"


@dataclasses.dataclass(frozen=True)
class Strided3D:
    """Multi-strided subdomain pattern (paper §5.2 ¶3):
    ``idx = start + i + X*j + X*Y*k`` for (i,j,k) in (0..dx, 0..dy, 0..dz)."""
    start: int
    dims: Tuple[int, int, int]     # (dx, dy, dz)
    strides: Tuple[int, int, int]  # (1, X, X*Y)

    def enumerate(self) -> np.ndarray:
        dx, dy, dz = self.dims
        sx, sy, sz = self.strides
        i = np.arange(dx)[None, None, :] * sx
        j = np.arange(dy)[None, :, None] * sy
        k = np.arange(dz)[:, None, None] * sz
        return (self.start + (i + j + k)).reshape(-1)


def is_contiguous(idx: np.ndarray) -> bool:
    if idx.size == 0:
        return True
    return bool(np.all(np.diff(idx) == 1))


def detect_strided(idx: np.ndarray) -> Optional[Strided3D]:
    """Try to express ``idx`` as a 3D-subdomain enumeration.

    Returns the parameters if the index list is exactly the x-fastest
    enumeration of a strided box, else None.  Contiguous lists are the
    degenerate (n,1,1) box.
    """
    n = int(idx.size)
    if n == 0:
        return None
    start = int(idx[0])
    rel = idx.astype(np.int64) - start
    if rel[0] != 0 or np.any(np.diff(rel) <= 0):
        return None
    if is_contiguous(idx):
        return Strided3D(start, (n, 1, 1), (1, n, n))
    # Infer dx: length of the leading unit-stride run.
    d = np.diff(rel)
    run = np.flatnonzero(d != 1)
    dx = int(run[0]) + 1 if run.size else n
    if n % dx:
        return None
    rows = rel.reshape(n // dx, dx)
    if not np.all(rows[:, 1:] - rows[:, :-1] == 1):
        return None
    starts = rows[:, 0]
    if starts.size == 1:
        return Strided3D(start, (dx, 1, 1), (1, dx, dx))
    sy = int(starts[1] - starts[0])
    ds = np.diff(starts)
    runy = np.flatnonzero(ds != sy)
    dy = int(runy[0]) + 1 if runy.size else starts.size
    if starts.size % dy:
        return None
    planes = starts.reshape(starts.size // dy, dy)
    if not np.all(np.diff(planes, axis=1) == sy):
        return None
    pstarts = planes[:, 0]
    if pstarts.size == 1:
        return Strided3D(start, (dx, dy, 1), (1, sy, sy * dy))
    sz = int(pstarts[1] - pstarts[0])
    if not np.all(np.diff(pstarts) == sz):
        return None
    return Strided3D(start, (dx, dy, pstarts.size), (1, sy, sz))


@dataclasses.dataclass
class PatternReport:
    kind: str
    permute_dst: Optional[List[int]] = None        # for PERMUTE: dst per rank
    pair_contiguous: Dict[Tuple[int, int], Tuple[bool, bool]] = dataclasses.field(
        default_factory=dict)                       # (root side, leaf side)
    pair_strided: Dict[Tuple[int, int], Tuple[Optional[Strided3D], Optional[Strided3D]]] = (
        dataclasses.field(default_factory=dict))
    n_local_edges: int = 0
    n_remote_edges: int = 0

    @property
    def pack_elidable_fraction(self) -> float:
        """Fraction of remote pairs whose *send side* needs no pack gather."""
        if not self.pair_contiguous:
            return 1.0
        good = sum(1 for c in self.pair_contiguous.values() if c[0])
        return good / len(self.pair_contiguous)


def _is_allgather(sf: StarForest) -> bool:
    """Every rank's connected leaves are exactly all roots, concatenated in
    rank order, landing contiguously at the start of its leaf space."""
    ro = sf.root_offsets()
    total = int(ro[-1])
    if total == 0:
        return False
    for q in range(sf.nranks):
        g = sf.graph(q)
        if g.nleaves != total or g.nleafspace < total:
            return False
        if not np.array_equal(g.local, np.arange(total)):
            return False
        want_rank = np.searchsorted(ro, np.arange(total), side="right") - 1
        want_off = np.arange(total) - ro[want_rank]
        if not (np.array_equal(g.remote_rank, want_rank)
                and np.array_equal(g.remote_offset, want_off)):
            return False
    return True


def _permute_dsts(sf: StarForest) -> Optional[List[int]]:
    """If each rank's roots go wholesale (in order) to exactly one other rank
    and each rank receives from exactly one rank, return dst per rank."""
    dst = [-1] * sf.nranks
    src_seen = [0] * sf.nranks
    for pi in sf.pairs:
        p, q = pi.root_rank, pi.leaf_rank
        if p == q:
            return None
        if dst[p] != -1:
            return None
        dst[p] = q
        src_seen[q] += 1
        g = sf.graph(p)
        if pi.count != g.nroots:
            return None
        if not np.array_equal(np.sort(pi.root_idx), np.arange(g.nroots)):
            return None
        if not np.array_equal(pi.root_idx, np.arange(g.nroots)):
            return None
        if not is_contiguous(pi.leaf_idx):
            return None
    if any(s > 1 for s in src_seen):
        return None
    if all(d == -1 for d in dst):
        return None
    # Ranks with no sends keep dst=-1 (no-op); ppermute handles missing pairs.
    return dst


def analyze(sf: StarForest) -> PatternReport:
    """Pattern discovery for ``sf``; memoized on the instance (the graph is
    immutable after ``setup()``, and both plan builders plus
    ``select_backend`` consult the report)."""
    sf._require_setup()
    cached = getattr(sf, "_pattern_report", None)
    if cached is not None:
        return cached
    rep = _analyze(sf)
    sf._pattern_report = rep
    return rep


def _analyze(sf: StarForest) -> PatternReport:
    n_local = sum(pi.count for pi in sf.pairs if pi.root_rank == pi.leaf_rank)
    n_remote = sum(pi.count for pi in sf.pairs if pi.root_rank != pi.leaf_rank)

    if n_local == 0 and n_remote == 0:
        return PatternReport(kind=EMPTY)
    if n_remote == 0:
        rep = PatternReport(kind=LOCAL_ONLY, n_local_edges=n_local)
        return rep

    if _is_allgather(sf):
        rep = PatternReport(kind=ALLGATHER, n_local_edges=n_local,
                            n_remote_edges=n_remote)
        return rep

    dst = _permute_dsts(sf)
    if dst is not None and n_local == 0:
        rep = PatternReport(kind=PERMUTE, permute_dst=dst,
                            n_local_edges=n_local, n_remote_edges=n_remote)
        return rep

    rep = PatternReport(kind=GENERAL, n_local_edges=n_local,
                        n_remote_edges=n_remote)
    for pi in sf.pairs:
        if pi.root_rank == pi.leaf_rank:
            continue
        key = (pi.root_rank, pi.leaf_rank)
        rep.pair_contiguous[key] = (
            is_contiguous(np.sort(pi.root_idx)), is_contiguous(pi.leaf_idx))
        rep.pair_strided[key] = (
            detect_strided(pi.root_idx), detect_strided(pi.leaf_idx))
    return rep
