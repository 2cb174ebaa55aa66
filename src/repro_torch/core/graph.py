"""Star-forest graph representation (paper §3.1) and setup (paper §5.1).

A star forest (SF) is a union of disjoint stars: each *leaf* vertex is
connected to exactly one *root* vertex (possibly on another rank); roots may
have any number of leaves (their *degree*), and both isolated leaves (holes in
the user's data structure) and leafless roots are allowed.

Edges are specified one-sidedly by the rank that owns the leaves (paper:
``PetscSFSetGraph``): each connected leaf states the ``(rank, offset)``
address of its root.  ``setup()`` derives the two-sided information of paper
§5.1 — for every rank, the list of root ranks its leaves touch and, for every
root rank, the list of leaf ranks that touch its roots, together with the
per-pair index lists used for message coalescing.

Adaptation note: PETSc builds the two-sided info with MPI_Allreduce or the
scalable Ibarrier algorithm of Hoefler et al.  Here the SF template is
*global host-side metadata* by construction (one process holds every rank's
graph), so the two-sided info is derived directly; it remains a one-time
setup cost amortized over many operations, exactly as in the paper.

This module is numpy-only and mirrors ``repro.core.graph`` array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "RankGraph",
    "PairInfo",
    "StarForest",
    "ragged_offsets",
]


def ragged_offsets(sizes: Sequence[int]) -> np.ndarray:
    """Exclusive prefix offsets for ragged concatenation; len = len(sizes)+1."""
    out = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(np.asarray(sizes, dtype=np.int64), out=out[1:])
    return out


@dataclasses.dataclass(frozen=True)
class RankGraph:
    """One rank's one-sided SF specification (``PetscSFSetGraph`` arguments).

    ``local[i]`` is the position of connected leaf ``i`` in this rank's leaf
    *space* (which may contain holes); ``remote_rank[i]``/``remote_offset[i]``
    address its root.  ``nleafspace`` is the size of the leaf data array.
    """

    nroots: int
    nleafspace: int
    local: np.ndarray          # (nleaves,) int64, positions in leaf space
    remote_rank: np.ndarray    # (nleaves,) int64
    remote_offset: np.ndarray  # (nleaves,) int64

    @property
    def nleaves(self) -> int:
        return int(self.local.shape[0])

    @staticmethod
    def make(
        nroots: int,
        local: Optional[Sequence[int]],
        remote: Sequence[Tuple[int, int]],
        nleafspace: Optional[int] = None,
    ) -> "RankGraph":
        remote = np.asarray(remote, dtype=np.int64).reshape(-1, 2)
        nleaves = remote.shape[0]
        if local is None:
            local_arr = np.arange(nleaves, dtype=np.int64)
        else:
            local_arr = np.asarray(local, dtype=np.int64)
        if local_arr.shape[0] != nleaves:
            raise ValueError(
                f"local has {local_arr.shape[0]} entries, remote has {nleaves}"
            )
        if nleafspace is None:
            nleafspace = int(local_arr.max()) + 1 if nleaves else 0
        if nleaves:
            if local_arr.min() < 0 or local_arr.max() >= nleafspace:
                raise ValueError("leaf index out of leaf space")
            if len(np.unique(local_arr)) != nleaves:
                raise ValueError("duplicate leaf positions in `local`")
            if remote[:, 1].min() < 0:
                raise ValueError("negative root offset")
        return RankGraph(
            nroots=int(nroots),
            nleafspace=int(nleafspace),
            local=local_arr,
            remote_rank=remote[:, 0].copy(),
            remote_offset=remote[:, 1].copy(),
        )


@dataclasses.dataclass(frozen=True)
class PairInfo:
    """Coalesced message between one (root rank, leaf rank) pair (paper §5.1).

    Index lists are in the *leaf rank's edge order* — the order edges appear
    in the leaf rank's ``RankGraph`` — which is the shared convention that
    lets sender-side packs line up with receiver-side unpacks without any
    runtime negotiation.
    """

    root_rank: int
    leaf_rank: int
    root_idx: np.ndarray   # (n,) root offsets on root_rank
    leaf_idx: np.ndarray   # (n,) leaf-space positions on leaf_rank
    edge_idx: np.ndarray   # (n,) edge ids in leaf_rank's RankGraph

    @property
    def count(self) -> int:
        return int(self.root_idx.shape[0])


class StarForest:
    """A distributed star forest over ``nranks`` ranks.

    The template object: build once (``set_graph`` per rank + ``setup()``),
    then instantiate many communications on it via
    :class:`repro_torch.core.backend.SFComm`.
    """

    def __init__(self, nranks: int):
        if nranks < 1:
            raise ValueError("nranks must be >= 1")
        self.nranks = int(nranks)
        self._graphs: List[Optional[RankGraph]] = [None] * self.nranks
        self._setup_done = False
        # setup products
        self.pairs: List[PairInfo] = []
        self._pair_by_key: Dict[Tuple[int, int], PairInfo] = {}
        self.root_ranks: List[List[int]] = []   # per leaf rank, self first
        self.leaf_ranks: List[List[int]] = []   # per root rank, self first
        self._degrees: List[np.ndarray] = []

    # ------------------------------------------------------------------ build
    def set_graph(
        self,
        rank: int,
        nroots: int,
        local: Optional[Sequence[int]],
        remote: Sequence[Tuple[int, int]],
        nleafspace: Optional[int] = None,
    ) -> "StarForest":
        if self._setup_done:
            raise RuntimeError("cannot set_graph after setup()")
        self._graphs[rank] = RankGraph.make(nroots, local, remote, nleafspace)
        return self

    @staticmethod
    def from_rank_graphs(graphs: Sequence[RankGraph]) -> "StarForest":
        sf = StarForest(len(graphs))
        sf._graphs = list(graphs)
        sf.setup()
        return sf

    def graph(self, rank: int) -> RankGraph:
        g = self._graphs[rank]
        if g is None:
            raise RuntimeError(f"rank {rank} graph not set")
        return g

    @property
    def graphs(self) -> List[RankGraph]:
        return [self.graph(r) for r in range(self.nranks)]

    def setup(self) -> "StarForest":
        """Derive the two-sided information (paper §5.1).

        Produces, per rank: (1) its root-rank list, (2) per root rank the
        leaf indices of edges to it, (3) its leaf-rank list, (4) per leaf
        rank the root indices requested — i.e. the four data structures of
        paper §5.1, with *self moved to the front* of both rank lists (the
        local/remote split of §5.2).
        """
        if self._setup_done:
            return self
        for r in range(self.nranks):
            g = self._graphs[r]
            if g is None:
                self._graphs[r] = RankGraph.make(0, None, np.zeros((0, 2)))
                continue
            if g.nleaves and g.remote_rank.max() >= self.nranks:
                raise ValueError("remote rank out of range")

        # Validate root offsets against owner nroots.
        for q in range(self.nranks):
            g = self.graph(q)
            for p in np.unique(g.remote_rank):
                sel = g.remote_rank == p
                if g.remote_offset[sel].max(initial=-1) >= self.graph(int(p)).nroots:
                    raise ValueError(
                        f"leaf on rank {q} addresses root offset beyond "
                        f"nroots on rank {int(p)}"
                    )

        pairs: Dict[Tuple[int, int], PairInfo] = {}
        for q in range(self.nranks):
            g = self.graph(q)
            if g.nleaves == 0:
                continue
            # Stable grouping by root rank, preserving edge order within group.
            order = np.argsort(g.remote_rank, kind="stable")
            rr = g.remote_rank[order]
            boundaries = np.flatnonzero(np.diff(rr)) + 1
            groups = np.split(order, boundaries)
            for grp in groups:
                p = int(g.remote_rank[grp[0]])
                pairs[(p, q)] = PairInfo(
                    root_rank=p,
                    leaf_rank=q,
                    root_idx=g.remote_offset[grp].copy(),
                    leaf_idx=g.local[grp].copy(),
                    edge_idx=grp.astype(np.int64),
                )

        self.pairs = [pairs[k] for k in sorted(pairs)]
        self._pair_by_key = {(pi.root_rank, pi.leaf_rank): pi for pi in self.pairs}

        def self_first(lst: List[int], me: int) -> List[int]:
            lst = sorted(lst)
            if me in lst:
                lst.remove(me)
                lst.insert(0, me)
            return lst

        self.root_ranks = [
            self_first([p for (p, q) in pairs if q == me], me)
            for me in range(self.nranks)
        ]
        self.leaf_ranks = [
            self_first([q for (p, q) in pairs if p == me], me)
            for me in range(self.nranks)
        ]

        # Root degrees (paper §3.2): number of leaves per root.
        self._degrees = []
        for p in range(self.nranks):
            deg = np.zeros(self.graph(p).nroots, dtype=np.int64)
            for q in self.leaf_ranks[p]:
                deg += np.bincount(self._pair_by_key[(p, q)].root_idx,
                                   minlength=deg.size)
            self._degrees.append(deg)

        self._setup_done = True
        return self

    # ------------------------------------------------------------ inspection
    def _require_setup(self) -> None:
        if not self._setup_done:
            raise RuntimeError("call setup() first")

    def pair(self, root_rank: int, leaf_rank: int) -> Optional[PairInfo]:
        self._require_setup()
        return self._pair_by_key.get((root_rank, leaf_rank))

    def degrees(self, rank: int) -> np.ndarray:
        """Degree of each root owned by ``rank`` (paper: SFComputeDegree)."""
        self._require_setup()
        return self._degrees[rank]

    @property
    def nroots_total(self) -> int:
        return sum(g.nroots for g in self.graphs)

    @property
    def nleafspace_total(self) -> int:
        return sum(g.nleafspace for g in self.graphs)

    @property
    def nedges_total(self) -> int:
        return sum(g.nleaves for g in self.graphs)

    def root_offsets(self) -> np.ndarray:
        """Global concatenation offsets of per-rank root spaces."""
        return ragged_offsets([g.nroots for g in self.graphs])

    def leaf_offsets(self) -> np.ndarray:
        """Global concatenation offsets of per-rank leaf spaces."""
        return ragged_offsets([g.nleafspace for g in self.graphs])

    def edges_global(self) -> np.ndarray:
        """All edges as (nedges, 2) [global_root_id, global_leaf_id], ordered
        by (leaf rank, edge index) — the deterministic order used for
        non-commutative reductions and fetch-and-op."""
        self._require_setup()
        ro, lo = self.root_offsets(), self.leaf_offsets()
        chunks = []
        for q in range(self.nranks):
            g = self.graph(q)
            if g.nleaves == 0:
                continue
            gr = ro[g.remote_rank] + g.remote_offset
            gl = lo[q] + g.local
            chunks.append(np.stack([gr, gl], axis=1))
        if not chunks:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(chunks, axis=0)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        s = "setup" if self._setup_done else "unset"
        return (
            f"StarForest(nranks={self.nranks}, roots={self.nroots_total}, "
            f"leaves={self.nedges_total}, state={s})"
        )
