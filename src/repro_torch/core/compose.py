"""SF composition and embedding (paper §2, "creating new SFs from existing
ones") — the port of ``repro/core/compose.py``.

``compose(A, B)``         — A's leaves overlap B's roots; result AB has A's
                            roots and B's leaves (data redistribution chains).
``compose_inverse(A, B)`` — A's leaves overlap B's *leaves*; B's roots have
                            degree <= 1; result has A's roots and B's roots
                            as leaves.
``embed_roots / embed_leaves`` — drop all edges except those touching the
                            selected roots/leaves, *without* remapping
                            indices, so the embedded SF communicates on the
                            original data buffers (field segregation /
                            subgraph extraction).
``make_multi_sf``         — the multi-SF of paper §3.2 (one root slot per
                            edge).

These are host-side graph algebra on the template (numpy), matching how
PETSc builds them once at setup time; the distributed construction the paper
describes (SFBcast of root addresses over B) is a gather when the template
is globally known.  The reference walks every edge in Python; here each
function works on whole edge arrays, and returns the SF the reference
returns: the same per-rank ``local``, ``remote_rank``, ``remote_offset`` and
``nleafspace``, edge for edge in the same order (``tests/test_torch_compose.py``
holds them equal).  At the card's sizes that is millions of edges (the 129³
multigrid transfer's ``embed_leaves`` has ~7.1 M slots).

Consumers: :func:`repro_torch.meshdist.plex.grow_overlap` (``compose``),
:class:`repro_torch.solvers.multigrid.Transfer` (``embed_leaves``) and
:class:`repro_torch.sparse.parmat.MatAssembler` (``compose_inverse``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .graph import StarForest, ragged_offsets

__all__ = ["compose", "compose_inverse", "embed_roots", "embed_leaves",
           "identity_sf", "make_multi_sf"]


def identity_sf(sizes: Sequence[int]) -> StarForest:
    """SF whose rank-r leaves connect 1:1 to rank-r roots (nroots=sizes[r])."""
    sf = StarForest(len(sizes))
    for r, n in enumerate(sizes):
        remote = np.stack([np.full(n, r, dtype=np.int64),
                           np.arange(n, dtype=np.int64)], axis=1)
        sf.set_graph(r, n, None, remote, nleafspace=n)
    return sf.setup()


def _leaf_root_addr(sf: StarForest) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """``(rank, offset, leaf_offsets)``: for every position of the global
    (rank-concatenated) leaf space, the address of its root, or -1 for
    holes — the paper's 'bcast A.remote over B' payload."""
    lo = sf.leaf_offsets()
    rank = np.full(int(lo[-1]), -1, dtype=np.int64)
    off = np.full(int(lo[-1]), -1, dtype=np.int64)
    for m in range(sf.nranks):
        g = sf.graph(m)
        rank[lo[m] + g.local] = g.remote_rank
        off[lo[m] + g.local] = g.remote_offset
    return rank, off, lo


def _same_comm(A: StarForest, B: StarForest) -> None:
    A.setup()
    B.setup()
    if A.nranks != B.nranks:
        raise ValueError("A and B must live on the same communicator")


def compose(A: StarForest, B: StarForest) -> StarForest:
    """Paper: PetscSFCompose.  Requires A's leaf space on each rank to cover
    B's root space (B roots index into A's leaf space)."""
    _same_comm(A, B)
    R = A.nranks
    a_rank, a_off, a_lo = _leaf_root_addr(A)
    nls = np.asarray([A.graph(m).nleafspace for m in range(R)], np.int64)
    sf = StarForest(R)
    for q in range(R):
        gB = B.graph(q)
        m, o = gB.remote_rank, gB.remote_offset   # o: position in A's leaves
        if (o >= nls[m]).any():
            raise ValueError("B root offset outside A leaf space")
        pos = a_lo[m] + o
        keep = a_rank[pos] >= 0            # an A-hole: no bridge, no edge
        sf.set_graph(q, A.graph(q).nroots, gB.local[keep],
                     np.stack([a_rank[pos[keep]], a_off[pos[keep]]], axis=1),
                     nleafspace=gB.nleafspace)
    return sf.setup()


def compose_inverse(A: StarForest, B: StarForest) -> StarForest:
    """Paper: PetscSFComposeInverse.  A and B share their leaf space; every B
    root must have degree <= 1.  Result: A's roots -> B's roots (as leaves)."""
    _same_comm(A, B)
    R = A.nranks
    for r in range(R):
        if (B.degrees(r) > 1).any():
            raise ValueError("compose_inverse requires B root degree <= 1")
    a_rank, a_off, a_lo = _leaf_root_addr(A)
    # For each B edge (root (m',o') -> leaf (m,pos)): if A has a leaf at
    # (m,pos) with root (p,ro), then AB edge (p,ro) -> leaf (m',o').
    parts = []
    for m in range(R):
        gB = B.graph(m)
        sel = np.flatnonzero(gB.local < A.graph(m).nleafspace)
        pos = a_lo[m] + gB.local[sel]
        bridged = a_rank[pos] >= 0
        sel, pos = sel[bridged], pos[bridged]
        parts.append(np.stack([gB.remote_rank[sel], gB.remote_offset[sel],
                               a_rank[pos], a_off[pos]], axis=1))
    edges = np.concatenate(parts) if parts else np.zeros((0, 4), np.int64)
    sf = StarForest(R)
    for r in range(R):
        e = edges[edges[:, 0] == r]
        # B roots have degree <= 1: the leaf offsets o' are distinct, so
        # ordering by them is the reference's sort of (o', p, ro) tuples
        e = e[np.argsort(e[:, 1], kind="stable")]
        sf.set_graph(r, A.graph(r).nroots, e[:, 1], e[:, 2:4],
                     nleafspace=B.graph(r).nroots)
    return sf.setup()


def embed_roots(sf: StarForest, selected: Sequence[np.ndarray]) -> StarForest:
    """Paper: PetscSFCreateEmbeddedRootSF.  ``selected[r]`` lists retained
    root offsets on rank r.  Indices are NOT remapped."""
    sf.setup()
    ro = sf.root_offsets()
    keep = np.zeros(int(ro[-1]), dtype=bool)
    for r in range(sf.nranks):
        keep[ro[r] + np.asarray(selected[r], dtype=np.int64)] = True
    out = StarForest(sf.nranks)
    for q in range(sf.nranks):
        g = sf.graph(q)
        mask = keep[ro[g.remote_rank] + g.remote_offset]
        out.set_graph(q, g.nroots, g.local[mask],
                      np.stack([g.remote_rank[mask], g.remote_offset[mask]],
                               axis=1), nleafspace=g.nleafspace)
    return out.setup()


def embed_leaves(sf: StarForest, selected: Sequence[np.ndarray]) -> StarForest:
    """Paper: PetscSFCreateEmbeddedLeafSF.  ``selected[r]`` lists retained
    leaf-space positions on rank r."""
    sf.setup()
    out = StarForest(sf.nranks)
    for q in range(sf.nranks):
        g = sf.graph(q)
        mask = np.isin(g.local, np.asarray(selected[q], dtype=np.int64))
        out.set_graph(q, g.nroots, g.local[mask],
                      np.stack([g.remote_rank[mask], g.remote_offset[mask]],
                               axis=1), nleafspace=g.nleafspace)
    return out.setup()


def make_multi_sf(sf: StarForest) -> StarForest:
    """Paper §3.2: the multi-SF of ``sf`` — roots split into one slot per
    edge (degree many), each leaf connected to its own slot.  Slots follow
    the fetch-and-add offset assignment the paper describes: within a root,
    in the deterministic (leaf rank, edge index) order."""
    sf.setup()
    R = sf.nranks
    deg = [sf.degrees(p) for p in range(R)]
    # per-root base slot, local to the root's rank
    base = np.concatenate([ragged_offsets(d)[:-1] for d in deg])
    gr = sf.edges_global()[:, 0]
    # each edge's rank among its root's edges, in edge order
    order = np.argsort(gr, kind="stable")
    first = np.searchsorted(gr[order], gr[order], side="left")
    nth = np.empty_like(gr)
    nth[order] = np.arange(gr.size) - first
    slot = base[gr] + nth
    eo = ragged_offsets([sf.graph(q).nleaves for q in range(R)])
    multi = StarForest(R)
    for q in range(R):
        g = sf.graph(q)
        multi.set_graph(q, int(deg[q].sum()), g.local.copy(),
                        np.stack([g.remote_rank, slot[eo[q]: eo[q + 1]]],
                                 axis=1), nleafspace=g.nleafspace)
    return multi.setup()
