"""Pure-numpy edge-semantics oracle for every SF operation (the port of
``repro/core/simulate.py``, on the port's graph and op table).

This module executes the *definition* of each operation, edge by edge, in the
deterministic (leaf rank, edge index) order.  It is the ground truth the
port's backends (:mod:`repro_torch.core.ops`, :mod:`repro_torch.core.backend`)
are tested against wherever a reference kernel does not run, and doubles as
the oracle for the pack/unpack kernels' end-to-end behaviour.

Data layout: *global concatenated* arrays — ``rootdata`` has shape
``(sf.nroots_total, *unit)`` (per-rank root spaces concatenated in rank
order) and ``leafdata`` has shape ``(sf.nleafspace_total, *unit)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .graph import StarForest
from .mpiops import get_op

__all__ = [
    "bcast_ref",
    "reduce_ref",
    "fetch_and_op_ref",
    "multi_root_layout",
    "gather_ref",
    "scatter_ref",
]


def _edges(sf: StarForest) -> np.ndarray:
    return sf.edges_global()


def bcast_ref(sf: StarForest, rootdata: np.ndarray, leafdata: np.ndarray,
              op="replace") -> np.ndarray:
    """leafdata[leaf] = op(leafdata[leaf], rootdata[root]) for every edge."""
    op = get_op(op)
    out = np.array(leafdata, copy=True)
    for gr, gl in _edges(sf):
        out[gl] = op.np_combine(out[gl], rootdata[gr])
    return out


def reduce_ref(sf: StarForest, leafdata: np.ndarray, rootdata: np.ndarray,
               op="sum") -> np.ndarray:
    """rootdata[root] = op(rootdata[root], leafdata[leaf]) for every edge,
    applied in deterministic (leaf rank, edge index) order."""
    op = get_op(op)
    out = np.array(rootdata, copy=True)
    for gr, gl in _edges(sf):
        out[gr] = op.np_combine(out[gr], leafdata[gl])
    return out


def fetch_and_op_ref(
    sf: StarForest, rootdata: np.ndarray, leafdata: np.ndarray, op="sum"
) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §3.2 FetchAndOp: for each edge (in deterministic order), the leaf
    fetches the root's current value into ``leafupdate`` *before* the root is
    updated with the leaf's value.  Returns (new rootdata, leafupdate)."""
    op = get_op(op)
    root_out = np.array(rootdata, copy=True)
    leafupdate = np.array(leafdata, copy=True)  # holes keep leafdata values
    for gr, gl in _edges(sf):
        leafupdate[gl] = root_out[gr]
        root_out[gr] = op.np_combine(root_out[gr], leafdata[gl])
    return root_out, leafupdate


def multi_root_layout(sf: StarForest) -> Tuple[np.ndarray, np.ndarray]:
    """Slot assignment for the multi-SF (paper §3.2).

    Returns ``(nmulti_per_rank, slot_of_edge)`` where ``slot_of_edge[e]`` is
    the *global* multi-root slot of edge ``e`` (edges in deterministic
    order).  On each root rank, multi-roots are laid out grouped by original
    root in root-index order; within a root, slots follow the deterministic
    edge order — exactly the offsets the paper obtains via fetch-and-add on a
    degree-initialized SF.
    """
    edges = _edges(sf)
    ro = sf.root_offsets()
    nranks = sf.nranks
    deg = [sf.degrees(p) for p in range(nranks)]
    nmulti = np.array([int(d.sum()) for d in deg], dtype=np.int64)
    multi_off = np.zeros(nranks + 1, dtype=np.int64)
    np.cumsum(nmulti, out=multi_off[1:])
    # Base slot of each original root (global numbering of multi space).
    base = []
    for p in range(nranks):
        b = np.zeros(len(deg[p]) + 1, dtype=np.int64)
        np.cumsum(deg[p], out=b[1:])
        base.append(multi_off[p] + b[:-1])
    counter = [np.zeros(len(d), dtype=np.int64) for d in deg]
    slot = np.zeros(edges.shape[0], dtype=np.int64)
    for e, (gr, _gl) in enumerate(edges):
        p = int(np.searchsorted(ro, gr, side="right") - 1)
        o = int(gr - ro[p])
        slot[e] = base[p][o] + counter[p][o]
        counter[p][o] += 1
    return nmulti, slot


def gather_ref(sf: StarForest, leafdata: np.ndarray) -> np.ndarray:
    """SFGather: collect each leaf's value into its multi-root slot."""
    edges = _edges(sf)
    nmulti, slot = multi_root_layout(sf)
    unit = leafdata.shape[1:]
    out = np.zeros((int(nmulti.sum()),) + unit, dtype=leafdata.dtype)
    for e, (_gr, gl) in enumerate(edges):
        out[slot[e]] = leafdata[gl]
    return out


def scatter_ref(sf: StarForest, multirootdata: np.ndarray,
                leafdata: Optional[np.ndarray] = None) -> np.ndarray:
    """SFScatter: inverse of gather — each leaf reads its multi-root slot."""
    edges = _edges(sf)
    _nmulti, slot = multi_root_layout(sf)
    if leafdata is None:
        out = np.zeros((sf.nleafspace_total,) + multirootdata.shape[1:],
                       dtype=multirootdata.dtype)
    else:
        out = np.array(leafdata, copy=True)
    for e, (_gr, gl) in enumerate(edges):
        out[gl] = multirootdata[slot[e]]
    return out
