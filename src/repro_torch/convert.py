"""Carry reference state across from numpy arrays only.

The port never imports the JAX package; a caller that has reference
objects reads their arrays out (``repro.core.graph.RankGraph`` fields,
``repro.sparse.parmat.ParCSR`` blocks) and hands them over here as plain
dicts and tuples.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .core.graph import RankGraph, StarForest
from .sparse.csr import LocalCSR
from .sparse.parmat import ParCSR

__all__ = ["star_forest_from_arrays", "parcsr_from_arrays"]


def star_forest_from_arrays(nranks: int,
                            graphs: Sequence[Dict[str, object]]
                            ) -> StarForest:
    """A set-up StarForest from one dict per rank with the fields of
    ``RankGraph``: ``nroots``, ``nleafspace``, ``local``, ``remote_rank``,
    ``remote_offset``."""
    if len(graphs) != nranks:
        raise ValueError(f"{len(graphs)} rank graphs for {nranks} ranks")
    return StarForest.from_rank_graphs([
        RankGraph(nroots=int(g["nroots"]), nleafspace=int(g["nleafspace"]),
                  local=np.asarray(g["local"], dtype=np.int64),
                  remote_rank=np.asarray(g["remote_rank"], dtype=np.int64),
                  remote_offset=np.asarray(g["remote_offset"],
                                           dtype=np.int64))
        for g in graphs])


Block = Tuple[Tuple[int, int], np.ndarray, np.ndarray, np.ndarray]


def parcsr_from_arrays(nranks: int, row_offsets, col_offsets,
                       diag: List[Block], offd: List[Block],
                       garray: List[np.ndarray], dtype=np.float32,
                       device=None) -> ParCSR:
    """A ParCSR from per-rank ``(shape, indptr, indices, data)`` blocks."""
    def block(b: Block) -> LocalCSR:
        shape, indptr, indices, data = b
        return LocalCSR((int(shape[0]), int(shape[1])),
                        np.asarray(indptr, dtype=np.int64),
                        np.asarray(indices, dtype=np.int64),
                        np.asarray(data))
    return ParCSR(nranks, np.asarray(row_offsets), np.asarray(col_offsets),
                  [block(b) for b in diag], [block(b) for b in offd],
                  [np.asarray(g, dtype=np.int64) for g in garray],
                  dtype=dtype, device=device)
