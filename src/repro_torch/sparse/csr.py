"""Local sparse matrices: CSR structure (host/numpy) + ELL values (device).

PETSc stores each rank's diagonal/off-diagonal blocks as sequential CSR
matrices (paper Fig 3).  The numeric representation used on the device is
ELLPACK (rows padded to the max nnz/row, padding columns pointing at a
trailing zero of x), which the ELL SpMV kernel reads with one thread per
row; the CSR form remains the host-side structural format.  A numpy copy of
``repro.sparse.csr`` with ``to_ell`` vectorized (same arrays as the
reference's row loop).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["LocalCSR", "csr_from_coo", "csr_transpose"]


@dataclasses.dataclass
class LocalCSR:
    shape: Tuple[int, int]
    indptr: np.ndarray    # (m+1,)
    indices: np.ndarray   # (nnz,)
    data: np.ndarray      # (nnz,) — numpy master copy; device copies derived

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def toarray(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.data.dtype if self.nnz else np.float64)
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        np.add.at(out, (rows, self.indices[: rows.size]),
                  self.data[: rows.size])
        return out

    # ----------------------------------------------------------- ELL view
    def to_ell(self, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray, int]:
        """(data, cols, K): rows padded to K = max nnz/row; padding cols point
        at index n (caller appends a zero to x)."""
        m, n = self.shape
        counts = np.diff(self.indptr)
        K = max(int(counts.max(initial=0)), 1)
        data = np.zeros((m, K), dtype=dtype)
        cols = np.full((m, K), n, dtype=np.int32)
        rows = np.repeat(np.arange(m), counts)
        slot = np.arange(rows.size) - np.repeat(self.indptr[:-1], counts)
        pos = np.repeat(self.indptr[:-1], counts) + slot
        data[rows, slot] = self.data[pos]
        cols[rows, slot] = self.indices[pos]
        return data, cols, K


def csr_from_coo(m: int, n: int, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, *, sum_duplicates: bool = True) -> LocalCSR:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.size:
        key_same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        groups = np.concatenate([[0], np.cumsum(~key_same)])
        ng = int(groups[-1]) + 1
        r2 = np.zeros(ng, dtype=np.int64)
        c2 = np.zeros(ng, dtype=np.int64)
        v2 = np.zeros(ng, dtype=vals.dtype)
        np.add.at(v2, groups, vals)
        r2[groups] = rows
        c2[groups] = cols
        rows, cols, vals = r2, c2, v2
    indptr = np.zeros(m + 1, dtype=np.int64)
    indptr[1:] = np.bincount(rows, minlength=m)
    np.cumsum(indptr, out=indptr)
    return LocalCSR((m, n), indptr, cols, vals)


def csr_transpose(a: LocalCSR) -> LocalCSR:
    m, n = a.shape
    rows = np.repeat(np.arange(m), np.diff(a.indptr))
    return csr_from_coo(n, m, a.indices, rows, a.data, sum_duplicates=False)
