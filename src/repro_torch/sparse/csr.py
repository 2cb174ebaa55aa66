"""Local sparse matrices: CSR structure (host/numpy) + ELL values (device).

PETSc stores each rank's diagonal/off-diagonal blocks as sequential CSR
matrices (paper Fig 3).  The numeric representation used on the device is
ELLPACK (rows padded to the max nnz/row, padding columns pointing at a
trailing zero of x), which the ELL SpMV kernel reads with one thread per
row; the CSR form remains the host-side structural format.  A numpy copy of
``repro.sparse.csr`` with ``to_ell`` and ``spgemm`` vectorized (the same
arrays as the reference's loops; ``spgemm`` adds each output entry's
products in the reference's order).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.graph import ragged_arange

__all__ = ["LocalCSR", "csr_from_coo", "csr_transpose", "spgemm"]

# products expanded at once by spgemm: bounds its working memory (~50 bytes
# a product) whatever the operands' sizes
SPGEMM_CHUNK = 1 << 22


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


def _ordered_sums(key: np.ndarray, vals: np.ndarray):
    """``(distinct keys ascending, sums)`` where each key's sum is
    ``((0 + v_0) + v_1) + ...`` over its ``vals`` in their given order, in
    float64: the i-th terms of all keys are added in pass i, one
    duplicate-free scatter per pass."""
    order = np.argsort(key, kind="stable")
    ks = key[order]
    new = np.ones(ks.size, dtype=bool)
    new[1:] = ks[1:] != ks[:-1]
    starts = np.flatnonzero(new)
    grp = np.cumsum(new) - 1
    nth = np.arange(ks.size) - starts[grp]
    if ks.size and nth.max() < 1 << 16:
        nth = nth.astype(np.uint16)      # a radix sort orders the passes
    by_pass = np.argsort(nth, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(nth))])
    vs = vals[order]
    out = np.zeros(starts.size, dtype=np.float64)
    for p in range(bounds.size - 1):
        sel = by_pass[bounds[p]: bounds[p + 1]]
        out[grp[sel]] += vs[sel]
    return ks[starts], out


def spgemm(a: LocalCSR, b: LocalCSR) -> LocalCSR:
    """CSR x CSR on the host — the local product of paper §6.4 step 2.

    The reference keeps a dict per row and adds, for each output entry
    ``(i, c)``, the products ``a[i, k] * b[k, c]`` in the order of ``a``'s
    row entries.  Here the products of a chunk of rows are expanded at once
    (numpy multiplies them in the operands' common dtype, as the
    reference's scalars do) and each entry's products are summed in float64
    in that same order.  The result has the reference's indptr and indices
    (an entry whose products cancel stays, as a 0), and its values within
    float64 rounding of the reference's."""
    am, ak = a.shape
    bk, bn = b.shape
    if ak != bk:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    blen = np.diff(b.indptr)
    per_entry = blen[a.indices]
    before_row = np.concatenate([[0], np.cumsum(per_entry)])[a.indptr]
    cuts = [0]
    while cuts[-1] < am:   # row chunks of <= SPGEMM_CHUNK products (or 1 row)
        nxt = int(np.searchsorted(before_row, before_row[cuts[-1]]
                                  + SPGEMM_CHUNK, side="right")) - 1
        cuts.append(min(max(nxt, cuts[-1] + 1), am))
    rows_l, cols_l, vals_l = [], [], []
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        j0, j1 = int(a.indptr[r0]), int(a.indptr[r1])
        jj, k = ragged_arange(per_entry[j0:j1])
        jj += j0
        bpos = b.indptr[a.indices[jj]] + k
        row = np.repeat(np.arange(r0, r1),
                        np.diff(before_row[r0: r1 + 1]))
        key = (row - r0) * bn + b.indices[bpos]
        ukey, sums = _ordered_sums(key, a.data[jj] * b.data[bpos])
        vals_l.append(sums)
        rows_l.append(ukey // bn + r0)
        cols_l.append(ukey % bn)
    cat = lambda parts, dt: np.concatenate(parts) if parts \
        else np.zeros(0, dt)
    return csr_from_coo(am, bn, cat(rows_l, np.int64), cat(cols_l, np.int64),
                        cat(vals_l, np.float64))
