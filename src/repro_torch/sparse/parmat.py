"""Distributed sparse matrices on star forests (paper §4.1).

A ``ParCSR`` is PETSc's MPIAIJ layout (paper Fig 3): rows are block-
distributed; on each rank the local rows split into the *diagonal* block A
(columns owned by this rank) and the *off-diagonal* block B whose columns are
compacted through ``garray`` (the global ids of the nonzero off-diagonal
columns).  The ghost vector ``lvec`` holds the remote x entries B needs, and
a star forest — roots: owned x entries, leaves: lvec entries (contiguous!) —
provides all communication:

  SpMV     y = A x_local (+overlap) then  y += B lvec   after SFBcast
  SpMV^T   lvec = B^T x ; y = A^T x ; SFReduce(lvec -> y, SUM)

Also here (paper §6.4): ghost-row fetching through a section-derived
dof-SF (``fetch_rows``), SpMM and the Galerkin product (``spmm``,
``ptap``), and parallel assembly — the stash flush as ONE SF reduce over a
``compose_inverse``-built SF (``Sparsity``, ``MatAssembler``) and the
fetch-and-add COO path (``assemble_coo(method="fetch")``).

The port of ``repro.sparse.parmat``.  All ranks' blocks live on one device
(the card unless ``device="cpu"``); the ELL values and column lists are
uploaded once, at construction.  Setup algebra (the local products, the
sparsity pattern, the SF graphs) is numpy, as in the reference; every
exchange runs through ``SFComm`` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import SFComm, StarForest, compose_inverse, ragged_offsets
from ..core.device import check_payload, resolve_device
from ..kernels import ops as kops
from ..kernels._index import device_index
from ..meshdist.section import Section, apply_section
from .csr import LocalCSR, csr_from_coo, csr_transpose, spgemm

__all__ = ["ParCSR", "Sparsity", "MatAssembler", "assemble_coo"]


def _owner_of(offsets: np.ndarray, ids: np.ndarray) -> np.ndarray:
    return np.searchsorted(offsets, ids, side="right") - 1


@dataclasses.dataclass
class _EllBlock:
    data: torch.Tensor    # (m, K)
    cols: torch.Tensor    # (m, K) int32, padded -> n (trailing zero of x)
    cols64: torch.Tensor  # the same as int64, for the gather of the einsum
    n: int

    def apply(self, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        """y = block @ x.  ``x`` may carry trailing RHS-column dims
        ``(n, *unit)``; the contraction broadcasts over them (the ELL
        kernel is single-vector, so multi-RHS takes the einsum path)."""
        xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
        if use_kernel and x.dim() == 1:
            return kops.spmv_ell(self.data, self.cols, xz)
        return torch.einsum("nk,nk...->n...", self.data, xz[self.cols64])


class ParCSR:
    """Row-distributed sparse matrix with SF-based ghost communication."""

    def __init__(self, nranks: int, row_offsets: np.ndarray,
                 col_offsets: np.ndarray, diag: List[LocalCSR],
                 offd: List[LocalCSR], garray: List[np.ndarray],
                 dtype=np.float32, backend=None, device=None):
        self.nranks = nranks
        self.row_offsets = np.asarray(row_offsets, dtype=np.int64)
        self.col_offsets = np.asarray(col_offsets, dtype=np.int64)
        self.diag = diag
        self.offd = offd
        self.garray = garray
        self.dtype = dtype
        self.device = resolve_device(device)

        # ---- the SpMV star forest (paper §4.1): roots = owned x entries,
        # leaves = lvec entries, contiguous on each rank.
        sf = StarForest(nranks)
        for r in range(nranks):
            ncols_local = int(self.col_offsets[r + 1] - self.col_offsets[r])
            g = self.garray[r]
            owner = _owner_of(self.col_offsets, g)
            remote = np.stack([owner, g - self.col_offsets[owner]], axis=1) \
                if g.size else np.zeros((0, 2), np.int64)
            sf.set_graph(r, ncols_local, None, remote,
                         nleafspace=max(int(g.size), 1))
        self.sf = sf.setup()
        # backend=None -> select_backend: the measured priors table where a
        # compatible one exists, then the static rule ("cuda" for the
        # general pattern on a CUDA device)
        self.comm = SFComm(self.sf, backend=backend, device=self.device)
        self.lvec_offsets = ragged_offsets(
            [self.sf.graph(r).nleafspace for r in range(nranks)])

        self._diag_ell = [self._ell(c) for c in self.diag]
        self._offd_ell = [self._ell(c) for c in self.offd]
        self._diag_t_ell = [self._ell(csr_transpose(c)) for c in self.diag]
        self._offd_t_ell = [self._ell(csr_transpose(c)) for c in self.offd]

    def _ell(self, c: LocalCSR) -> _EllBlock:
        data, cols, _ = c.to_ell(dtype=self.dtype)
        d = self.device
        cols_t = torch.as_tensor(cols, device=d)
        device_index(cols_t, d)       # bounds checked once, here
        return _EllBlock(torch.as_tensor(data, device=d), cols_t,
                         cols_t.long(), c.shape[1])

    # ------------------------------------------------------------ factory
    @staticmethod
    def from_global_coo(nranks: int, m: int, n: int, rows: np.ndarray,
                        cols: np.ndarray, vals: np.ndarray,
                        row_offsets: Optional[np.ndarray] = None,
                        col_offsets: Optional[np.ndarray] = None,
                        dtype=np.float32, backend=None,
                        device=None) -> "ParCSR":
        device = resolve_device(device)
        if row_offsets is None:
            row_offsets = np.linspace(0, m, nranks + 1).astype(np.int64)
        if col_offsets is None:
            col_offsets = np.linspace(0, n, nranks + 1).astype(np.int64)
        diag, offd, garray = [], [], []
        rows = np.asarray(rows); cols = np.asarray(cols); vals = np.asarray(vals)
        for r in range(nranks):
            r0, r1 = row_offsets[r], row_offsets[r + 1]
            c0, c1 = col_offsets[r], col_offsets[r + 1]
            sel = (rows >= r0) & (rows < r1)
            rr, cc, vv = rows[sel] - r0, cols[sel], vals[sel]
            on = (cc >= c0) & (cc < c1)
            diag.append(csr_from_coo(int(r1 - r0), int(c1 - c0),
                                     rr[on], cc[on] - c0, vv[on]))
            goff = np.unique(cc[~on])
            offd.append(csr_from_coo(int(r1 - r0), max(goff.size, 1),
                                     rr[~on],
                                     np.searchsorted(goff, cc[~on]),
                                     vv[~on]))
            garray.append(goff.astype(np.int64))
        return ParCSR(nranks, row_offsets, col_offsets, diag, offd, garray,
                      dtype=dtype, backend=backend, device=device)

    @staticmethod
    def from_dmda_stencil(da, coeffs: Optional[Sequence[float]] = None,
                          dtype=np.float32, backend=None,
                          device=None) -> "ParCSR":
        """Stencil operator on a :class:`repro_torch.meshdist.DMDA` grid.

        One matrix row per grid cell (DMDA *global* ordering, so the row/col
        distribution is exactly the DMDA's owned decomposition and the SpMV
        ghost SF reproduces the DMDA halo).  ``coeffs`` aligns with
        ``da.stencil_offsets()`` (center first); default is the
        row-sum-zero Laplacian: +deg at the center, -1 per neighbor.
        Off-domain neighbors of non-periodic boundaries are dropped
        (homogeneous Dirichlet).  Built with numpy, as the reference does.
        """
        offs = da.stencil_offsets()
        if coeffs is None:
            coeffs = np.concatenate([[float(offs.shape[0] - 1)],
                                     -np.ones(offs.shape[0] - 1)])
        coeffs = np.asarray(coeffs, dtype=np.float64)
        if coeffs.shape[0] != offs.shape[0]:
            raise ValueError(f"{coeffs.shape[0]} coeffs for "
                             f"{offs.shape[0]} stencil offsets")
        rows_l, cols_l, vals_l = [], [], []
        for r in range(da.nranks):
            nat = da.box_coords(da.owned_box(r))
            row = da.owned_offsets[r] + np.arange(nat.shape[0])
            for o, c in zip(offs, coeffs):
                nb, valid = da.wrap_coords(nat + o)
                if not valid.any():
                    continue
                rows_l.append(row[valid])
                cols_l.append(da.natural_to_global(nb[valid]))
                vals_l.append(np.full(int(valid.sum()), float(c)))
        n = da.nglobal
        return ParCSR.from_global_coo(
            da.nranks, n, n,
            np.concatenate(rows_l), np.concatenate(cols_l),
            np.concatenate(vals_l),
            row_offsets=da.owned_offsets, col_offsets=da.owned_offsets,
            dtype=dtype, backend=backend, device=device)

    @property
    def shape(self) -> Tuple[int, int]:
        return int(self.row_offsets[-1]), int(self.col_offsets[-1])

    def diagonal(self) -> np.ndarray:
        """Main-diagonal entries (MatGetDiagonal) in float64 — purely local:
        entry (i, i) always lives in the owner's diagonal block when row and
        column distributions agree (square MPIAIJ layout)."""
        m, _ = self.shape
        out = np.zeros(m, dtype=np.float64)
        for r in range(self.nranks):
            r0 = int(self.row_offsets[r])
            c0 = int(self.col_offsets[r])
            A = self.diag[r]
            rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
            hit = A.indices == rows + (r0 - c0)
            out[r0: r0 + A.shape[0]] += np.bincount(
                rows[hit], weights=A.data[hit].astype(np.float64),
                minlength=A.shape[0])
        return out

    def toarray(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n))
        for r in range(self.nranks):
            r0 = int(self.row_offsets[r]); c0 = int(self.col_offsets[r])
            out[r0: int(self.row_offsets[r + 1]),
                c0: int(self.col_offsets[r + 1])] += self.diag[r].toarray()
            B = self.offd[r].toarray()
            for j, g in enumerate(self.garray[r]):
                out[r0: int(self.row_offsets[r + 1]), int(g)] += B[:, j]
        return out

    # ------------------------------------------------------------- SpMV
    def spmv(self, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        """y = M x with communication/compute overlap — the paper's listing:

            PetscSFBcastBegin(sf, x, lvec, MPI_REPLACE);
            y = A*x;                       // local, overlapped
            PetscSFBcastEnd(sf, x, lvec, MPI_REPLACE);
            y += B*lvec;

        ``x`` may be ``(n,)`` or multi-RHS ``(n, k)``: the k ghost columns
        travel as ONE bcast of unit ``(k,)``.  ``use_kernel`` runs the ELL
        kernel for single vectors.
        """
        x = check_payload(x, self.device, "x")
        pend = self.comm.bcast_begin(x, "replace")
        y_parts = []
        for r in range(self.nranks):
            c0, c1 = int(self.col_offsets[r]), int(self.col_offsets[r + 1])
            y_parts.append(self._diag_ell[r].apply(x[c0:c1], use_kernel))
        y = torch.cat(y_parts)
        lvec = pend.end(x.new_zeros((self.sf.nleafspace_total,)
                                    + tuple(x.shape[1:])))
        y2 = []
        for r in range(self.nranks):
            l0, l1 = int(self.lvec_offsets[r]), int(self.lvec_offsets[r + 1])
            y2.append(self._offd_ell[r].apply(lvec[l0:l1], use_kernel))
        return y + torch.cat(y2)

    def spmv_multi(self, X: torch.Tensor, use_kernel: bool = False
                   ) -> torch.Tensor:
        """Multi-RHS SpMV ``Y = M X`` for ``X`` of shape ``(n, k)``: all k
        columns' halos move through one fused ghost exchange."""
        X = check_payload(X, self.device, "X")
        if X.dim() != 2:
            raise ValueError(f"spmv_multi expects (n, k), got "
                             f"{tuple(X.shape)}")
        return self.spmv(X, use_kernel)

    def spmv_transpose(self, x: torch.Tensor, use_kernel: bool = False
                       ) -> torch.Tensor:
        """y = M^T x:  y = A^T x ; lvec = B^T x ; SFReduce(lvec -> y, SUM)."""
        x = check_payload(x, self.device, "x")
        y_parts, l_parts = [], []
        for r in range(self.nranks):
            r0, r1 = int(self.row_offsets[r]), int(self.row_offsets[r + 1])
            y_parts.append(self._diag_t_ell[r].apply(x[r0:r1], use_kernel))
            l_parts.append(self._offd_t_ell[r].apply(x[r0:r1], use_kernel))
        y = torch.cat(y_parts)
        lvec_parts = []
        for r in range(self.nranks):
            nls = self.sf.graph(r).nleafspace
            lp = l_parts[r]
            if lp.shape[0] < nls:   # offd block may be the 1-col placeholder
                lp = torch.cat([lp, lp.new_zeros((nls - lp.shape[0],))])
            lvec_parts.append(lp[:nls])
        lvec = torch.cat(lvec_parts)
        return self.comm.reduce(lvec, y, "sum")

    # ------------------------------------------------- ghost-row fetching
    def _row_sf(self, wanted: List[np.ndarray],
                row_offsets: Optional[np.ndarray] = None) -> StarForest:
        """SF whose roots are matrix rows and leaves the requested rows."""
        ro = self.row_offsets if row_offsets is None else row_offsets
        sf = StarForest(self.nranks)
        for r in range(self.nranks):
            w = np.asarray(wanted[r], dtype=np.int64)
            owner = _owner_of(ro, w)
            remote = np.stack([owner, w - ro[owner]], axis=1) if w.size \
                else np.zeros((0, 2), np.int64)
            nroots = int(ro[r + 1] - ro[r])
            sf.set_graph(r, nroots, None, remote, nleafspace=max(w.size, 1))
        return sf.setup()

    def fetch_rows(self, wanted: List[np.ndarray]
                   ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Fetch full rows (global columns) of self for each rank's ``wanted``
        global row list.  Rows are communicated through a dof-SF derived by
        applying the nnz-per-row Section to the row SF (paper §4.2 style);
        the column ids and the values (cast to float32 first, as the
        reference does) move in one bcast each on the device.  Returns per
        rank (indptr, cols, vals) of the fetched rows."""
        R = self.nranks
        row_sf = self._row_sf(wanted)
        merged = [_merged_rows(self, r) for r in range(R)]
        sections = [Section.from_sizes(np.diff(m.indptr)) for m in merged]
        dof_sf = apply_section(row_sf, sections, device=self.device)
        dops = SFComm(dof_sf, device=self.device)
        nls = dof_sf.nleafspace_total
        dev = self.device

        def bcast(comm, root, n, dtype):
            return comm.bcast(torch.as_tensor(root, dtype=dtype, device=dev),
                              torch.zeros(n, dtype=dtype, device=dev),
                              "replace").cpu().numpy()
        leaf_cols = bcast(dops, np.concatenate([m.indices for m in merged]),
                          nls, torch.int64)
        leaf_vals = bcast(dops, np.concatenate([m.data for m in merged])
                          .astype(np.float32), nls, torch.float32)
        # also bcast row sizes over the row SF to rebuild indptrs
        lsizes = bcast(SFComm(row_sf, device=dev),
                       np.concatenate([sec.sizes for sec in sections]),
                       row_sf.nleafspace_total, torch.int64)
        out = []
        lo = row_sf.leaf_offsets()
        dlo = dof_sf.leaf_offsets()
        for r in range(R):
            indptr = ragged_offsets(lsizes[lo[r]: lo[r] + len(wanted[r])])
            c = leaf_cols[dlo[r]: dlo[r + 1]][: indptr[-1]]
            v = leaf_vals[dlo[r]: dlo[r + 1]][: indptr[-1]]
            out.append((indptr, c, v))
        return out

    # ------------------------------------------------------------- SpMM
    def spmm(self, P: "ParCSR") -> "ParCSR":
        """AP = self @ P (paper §6.4): fetch ghost rows of P named by garray,
        then purely local products — step 3 assembly is row-local for AP."""
        fetched = P.fetch_rows(self.garray)   # step 1: ghost rows of P
        rows_l, cols_l, vals_l = [], [], []
        for r in range(self.nranks):
            indptr, cols, vals = fetched[r]
            Pf = csr_from_coo(len(self.garray[r]), P.shape[1],
                              _row_ids(indptr), cols, vals)
            APr = spgemm(self.diag[r], _merged_rows(P, r))
            if self.offd[r].nnz:
                APr = _csr_add(APr, spgemm(self.offd[r], Pf))
            rows_l.append(_row_ids(APr.indptr) + int(self.row_offsets[r]))
            cols_l.append(APr.indices)
            vals_l.append(APr.data)
        return ParCSR.from_global_coo(
            self.nranks, self.shape[0], P.shape[1], np.concatenate(rows_l),
            np.concatenate(cols_l), np.concatenate(vals_l),
            row_offsets=self.row_offsets, col_offsets=P.col_offsets,
            dtype=self.dtype, device=self.device)

    def _local_rows_global_cols(self, M: "ParCSR", r: int):
        """(indptr, global cols, vals) of rank ``r``'s rows of ``M``."""
        csr = _merged_rows(M, r)
        return csr.indptr, csr.indices, csr.data

    def ptap(self, P: "ParCSR") -> "ParCSR":
        """Galerkin product P^T (self) P (paper §6.4, Fig 12 right).

        Local P_r^T @ (AP)_r yields contributions to rows owned by *other*
        ranks (P's columns); they are routed with the stash assembly below
        — one compose_inverse-built SF reduce, PETSc's MatStash on SF."""
        AP = self.spmm(P)
        trips: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for r in range(self.nranks):
            prod = spgemm(csr_transpose(_merged_rows(P, r)),
                          _merged_rows(AP, r))
            trips.append((_row_ids(prod.indptr), prod.indices, prod.data))
        return assemble_coo(self.nranks, P.shape[1], AP.shape[1], trips,
                            row_offsets=P.col_offsets,
                            col_offsets=P.col_offsets
                            if P.shape[1] == AP.shape[1] else None,
                            dtype=self.dtype, device=self.device)


def _row_ids(indptr: np.ndarray) -> np.ndarray:
    """The row of every entry of a CSR with ``indptr``."""
    return np.repeat(np.arange(indptr.size - 1), np.diff(indptr))


def _merged_rows(M: ParCSR, r: int) -> LocalCSR:
    """Rank ``r``'s rows of ``M`` as one CSR over global columns (diagonal
    block shifted to its column offset, off-diagonal through garray)."""
    A, B, g = M.diag[r], M.offd[r], M.garray[r]
    rows = np.concatenate([_row_ids(A.indptr), _row_ids(B.indptr)])
    cols = np.concatenate([A.indices + int(M.col_offsets[r]),
                           g[B.indices] if B.nnz else np.zeros(0, np.int64)])
    return csr_from_coo(A.shape[0], M.shape[1], rows, cols,
                        np.concatenate([A.data, B.data]))


def _csr_add(a: LocalCSR, b: LocalCSR) -> LocalCSR:
    m, n = a.shape
    rows = np.concatenate([_row_ids(a.indptr), _row_ids(b.indptr)])
    return csr_from_coo(m, n, rows, np.concatenate([a.indices, b.indices]),
                        np.concatenate([a.data, b.data]))


def _value_bits(vals: np.ndarray) -> np.ndarray:
    """Bit-pattern view of a float array, used as a tie-break sort key so
    duplicate-entry sums run in a value-canonical (insert-order-free)
    sequence."""
    vals = np.ascontiguousarray(vals)
    return vals.view({2: np.uint16, 4: np.uint32,
                      8: np.uint64}[vals.dtype.itemsize])


def _canonical_sum(keys: np.ndarray, vals: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Sum ``vals`` grouped by integer ``keys`` in a canonical order:
    entries are sorted by (key, value bits) and summed left-to-right per
    group (``np.add.reduceat``), so the result is bitwise independent of
    the caller's insertion order — the sorted-segment reduction invariant
    of ``core/redplan.py`` applied on the host."""
    if keys.size == 0:
        return keys.copy(), vals.copy()
    order = np.lexsort((_value_bits(vals), keys))
    ks, vs = keys[order], vals[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(ks)) + 1])
    return ks[starts], np.add.reduceat(vs, starts)


class Sparsity:
    """Preallocated distributed sparsity pattern (MatPreallocator / pyop2
    ``Sparsity``).

    The global set of (row, col) positions is dedup'd once; each owner
    rank stores its entries in canonical (local row, global col) order —
    the *slot* numbering all inserts resolve against.  Row blocks are
    contiguous in slot space, which is exactly what lets the stash flush
    ride a Section-derived dof-SF (nnz-per-row sizes) in
    :class:`MatAssembler`.
    """

    def __init__(self, nranks: int, m: int, n: int,
                 rows: np.ndarray, cols: np.ndarray,
                 row_offsets: Optional[np.ndarray] = None,
                 col_offsets: Optional[np.ndarray] = None,
                 dtype=np.float32):
        self.nranks = int(nranks)
        self.m, self.n = int(m), int(n)
        if row_offsets is None:
            row_offsets = np.linspace(0, m, nranks + 1).astype(np.int64)
        self.row_offsets = np.asarray(row_offsets, dtype=np.int64)
        self.col_offsets = col_offsets
        self.dtype = np.dtype(dtype)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.size and (rows.min() < 0 or rows.max() >= m):
            raise ValueError("row index out of range")
        if cols.size and (cols.min() < 0 or cols.max() >= n):
            raise ValueError("col index out of range")
        keys = np.unique(rows * n + cols)        # sorted (row, col) pairs
        # per-owner canonical slot arrays (key-sorted => row-major blocks)
        cut = np.searchsorted(keys, self.row_offsets * n)
        self.keys = [keys[cut[p]: cut[p + 1]] for p in range(self.nranks)]
        self.rows_of = [k // n for k in self.keys]
        self.cols_of = [k % n for k in self.keys]
        self.row_nnz: List[np.ndarray] = []
        self.row_slot_start: List[np.ndarray] = []
        for p in range(self.nranks):
            nrows = int(self.row_offsets[p + 1] - self.row_offsets[p])
            cnt = np.bincount(self.rows_of[p] - self.row_offsets[p],
                              minlength=nrows).astype(np.int64)
            self.row_nnz.append(cnt)
            self.row_slot_start.append(ragged_offsets(cnt)[:-1])
        self.nnz = np.asarray([k.size for k in self.keys], dtype=np.int64)
        self.slot_offsets = ragged_offsets(self.nnz)

    @property
    def nnz_total(self) -> int:
        return int(self.slot_offsets[-1])

    def owner_of_rows(self, rows: np.ndarray) -> np.ndarray:
        return _owner_of(self.row_offsets, np.asarray(rows, dtype=np.int64))

    def lookup(self, rows: np.ndarray, cols: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(owner rank, owner-local slot) of each (row, col); raises
        ``KeyError`` for positions not preallocated."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        owner = self.owner_of_rows(rows)
        key = rows * self.n + cols
        slot = np.empty(rows.shape[0], dtype=np.int64)
        for p in np.unique(owner):
            sel = owner == p
            idx = np.searchsorted(self.keys[p], key[sel])
            idx = np.minimum(idx, max(self.keys[p].size - 1, 0))
            ok = self.keys[p].size and \
                (self.keys[p][idx] == key[sel]).all()
            if not ok:
                bad = np.flatnonzero(self.keys[p][idx] != key[sel]) \
                    if self.keys[p].size else np.arange(sel.sum())
                r0, c0 = rows[sel][bad[0]], cols[sel][bad[0]]
                raise KeyError(f"entry ({int(r0)}, {int(c0)}) not in the "
                               "preallocated sparsity")
            slot[sel] = idx
        return owner, slot

    def to_parcsr(self, slot_values: np.ndarray, backend: Optional[str] = None,
                  device=None) -> ParCSR:
        """Materialize a ParCSR (on ``device``) from the concatenated
        per-owner slot-value array (length ``nnz_total``)."""
        return ParCSR.from_global_coo(
            self.nranks, self.m, self.n, np.concatenate(self.rows_of),
            np.concatenate(self.cols_of),
            np.asarray(slot_values).astype(np.float64),
            row_offsets=self.row_offsets, col_offsets=self.col_offsets,
            dtype=self.dtype, backend=backend, device=device)


class MatAssembler:
    """Stash-based parallel assembly (PETSc MatStash / pyop2 ``Mat``).

    ``add_values(rank, ...)`` resolves owned-row contributions to slots
    immediately (pure local writes); off-process triplets accumulate in a
    per-rank *stash*.  ``assemble()`` flushes every stash with **one** SF
    reduce on the device whose graph is built by
    :func:`repro_torch.core.compose.compose_inverse` over the row-ownership
    dof-SF:

      row SF (roots = owned matrix rows, leaves = ranks' stashed rows)
        --apply_section(nnz per row)-->  dof SF (roots = owner nnz slots)
        --compose_inverse(dof SF, stash entry SF)-->  flush SF
            (roots = owner slots, leaves = stash entries)

    Duplicate inserts are pre-summed per rank in a value-canonical order
    (:func:`_canonical_sum`), and the SF reduce itself folds each slot's
    entries in the deterministic (leaf rank, edge index) order of
    ``core/redplan.py`` (no atomics on the card) — the assembled matrix is
    bitwise independent of insertion order.  The flush SF and its
    ``SFComm`` are cached on the stash pattern, so a re-assembly with the
    same pattern (time stepping) builds neither again.
    """

    def __init__(self, sparsity: Sparsity, backend: Optional[str] = None,
                 device=None):
        self.sparsity = sparsity
        self.backend = backend
        self.device = resolve_device(device)
        R = sparsity.nranks
        self._local: List[List[Tuple[np.ndarray, np.ndarray]]] = \
            [[] for _ in range(R)]
        self._stash: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = \
            [[] for _ in range(R)]
        # (stash pattern, flush SF, its SFComm per backend name)
        self._flush_cache: Optional[Tuple[tuple, StarForest, dict]] = None
        self.stats = {"local_inserts": 0, "stashed_inserts": 0, "flushes": 0}

    def add_values(self, rank: int, rows: np.ndarray, cols: np.ndarray,
                   vals: np.ndarray) -> None:
        """Insert COO contributions from ``rank`` (ADD_VALUES semantics)."""
        sp = self.sparsity
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        cols = np.asarray(cols, dtype=np.int64).reshape(-1)
        vals = np.asarray(vals, dtype=sp.dtype).reshape(-1)
        if not (rows.size == cols.size == vals.size):
            raise ValueError("rows/cols/vals length mismatch")
        owner = sp.owner_of_rows(rows)
        mine = owner == rank
        if mine.any():
            _, slot = sp.lookup(rows[mine], cols[mine])
            self._local[rank].append((slot, vals[mine]))
            self.stats["local_inserts"] += int(mine.sum())
        rest = ~mine
        if rest.any():
            sp.lookup(rows[rest], cols[rest])   # fail fast on bad pattern
            self._stash[rank].append((rows[rest], cols[rest], vals[rest]))
            self.stats["stashed_inserts"] += int(rest.sum())

    # ------------------------------------------------------------- flush
    def _stash_partials(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Per-rank (sorted distinct stash keys, canonical partial sums)."""
        sp = self.sparsity
        keys_q, vals_q = [], []
        for q in range(sp.nranks):
            if self._stash[q]:
                r = np.concatenate([s[0] for s in self._stash[q]])
                c = np.concatenate([s[1] for s in self._stash[q]])
                v = np.concatenate([s[2] for s in self._stash[q]])
                k, pv = _canonical_sum(r * sp.n + c, v)
            else:
                k = np.zeros(0, np.int64)
                pv = np.zeros(0, sp.dtype)
            keys_q.append(k)
            vals_q.append(pv)
        return keys_q, vals_q

    def _flush_sf(self, keys_q: List[np.ndarray]) -> StarForest:
        """The stash-flush SF, built by compose_inverse and cached on the
        stash pattern (time-stepping re-assemblies reuse it)."""
        sig = tuple(k.tobytes() for k in keys_q)
        if self._flush_cache is not None and self._flush_cache[0] == sig:
            return self._flush_cache[1]
        sp = self.sparsity
        R = sp.nranks
        # row-ownership SF over each rank's distinct stashed rows
        row_sf = StarForest(R)
        urows_q = [np.unique(k // sp.n) for k in keys_q]
        for q in range(R):
            w = urows_q[q]
            owner = sp.owner_of_rows(w)
            remote = np.stack([owner, w - sp.row_offsets[owner]], axis=1) \
                if w.size else np.zeros((0, 2), np.int64)
            row_sf.set_graph(q, int(sp.row_offsets[q + 1]
                                    - sp.row_offsets[q]),
                             None, remote, nleafspace=max(w.size, 1))
        row_sf.setup()
        # nnz-per-row Section -> dof SF whose roots ARE the owner slots
        sections = [Section(sp.row_nnz[p],
                            np.concatenate([sp.row_slot_start[p],
                                            [sp.nnz[p]]]))
                    for p in range(R)]
        dof_sf = apply_section(row_sf, sections, device=self.device)
        # stash-entry SF: every stash entry is a root whose single leaf
        # sits at its (row block, col position) in the dof-SF leaf space;
        # a global row's nnz and first slot, across its owner's arrays
        row_nnz = np.concatenate(sp.row_nnz)
        row_slot_start = np.concatenate(sp.row_slot_start)
        B = StarForest(R)
        for q in range(R):
            k = keys_q[q]
            rows = k // sp.n
            _, slot = sp.lookup(rows, k % sp.n)
            rowpos = np.searchsorted(urows_q[q], rows)
            block_start = ragged_offsets(row_nnz[urows_q[q]])[:-1]
            local = block_start[rowpos] + slot - row_slot_start[rows]
            remote = np.stack([np.full(k.size, q, np.int64),
                               np.arange(k.size, dtype=np.int64)], axis=1)
            B.set_graph(q, int(k.size), local, remote,
                        nleafspace=dof_sf.graph(q).nleafspace)
        flush_sf = compose_inverse(dof_sf, B)
        self._flush_cache = (sig, flush_sf, {})
        return flush_sf

    def assemble(self, backend: Optional[str] = None) -> ParCSR:
        """Drain all buffered inserts into a :class:`ParCSR`.

        Local contributions are segment-summed into the owner slot arrays
        on the host; the off-process stash moves with exactly ONE
        ``SFComm.reduce`` over the compose_inverse flush SF, on the
        device.
        """
        sp = self.sparsity
        R = sp.nranks
        # 1) local canonical partials -> slot arrays
        root = np.zeros(sp.nnz_total, dtype=sp.dtype)
        for p in range(R):
            if not self._local[p]:
                continue
            slots = np.concatenate([s for s, _ in self._local[p]])
            vals = np.concatenate([v for _, v in self._local[p]])
            us, sums = _canonical_sum(slots, vals)
            root[sp.slot_offsets[p] + us] += sums
        # 2) per-rank stash partials + 3) the ONE flush reduce
        keys_q, vals_q = self._stash_partials()
        flush_sf = self._flush_sf(keys_q)
        backend = backend or self.backend
        comms = self._flush_cache[2]
        if backend not in comms:
            comms[backend] = SFComm(flush_sf, backend=backend,
                                    device=self.device)
        lo = flush_sf.leaf_offsets()
        leaf = np.zeros(flush_sf.nleafspace_total, dtype=sp.dtype)
        for q in range(R):
            leaf[lo[q]: lo[q] + vals_q[q].size] = vals_q[q]
        dev = self.device
        out = comms[backend].reduce(torch.as_tensor(leaf, device=dev),
                                    torch.as_tensor(root, device=dev),
                                    "sum").cpu().numpy()
        self.stats["flushes"] += 1
        # drain buffers; the sparsity and cached flush SF stay reusable
        self._local = [[] for _ in range(R)]
        self._stash = [[] for _ in range(R)]
        return sp.to_parcsr(out, backend=backend, device=dev)


def assemble_coo(nranks: int, m: int, n: int,
                 triplets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 row_offsets: Optional[np.ndarray] = None,
                 col_offsets: Optional[np.ndarray] = None,
                 dtype=np.float32, method: str = "stash",
                 device=None) -> ParCSR:
    """Distributed COO assembly via star forests (paper §6.4 step 3), every
    exchange on ``device``.

    ``method="stash"`` (default): derive a :class:`Sparsity` from the
    union pattern and flush through :class:`MatAssembler` — all
    off-process values move in ONE compose_inverse-built SF reduce.

    ``method="fetch"`` keeps the legacy 3-step path:

    1. A *counting SF* (one counter root per rank) + FetchAndOp(SUM) assigns
       every triplet a staging slot on its owner rank — the paper's
       fetch-and-add offset allocation.
    2. A *staging SF* (roots = allocated slots) routes (row, col, val) with
       three REPLACE reduces.
    3. Owners build their local CSR from the staged COO.
    """
    if method not in ("stash", "fetch"):
        raise ValueError(f"unknown assembly method {method!r}")
    device = resolve_device(device)
    if method == "stash":
        cat = lambda i: np.concatenate([np.asarray(t[i], dtype=np.int64)
                                        for t in triplets]) \
            if triplets else np.zeros(0, np.int64)
        sp = Sparsity(nranks, m, n, cat(0), cat(1), row_offsets=row_offsets,
                      col_offsets=col_offsets, dtype=dtype)
        asm = MatAssembler(sp, device=device)
        for q, t in enumerate(triplets):
            asm.add_values(q, t[0], t[1], t[2])
        return asm.assemble()
    if row_offsets is None:
        row_offsets = np.linspace(0, m, nranks + 1).astype(np.int64)
    row_offsets = np.asarray(row_offsets, dtype=np.int64)

    owners = [_owner_of(row_offsets, np.asarray(t[0], dtype=np.int64))
              for t in triplets]
    # --- 1) counting SF: rank p owns one counter (root); each triplet is a
    # leaf connected to its owner's counter.
    csf = StarForest(nranks)
    for q in range(nranks):
        t = owners[q]
        csf.set_graph(q, 1, None, np.stack([t, np.zeros_like(t)], axis=1),
                      nleafspace=max(t.size, 1))
    csf.setup()
    totals, slots = SFComm(csf, device=device).fetch_and_op(
        torch.zeros(nranks, dtype=torch.int32, device=device),
        torch.ones(csf.nleafspace_total, dtype=torch.int32, device=device),
        "sum")
    totals, slots = totals.cpu().numpy(), slots.cpu().numpy()
    lo = csf.leaf_offsets()

    # --- 2) staging SF: roots = totals[r] slots on rank r
    ssf = StarForest(nranks)
    for q in range(nranks):
        t = owners[q]
        ssf.set_graph(q, int(totals[q]), None,
                      np.stack([t, slots[lo[q]: lo[q] + t.size]], axis=1),
                      nleafspace=max(t.size, 1))
    ssf.setup()
    sops = SFComm(ssf, device=device)

    def route(i, dt):
        leaf = np.zeros(ssf.nleafspace_total, dtype=dt)
        for q in range(nranks):
            v = np.asarray(triplets[q][i], dtype=dt)
            leaf[lo[q]: lo[q] + v.size] = v
        return sops.reduce(torch.as_tensor(leaf, device=device),
                           torch.zeros(ssf.nroots_total,
                                       dtype=torch.as_tensor(leaf).dtype,
                                       device=device),
                           "replace").cpu().numpy()

    # --- 3) owners' staged COO, in rank order, is the global COO
    return ParCSR.from_global_coo(nranks, m, n, route(0, np.int64),
                                  route(1, np.int64), route(2, np.float64),
                                  row_offsets=row_offsets,
                                  col_offsets=col_offsets, dtype=dtype,
                                  device=device)
