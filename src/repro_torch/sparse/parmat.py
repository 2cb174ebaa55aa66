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

The port of ``repro.sparse.parmat``'s ``ParCSR`` construction (from COO
and from a DMDA stencil), ``diagonal``, SpMV, multi-RHS SpMV and transposed
SpMV.  All ranks' blocks live on one device
(the card unless ``device="cpu"``); the ELL values and column lists are
uploaded once, at construction.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import SFComm, StarForest, ragged_offsets
from ..core.device import check_payload, resolve_device
from ..kernels import ops as kops
from ..kernels._index import device_index
from .csr import LocalCSR, csr_from_coo, csr_transpose

__all__ = ["ParCSR"]


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
        # backend=None -> select_backend's static heuristic ("cuda" for the
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
