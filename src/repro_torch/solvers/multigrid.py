"""Geometric multigrid on DMDA hierarchies, with SF-expressed transfers (the
port of ``repro/solvers/multigrid.py``).

The paper's §2 derived-SF machinery "in anger": PETSc's PCMG builds its
grid transfers once as matrices whose communication is a VecScatter; here
the transfer between two :class:`repro_torch.meshdist.dmda.DMDA`
refinement levels IS a star forest — roots are the coarse points, leaves
are *interpolation slots* (one per (fine point, contributing coarse point)
pair), and the tensor-product linear weights ride next to the SF as a
per-slot array.  Prolongation is one SFBcast followed by a weighted
segment-sum; restriction is the exact transpose: a weighted SFReduce.
Injection (the weight-1 subgraph where fine and coarse points coincide) is
extracted with :func:`repro_torch.core.compose.embed_leaves` — no new
graph is built, the embedded SF communicates on the same slot buffers.

Galerkin coarse operators come from ``ParCSR.ptap`` (paper §6.4), whose
off-process assembly routes through the stash/compose_inverse path of
:mod:`repro_torch.sparse.parmat`.  The V-cycle smoother is weighted Jacobi
on ``ParCSR.spmv`` through the ELL kernel.  Plug into CG as
``cg(A.spmv, b, M=mg.vcycle)``; ``cg_async`` captures the whole V-cycle
into its CUDA graph.

On the device nothing here uses float atomics: the slot sums of
``prolong`` and ``inject`` (the reference's ``segment_sum`` with sorted
indices) run through the deterministic segment-reduce kernels
(``kops.segment_reduce_rows``) over segments prepared once per transfer,
and ``restrict`` is ``SFComm.reduce``, so a V-cycle is the same bits from
run to run.  The setup is numpy on whole arrays where the reference loops
over fine points; it builds the reference's slot arrays and SF graphs,
slot for slot in the same order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import (SFComm, StarForest, UnitSpec, embed_leaves,
                    ragged_arange, ragged_offsets)
from ..core.device import kernel_index, resolve_device
from ..kernels import ops as kops
from ..kernels import sf_unpack
from ..meshdist.dmda import DMDA
from ..sparse.parmat import ParCSR

__all__ = ["Transfer", "Multigrid", "build_hierarchy"]


def _slots(nat: np.ndarray):
    """Interpolation slots of fine points ``nat`` (n, ndim), the
    reference's order: point by point, and within a point the
    ``itertools.product`` order of the per-dim contributors (last dim
    fastest).  Along a dim, an even fine index has its coincident coarse
    point (weight 1), an odd one the two flanking coarse points (weight
    1/2 each).  Returns (point of each slot, coarse coords (s, ndim),
    weight of each slot)."""
    odd = (nat % 2).astype(np.int64)
    per = 1 + odd                              # contributors along each dim
    point, c = ragged_arange(per.prod(axis=1))
    coarse = np.empty((point.size, nat.shape[1]), dtype=np.int64)
    for d in reversed(range(nat.shape[1])):    # mixed radix, last fastest
        n_d = per[point, d]
        coarse[:, d] = nat[point, d] // 2 + c % n_d
        c = c // n_d
    weight = 0.5 ** odd.sum(axis=1)[point]
    return point, coarse, weight


class Transfer:
    """Prolongation/restriction between one fine/coarse DMDA pair.

    The SF: roots = coarse points (coarse global ordering), rank r's
    leaves = r's interpolation slots, grouped contiguously per owned fine
    point.  ``prolong`` = SFBcast + weighted segment-sum; ``restrict`` =
    weighted SFReduce (exactly P^T, the Galerkin-consistent pairing).
    """

    def __init__(self, fine: DMDA, coarse: DMDA,
                 backend: Optional[str] = None, dtype=np.float32,
                 device=None):
        if fine.nranks != coarse.nranks:
            raise ValueError("fine and coarse DMDA must share ranks")
        if tuple(2 * e - 1 for e in coarse.shape) != fine.shape:
            raise ValueError(f"coarse {coarse.shape} does not refine to "
                             f"fine {fine.shape}")
        self.fine, self.coarse = fine, coarse
        self.device = d = resolve_device(device)
        R = fine.nranks
        sf = StarForest(R)
        w_l, seg_l, ccol_l = [], [], []
        self.nslots = []
        for r in range(R):
            nat = fine.box_coords(fine.owned_box(r))      # owned fine points
            point, cco, ww = _slots(nat)
            rank, off = coarse.owner_of(cco)
            sf.set_graph(r, int(coarse.owned_counts[r]), None,
                         np.stack([rank, off], axis=1),
                         nleafspace=max(ww.size, 1))
            w_l.append(ww.astype(dtype))
            seg_l.append(fine.owned_offsets[r] + point)
            ccol_l.append(coarse.owned_offsets[rank] + off)
            self.nslots.append(int(ww.size))
        self.sf = sf.setup()
        self.weights = np.concatenate(w_l)
        self.seg_ids = np.concatenate(seg_l)
        self.coarse_cols = np.concatenate(ccol_l)
        self.dtype = dtype
        # unit-aware comm: multi-RHS (nc, k) payloads ride the same plan
        self.comm = SFComm(self.sf, backend=backend, unit=UnitSpec(),
                           device=d)
        self._w = torch.as_tensor(self.weights, device=d)
        self._seg = torch.as_tensor(self.seg_ids, device=d)
        # the slot sums: seg_ids are sorted and every fine point has a slot,
        # so fine row i is the segment of slots [first[i], first[i] + len[i])
        counts = np.bincount(self.seg_ids, minlength=self.nfine)
        self._seg_first = kernel_index(ragged_offsets(counts)[:-1], d)
        self._seg_len = kernel_index(counts, d)
        sf_unpack.prepare(self._seg_first, self._seg_len, d)
        # injection = the weight-1 subgraph (fine/coarse coincident points),
        # extracted WITHOUT remapping: the embedded SF shares slot buffers.
        sel = [np.flatnonzero(w_l[r] == 1.0) for r in range(R)]
        self.injection_sf = embed_leaves(self.sf, sel)
        self._inj_comm = SFComm(self.injection_sf, backend=backend, device=d)

    @property
    def nfine(self) -> int:
        return self.fine.nglobal

    @property
    def ncoarse(self) -> int:
        return self.coarse.nglobal

    def _spread(self, x: torch.Tensor) -> torch.Tensor:
        """Broadcast-compatible weight view for payloads with unit dims."""
        return self._w.reshape(self._w.shape + (1,) * (x.dim() - 1))

    def _slot_sums(self, slots: torch.Tensor) -> torch.Tensor:
        """Per fine point, the sum of its slots (in slot order)."""
        return kops.segment_reduce_rows(slots, self._seg_first,
                                        self._seg_len)

    def _empty_slots(self, xc: torch.Tensor) -> torch.Tensor:
        return xc.new_zeros((self.sf.nleafspace_total,) + xc.shape[1:])

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        """x_f = P x_c: one SFBcast of the coarse vector into the slots,
        then a weighted segment-sum per fine point."""
        slots = self.comm.bcast(xc, self._empty_slots(xc), "replace")
        return self._slot_sums(slots * self._spread(slots))

    def restrict(self, xf: torch.Tensor) -> torch.Tensor:
        """x_c = P^T x_f: weight the slots, one SFReduce(SUM) to coarse."""
        leaf = xf.index_select(0, self._seg)
        leaf = leaf * self._spread(leaf)
        return self.comm.reduce(
            leaf, xf.new_zeros((self.ncoarse,) + xf.shape[1:]), "sum")

    def inject(self, xc: torch.Tensor) -> torch.Tensor:
        """Direct injection: coarse values land on the coincident fine
        points (0 elsewhere) — a bcast over the embedded weight-1 SF."""
        return self._slot_sums(self._inj_comm.bcast(
            xc, self._empty_slots(xc), "replace"))

    def as_parcsr(self, backend: Optional[str] = None) -> ParCSR:
        """P as a distributed matrix (rows = fine, cols = coarse) for the
        Galerkin product ``A.ptap(P)``."""
        return ParCSR.from_global_coo(
            self.fine.nranks, self.nfine, self.ncoarse,
            self.seg_ids, self.coarse_cols, self.weights.astype(np.float64),
            row_offsets=self.fine.owned_offsets,
            col_offsets=self.coarse.owned_offsets,
            dtype=self.dtype, backend=backend, device=self.device)


def build_hierarchy(da: DMDA, nlevels: int) -> List[DMDA]:
    """[fine, ..., coarse] by repeated vertex-centered coarsening."""
    das = [da]
    for _ in range(nlevels - 1):
        das.append(das[-1].coarsen())
    return das


class Multigrid:
    """Geometric-multigrid V-cycle preconditioner on a DMDA hierarchy.

    Levels hold Galerkin operators ``A_{l+1} = P_l^T A_l P_l`` (via
    ``ParCSR.ptap``), weighted-Jacobi smoothing (``omega`` = 2/3 default),
    and a dense pseudo-inverse direct solve on the coarsest grid (computed
    once on the host, applied as one matrix product).  ``vcycle`` maps a
    tensor to a tensor on the device without reading anything back, so it
    can be passed as ``M=`` to :func:`repro_torch.solvers.cg.cg` or be
    captured into ``cg_async``'s CUDA graph.
    """

    def __init__(self, da: DMDA, A: Optional[ParCSR] = None, *,
                 nlevels: int = 2, nu_pre: int = 1, nu_post: int = 1,
                 omega: float = 2.0 / 3.0,
                 coeffs: Optional[Sequence[float]] = None,
                 backend: Optional[str] = None, device=None):
        if nlevels < 1:
            raise ValueError("nlevels must be >= 1")
        self.device = d = resolve_device(device)
        self.das = build_hierarchy(da, nlevels)
        self.nu_pre, self.nu_post = int(nu_pre), int(nu_post)
        self.omega = float(omega)
        self.ops: List[ParCSR] = [
            A if A is not None else ParCSR.from_dmda_stencil(
                da, coeffs, backend=backend, device=d)]
        self.transfers: List[Transfer] = []
        for l in range(nlevels - 1):
            t = Transfer(self.das[l], self.das[l + 1], backend=backend,
                         device=d)
            self.transfers.append(t)
            self.ops.append(self.ops[l].ptap(t.as_parcsr()))
        self.diags: List[torch.Tensor] = []
        for Al in self.ops:
            diag = Al.diagonal()
            diag[diag == 0.0] = 1.0    # keep Jacobi well defined on holes
            self.diags.append(torch.as_tensor(diag, dtype=torch.float32,
                                              device=d))
        self._coarse_inv = torch.as_tensor(
            np.linalg.pinv(self.ops[-1].toarray()), dtype=torch.float32,
            device=d)

    @property
    def nlevels(self) -> int:
        return len(self.ops)

    def _smooth(self, l: int, x: torch.Tensor, b: torch.Tensor,
                nu: int) -> torch.Tensor:
        A, d = self.ops[l], self.diags[l]
        for _ in range(nu):
            x = x + self.omega * (b - A.spmv(x, use_kernel=True)) / d
        return x

    def _cycle(self, l: int, b: torch.Tensor) -> torch.Tensor:
        if l == self.nlevels - 1:
            return self._coarse_inv @ b
        # pre-smooth from zero initial guess
        x = self._smooth(l, torch.zeros_like(b), b, self.nu_pre)
        r = b - self.ops[l].spmv(x, use_kernel=True)
        xc = self._cycle(l + 1, self.transfers[l].restrict(r))
        x = x + self.transfers[l].prolong(xc)
        return self._smooth(l, x, b, self.nu_post)

    def vcycle(self, b: torch.Tensor) -> torch.Tensor:
        """One V(nu_pre, nu_post) cycle applied to ``b`` (zero initial
        guess) — an SPD approximation of ``A^{-1} b``, usable as a CG
        preconditioner."""
        return self._cycle(0, b)
