"""DMDA-lite: distributed structured grids whose halo exchange is an SF (the
port of ``repro/meshdist/dmda.py``).

Paper §2/§4.2: DMDA is PETSc's structured-grid manager — every rank owns a
box of an N-D grid, local vectors carry a ghost region of configurable
stencil width, and ``DMGlobalToLocal``/``DMLocalToGlobal`` are SF
broadcast/reduce over the ghost star forest.  This module reproduces that
layer on :class:`repro_torch.core.StarForest`, so structured-grid halo
exchange runs on every registered SF backend (``global`` / ``cuda``) and
benefits from unit-aware packs: a dof-block or fused multi-field payload
moves through the same plan as a scalar one.

Supported: any grid rank, ``star`` (faces only) and ``box`` (faces+corners)
stencils, stencil width >= 1, per-dimension periodic boundaries, and two
leaf-population modes:

* ``interior="connect"`` — every local (ghosted) array position is a leaf;
  owned positions are self edges (the paper's §5.2 local/remote split
  handles them), so one SFBcast realizes the whole DMGlobalToLocal.
* ``interior="skip"``    — only ghost positions are leaves; the owned block
  is filled by a precomputed direct copy and the SF carries pure halo
  traffic (what ``benchmarks/bench_halo.py`` times).

Orderings follow PETSc: *natural* ordering is grid row-major over the whole
domain; *global* ordering concatenates each rank's owned box (row-major
within the box) in rank order — the layout of global SF arrays.

The setup is numpy, as in the reference.  The exchanges take tensors on one
device (the card unless the caller passes ``device="cpu"``), which each
exchange hands to its cached :class:`repro_torch.core.SFComm`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import SFComm, StarForest, ragged_offsets
from ..core.device import check_payload, index_tensor, resolve_device
from ..core.mpiops import get_op
from ..core.ops import _apply_unique

__all__ = ["DMDA", "default_proc_grid"]

STAR = "star"
BOX = "box"


def default_proc_grid(shape: Sequence[int], nranks: int) -> Tuple[int, ...]:
    """Factor ``nranks`` over the grid dims, largest extents first (the
    DMDACreate default: keep subdomains as cubic as possible)."""
    shape = tuple(int(d) for d in shape)
    grid = [1] * len(shape)
    n = int(nranks)
    f = 2
    factors = []
    while f * f <= n:
        while n % f == 0:
            factors.append(f)
            n //= f
        f += 1
    if n > 1:
        factors.append(n)
    for f in sorted(factors, reverse=True):
        # give the factor to the dim with the largest per-proc extent
        i = int(np.argmax([shape[d] / grid[d] for d in range(len(shape))]))
        grid[i] *= f
    out = tuple(grid)
    for d, p in zip(shape, out):
        if p > d:
            raise ValueError(f"cannot place {nranks} ranks on grid {shape}: "
                             f"axis of extent {d} would get {p} procs")
    return out


def _dim_splits(extent: int, nproc: int) -> np.ndarray:
    """(nproc+1,) split offsets of one dimension (balanced blocks)."""
    base, rem = divmod(extent, nproc)
    sizes = np.full(nproc, base, dtype=np.int64)
    sizes[:rem] += 1
    return ragged_offsets(sizes.tolist())


class DMDA:
    """Distributed N-D structured grid with SF-backed ghost exchange.

    The template object: build once (the constructor compiles the halo
    pattern to a StarForest), then exchange many times via
    :meth:`global_to_local` / :meth:`local_to_global` on any backend.
    """

    def __init__(self, shape: Sequence[int], nranks: int, *,
                 proc_grid: Optional[Sequence[int]] = None,
                 stencil: str = STAR, width: int = 1,
                 periodic=True, interior: str = "connect"):
        self.shape = tuple(int(d) for d in shape)
        self.ndim = len(self.shape)
        self.nranks = int(nranks)
        if stencil not in (STAR, BOX):
            raise ValueError(f"stencil must be {STAR!r} or {BOX!r}")
        if width < 1:
            raise ValueError("stencil width must be >= 1")
        if interior not in ("connect", "skip"):
            raise ValueError("interior must be 'connect' or 'skip'")
        self.stencil = stencil
        self.width = int(width)
        self.periodic = tuple(periodic) if isinstance(periodic, (tuple, list)) \
            else (bool(periodic),) * self.ndim
        if len(self.periodic) != self.ndim:
            raise ValueError("periodic must be a bool or one bool per dim")
        self.interior = interior
        self.proc_grid = tuple(int(p) for p in proc_grid) if proc_grid \
            else default_proc_grid(self.shape, self.nranks)
        if int(np.prod(self.proc_grid)) != self.nranks:
            raise ValueError(f"proc_grid {self.proc_grid} does not multiply "
                             f"to nranks={self.nranks}")
        # per-dim owned split offsets
        self.splits = [_dim_splits(d, p)
                       for d, p in zip(self.shape, self.proc_grid)]
        self._build()
        self._comms: Dict[str, SFComm] = {}

    # ------------------------------------------------------------ geometry
    def rank_coords(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in
                     np.unravel_index(rank, self.proc_grid))

    def owned_box(self, rank: int) -> Tuple[Tuple[int, int], ...]:
        """Per-dim half-open (lo, hi) of the rank's owned cells."""
        rc = self.rank_coords(rank)
        return tuple((int(self.splits[d][rc[d]]),
                      int(self.splits[d][rc[d] + 1]))
                     for d in range(self.ndim))

    def ghosted_box(self, rank: int) -> Tuple[Tuple[int, int], ...]:
        """Owned box widened by the stencil width (clipped per non-periodic
        dim at the domain boundary)."""
        out = []
        for d, (lo, hi) in enumerate(self.owned_box(rank)):
            glo, ghi = lo - self.width, hi + self.width
            if not self.periodic[d]:
                glo, ghi = max(glo, 0), min(ghi, self.shape[d])
            out.append((glo, ghi))
        return tuple(out)

    def local_shape(self, rank: int) -> Tuple[int, ...]:
        """Shape of the rank's local (ghosted) array."""
        return tuple(hi - lo for lo, hi in self.ghosted_box(rank))

    def stencil_offsets(self) -> np.ndarray:
        """(n_offsets, ndim) neighbor offsets of the stencil, center first.

        ``star``: ±1..±width along each axis; ``box``: the full
        ``(2*width+1)^ndim`` cube."""
        w, nd = self.width, self.ndim
        if self.stencil == BOX:
            grids = np.meshgrid(*([np.arange(-w, w + 1)] * nd),
                                indexing="ij")
            offs = np.stack([g.reshape(-1) for g in grids], axis=1)
        else:
            offs = [np.zeros(nd, dtype=np.int64)]
            for d in range(nd):
                for s in range(1, w + 1):
                    for sign in (-1, 1):
                        o = np.zeros(nd, dtype=np.int64)
                        o[d] = sign * s
                        offs.append(o)
            offs = np.stack(offs)
        center = np.flatnonzero((offs == 0).all(axis=1))[0]
        order = np.concatenate([[center],
                                np.delete(np.arange(len(offs)), center)])
        return offs[order].astype(np.int64)

    @staticmethod
    def box_coords(box: Sequence[Tuple[int, int]]) -> np.ndarray:
        """(n, ndim) natural coords enumerating a half-open box row-major."""
        grids = np.meshgrid(*[np.arange(lo, hi) for lo, hi in box],
                            indexing="ij")
        return np.stack([g.reshape(-1) for g in grids], axis=1)

    def wrap_coords(self, nat: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Boundary handling in ONE place: periodic dims wrap modulo the
        extent; non-periodic out-of-domain coords are flagged invalid.
        Returns ``(wrapped, valid)``."""
        nat = np.asarray(nat, dtype=np.int64).reshape(-1, self.ndim)
        wrapped = nat.copy()
        valid = np.ones(nat.shape[0], dtype=bool)
        for d in range(self.ndim):
            if self.periodic[d]:
                wrapped[:, d] %= self.shape[d]
            else:
                valid &= (nat[:, d] >= 0) & (nat[:, d] < self.shape[d])
        return wrapped, valid

    def owner_of(self, coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(rank, root offset) of natural cells ``coords`` (n, ndim)."""
        coords = np.asarray(coords, dtype=np.int64).reshape(-1, self.ndim)
        rc = np.empty_like(coords)
        off = np.empty_like(coords)
        ext = np.empty_like(coords)
        for d in range(self.ndim):
            rc[:, d] = np.searchsorted(self.splits[d], coords[:, d],
                                       side="right") - 1
            off[:, d] = coords[:, d] - self.splits[d][rc[:, d]]
            ext[:, d] = (self.splits[d][rc[:, d] + 1]
                         - self.splits[d][rc[:, d]])
        rank = np.ravel_multi_index(tuple(rc.T), self.proc_grid)
        root = np.zeros(coords.shape[0], dtype=np.int64)
        for d in range(self.ndim):
            root = root * ext[:, d] + off[:, d]
        return rank.astype(np.int64), root

    def natural_to_global(self, coords: np.ndarray) -> np.ndarray:
        """Global (rank-concatenated) cell ids of natural coords (n, ndim)."""
        rank, root = self.owner_of(coords)
        return self.owned_offsets[rank] + root

    # -------------------------------------------------- refinement levels
    def coarsen(self) -> "DMDA":
        """Vertex-centered coarsening (DMCoarsen): every odd extent
        ``n = 2m+1`` drops to ``m+1`` by keeping the even-index points.
        The proc grid, stencil, width and interior mode are inherited, so
        multigrid levels share their communication structure."""
        for d, e in enumerate(self.shape):
            if self.periodic[d]:
                raise ValueError("coarsen supports non-periodic grids only")
            if e < 3 or e % 2 == 0:
                raise ValueError(f"cannot coarsen extent {e} (need odd >= 3)")
        new_shape = tuple((e - 1) // 2 + 1 for e in self.shape)
        for e, p in zip(new_shape, self.proc_grid):
            if p > e:
                raise ValueError(f"coarse extent {e} smaller than proc-grid "
                                 f"axis {p}; stop coarsening earlier")
        return DMDA(new_shape, self.nranks, proc_grid=self.proc_grid,
                    stencil=self.stencil, width=self.width,
                    periodic=self.periodic, interior=self.interior)

    def refine(self) -> "DMDA":
        """Vertex-centered refinement (DMRefine): extent ``n`` grows to
        ``2n-1``; coarse point ``c`` coincides with fine point ``2c``."""
        for d in range(self.ndim):
            if self.periodic[d]:
                raise ValueError("refine supports non-periodic grids only")
        new_shape = tuple(2 * e - 1 for e in self.shape)
        return DMDA(new_shape, self.nranks, proc_grid=self.proc_grid,
                    stencil=self.stencil, width=self.width,
                    periodic=self.periodic, interior=self.interior)

    # --------------------------------------------------------------- build
    def _build(self) -> None:
        R = self.nranks
        owned_counts = [int(np.prod([hi - lo
                                     for lo, hi in self.owned_box(r)]))
                        for r in range(R)]
        self.owned_counts = np.asarray(owned_counts, dtype=np.int64)
        self.owned_offsets = ragged_offsets(owned_counts)
        sf = StarForest(R)
        self._interior_leaf: list = []     # per rank (only for skip mode)
        self._interior_global: list = []
        leaf_offsets = []
        for r in range(R):
            obox = self.owned_box(r)
            gbox = self.ghosted_box(r)
            lshape = self.local_shape(r)
            nlocal = int(np.prod(lshape))
            leaf_offsets.append(nlocal)
            # natural coords of every local position (unwrapped), then the
            # shared boundary handling (wrap periodic / flag out-of-domain)
            nat = self.box_coords(gbox)
            wrapped, valid = self.wrap_coords(nat)
            # how many dims lie outside the owned box (0 = interior)
            outside = np.zeros(nlocal, dtype=np.int64)
            for d, (lo, hi) in enumerate(obox):
                outside += ((nat[:, d] < lo) | (nat[:, d] >= hi))
            is_interior = outside == 0
            connect = valid.copy()
            if self.stencil == STAR:
                # faces only: corner ghosts (outside in >1 dim) stay holes
                connect &= outside <= 1
            if self.interior == "skip":
                connect &= ~is_interior
            leaf_pos = np.flatnonzero(connect).astype(np.int64)
            own_rank, own_off = self.owner_of(wrapped[leaf_pos]) \
                if leaf_pos.size else (np.zeros(0, np.int64),
                                       np.zeros(0, np.int64))
            sf.set_graph(r, owned_counts[r], leaf_pos,
                         np.stack([own_rank, own_off], axis=1)
                         if leaf_pos.size else np.zeros((0, 2), np.int64),
                         nleafspace=max(nlocal, 1))
            ipos = np.flatnonzero(valid & is_interior).astype(np.int64)
            self._interior_leaf.append(ipos)
            self._interior_global.append(
                self.natural_to_global(wrapped[ipos]) if ipos.size
                else np.zeros(0, np.int64))
        self.sf = sf.setup()
        self.local_offsets = ragged_offsets(
            [max(n, 1) for n in leaf_offsets])
        # skip-mode interior copy as ONE scatter: interior positions are
        # disjoint across ranks, so the per-rank lists concatenate into a
        # single (dst, src) index pair used by both transfer directions.
        self._interior_dst = np.concatenate(
            [self.local_offsets[r] + self._interior_leaf[r]
             for r in range(R)]) if R else np.zeros(0, np.int64)
        self._interior_src = np.concatenate(self._interior_global) \
            if R else np.zeros(0, np.int64)
        self._interior_idx: Dict[torch.device, tuple] = {}

    # ------------------------------------------------------------ exchange
    def comm(self, backend: Optional[str] = None, device=None,
             **kw) -> SFComm:
        """Cached SFComm over the halo SF on ``device`` (the card unless
        ``device="cpu"``; one per backend + device + kwargs signature, so
        differing kwargs never silently reuse a comm)."""
        dev = resolve_device(device)
        key = (backend or "auto", str(dev),
               tuple(sorted((k, repr(v)) for k, v in kw.items())))
        if key not in self._comms:
            self._comms[key] = SFComm(self.sf, backend=backend, device=dev,
                                      **kw)
        return self._comms[key]

    @property
    def nglobal(self) -> int:
        return int(self.owned_offsets[-1])

    @property
    def nlocal_total(self) -> int:
        return int(self.sf.nleafspace_total)

    def _interior(self, device: torch.device):
        """The skip-mode interior copy's (dst, src) rows on ``device``."""
        if device not in self._interior_idx:
            self._interior_idx[device] = (
                index_tensor(self._interior_dst, device),
                index_tensor(self._interior_src, device))
        return self._interior_idx[device]

    def global_to_local(self, gvec, lvec=None, backend: Optional[str] = None,
                        device=None):
        """DMGlobalToLocal: owners push values to every local array (ghosts
        via SFBcast; in ``interior='skip'`` mode the owned block is a direct
        copy and the SF moves pure halo traffic).  ``gvec`` is
        ``(nglobal, *unit)`` on ``device``; returns ``(nlocal_total,
        *unit)``."""
        comm = self.comm(backend, device)
        gvec = check_payload(gvec, comm.device, "gvec")
        if lvec is None:
            lvec = gvec.new_zeros((self.nlocal_total,) + gvec.shape[1:])
        lvec = check_payload(lvec, comm.device, "lvec")
        if self.interior == "skip" and self._interior_dst.size:
            dst, src = self._interior(comm.device)
            # interior positions are distinct: one duplicate-free copy
            lvec = lvec.index_copy(0, dst, gvec.index_select(0, src))
        return comm.bcast(gvec, lvec, "replace")

    def local_to_global(self, lvec, gvec=None, op="sum",
                        backend: Optional[str] = None, device=None):
        """DMLocalToGlobal: local (ghosted) contributions accumulate into
        owners — the assembly reduce of FD/FV stencil evaluation.  The
        default destination is the op's identity (not zeros: max/min/prod
        would otherwise clamp toward 0)."""
        comm = self.comm(backend, device)
        lvec = check_payload(lvec, comm.device, "lvec")
        if gvec is None:
            gvec = torch.full((self.nglobal,) + lvec.shape[1:],
                              get_op(op).identity_of(lvec.dtype),
                              dtype=lvec.dtype, device=comm.device)
        out = comm.reduce(lvec, gvec, op)
        if self.interior == "skip" and self._interior_dst.size:
            dst, src = self._interior(comm.device)
            out = _apply_unique(out, src, lvec.index_select(0, dst),
                                get_op(op))
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DMDA(shape={self.shape}, procs={self.proc_grid}, "
                f"stencil={self.stencil!r}, width={self.width}, "
                f"periodic={self.periodic}, interior={self.interior!r})")
