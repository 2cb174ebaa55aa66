"""DMPlex-lite: distributed unstructured-mesh topology on star forests (the
port of ``repro/meshdist/plex.py``).

Paper §4.2/§6.3: meshes are represented by points (cells, vertices) with a
cone (adjacency) relation; *all* parallel operations — partitioning
migration, ghost exchange, dof layout — are expressed as PetscSFs derived
mechanically from a point SF plus PetscSections.  This module reproduces
that pipeline on a periodic structured hex mesh (the paper's §6.3 test is a
fully periodic 128³ hex mesh):

  * ``HexMesh``      — global topology template (cells -> 8 vertices).
  * ``DistributedMesh`` — per-rank owned cells, cones in global vertex ids,
    local vertex numbering, vertex coordinates.
  * ``initial_distribution`` — the paper's Seq / Chunks / Rand layouts.
  * ``distribute``   — migration driven by a cell SF (SFBcast moves cones,
    labels and cell ids on the device), then local setup (vertex dedup,
    ghost vertex SF via the lowest-owner rule).
  * ``global_to_local`` / ``local_to_global`` — DMGlobalToLocal /
    DMLocalToGlobal over the section-derived dof SF.
  * ``grow_overlap`` — n-level cell halos by SF composition.

Every exchange runs through ``SFComm`` on the device (the card unless
``device="cpu"``).  The setup is numpy on whole arrays where the reference
loops over vertices and cells in Python; it builds the reference's SFs and
arrays, entry for entry in the same order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..core import (SFComm, StarForest, compose, ragged_arange,
                    ragged_offsets)
from ..core.device import check_payload, resolve_device
from .section import Section, apply_section

__all__ = ["HexMesh", "DistributedMesh", "initial_distribution",
           "migration_sf", "distribute", "make_vertex_sf", "global_to_local",
           "local_to_global", "Overlap", "grow_overlap"]


@dataclasses.dataclass(frozen=True)
class HexMesh:
    """Fully periodic structured hex mesh: nx*ny*nz cells and vertices."""
    nx: int
    ny: int
    nz: int

    @property
    def ncells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def nvertices(self) -> int:
        return self.nx * self.ny * self.nz

    def cell_cone(self, cells: np.ndarray) -> np.ndarray:
        """(n, 8) vertex ids of each cell's corners (periodic wrap)."""
        nx, ny, nz = self.nx, self.ny, self.nz
        i = cells % nx
        j = (cells // nx) % ny
        k = cells // (nx * ny)
        out = np.empty((cells.shape[0], 8), dtype=np.int64)
        c = 0
        for dk in (0, 1):
            for dj in (0, 1):
                for di in (0, 1):
                    ii = (i + di) % nx
                    jj = (j + dj) % ny
                    kk = (k + dk) % nz
                    out[:, c] = ii + nx * jj + nx * ny * kk
                    c += 1
        return out

    def vertex_coords(self, verts: np.ndarray) -> np.ndarray:
        nx, ny = self.nx, self.ny
        i = verts % nx
        j = (verts // nx) % ny
        k = verts // (nx * ny)
        return np.stack([i / self.nx, j / self.ny, k / self.nz],
                        axis=1).astype(np.float32)


@dataclasses.dataclass
class DistributedMesh:
    mesh: HexMesh
    nranks: int
    cells: List[np.ndarray]            # global cell ids per rank
    cones: List[np.ndarray]            # (n, 8) global vertex ids per rank
    labels: List[np.ndarray]           # (n,) integer labels per rank
    # local setup products
    local_verts: List[np.ndarray] = None      # unique global vertex ids
    cone_local: List[np.ndarray] = None       # cones in local vertex numbers
    coords: List[np.ndarray] = None           # (nverts_local, 3)
    vertex_owner: List[np.ndarray] = None     # owner rank per local vertex

    def setup_local(self) -> "DistributedMesh":
        """Local (re)numbering after migration: dedup vertices, local cones,
        coordinates — the 'final local setup' timed in paper Fig 11."""
        self.local_verts, self.cone_local, self.coords = [], [], []
        for r in range(self.nranks):
            cone = self.cones[r]
            verts, inv = np.unique(cone.reshape(-1), return_inverse=True)
            self.local_verts.append(verts)
            self.cone_local.append(inv.reshape(cone.shape).astype(np.int64))
            self.coords.append(self.mesh.vertex_coords(verts))
        # lowest-sharer-rank ownership
        first_owner = np.full(self.mesh.nvertices, self.nranks, np.int64)
        for r in reversed(range(self.nranks)):
            first_owner[self.local_verts[r]] = r
        self.vertex_owner = [first_owner[v] for v in self.local_verts]
        return self


def initial_distribution(mesh: HexMesh, nranks: int, kind: str,
                         seed: int = 0) -> DistributedMesh:
    """Paper §6.3 initial layouts: 'seq' (all on rank 0), 'chunks'
    (lexicographic blocks), 'rand' (random owner per cell)."""
    n = mesh.ncells
    all_cells = np.arange(n, dtype=np.int64)
    if kind == "seq":
        owner = np.zeros(n, dtype=np.int64)
    elif kind == "chunks":
        owner = (all_cells * nranks) // n
    elif kind == "rand":
        owner = np.random.default_rng(seed).integers(0, nranks, n)
    else:
        raise ValueError(kind)
    cells = [all_cells[owner == r] for r in range(nranks)]
    cones = [mesh.cell_cone(c) for c in cells]
    labels = [c % 7 for c in cells]   # arbitrary persistent cell label
    return DistributedMesh(mesh, nranks, cells, cones, labels)


def _partition_balanced(mesh: HexMesh, nranks: int) -> np.ndarray:
    """Target partition: balanced lexicographic blocks (stand-in for the
    graph partitioner, which the paper excludes from its timings)."""
    cells = np.arange(mesh.ncells, dtype=np.int64)
    return (cells * nranks) // mesh.ncells


def _directory(dm: DistributedMesh):
    """(current rank, current local offset) of every global cell, -1 for
    cells no rank holds."""
    n = dm.mesh.ncells
    cur_rank = np.full(n, -1, dtype=np.int64)
    cur_off = np.full(n, -1, dtype=np.int64)
    for r in range(dm.nranks):
        cur_rank[dm.cells[r]] = r
        cur_off[dm.cells[r]] = np.arange(dm.cells[r].shape[0])
    return cur_rank, cur_off


def migration_sf(dm: DistributedMesh, target_owner: np.ndarray) -> StarForest:
    """SF whose roots are current points and leaves the migrated points:
    'based on the partition, we make a PetscSF whose roots are the original
    mesh points and whose leaves are the redistributed mesh points so that
    SFBcast would migrate the points' (paper §4.2)."""
    cur_rank, cur_off = _directory(dm)
    sf = StarForest(dm.nranks)
    for r in range(dm.nranks):
        mine = np.flatnonzero(target_owner == r).astype(np.int64)
        sf.set_graph(r, int(dm.cells[r].shape[0]), None,
                     np.stack([cur_rank[mine], cur_off[mine]], axis=1),
                     nleafspace=max(mine.size, 1))
    return sf.setup()


def distribute(dm: DistributedMesh,
               target_owner: Optional[np.ndarray] = None,
               time_phases: bool = False, *,
               backend: Optional[str] = None, device=None):
    """Migrate the mesh to ``target_owner`` (default: balanced blocks).

    Phases (timed separately when requested, as in Fig 11):
      1. build migration SF (and its ``SFComm`` on ``device``);
      2. SFBcast topology (cones, unit=8 ints), labels, and cell ids;
      3. local setup on the new owners.
    """
    t0 = time.perf_counter()
    mesh = dm.mesh
    R = dm.nranks
    if target_owner is None:
        target_owner = _partition_balanced(mesh, R)
    sf = migration_sf(dm, target_owner)
    ops = SFComm(sf, backend=backend, device=device)
    t1 = time.perf_counter()
    lo = sf.leaf_offsets()
    nleaves = np.bincount(target_owner, minlength=R)

    def migrate(per_rank_arrays, unit_cols: int):
        root = torch.as_tensor(np.concatenate(
            [np.asarray(a, dtype=np.int32).reshape(-1, unit_cols)
             for a in per_rank_arrays]), device=ops.device)
        leaf = ops.bcast(root, root.new_zeros((sf.nleafspace_total,
                                               unit_cols)),
                         "replace").cpu().numpy()
        return [leaf[lo[r]: lo[r] + nleaves[r]] for r in range(R)]

    new_cones = migrate(dm.cones, 8)
    new_labels = migrate(dm.labels, 1)
    new_cells = migrate(dm.cells, 1)
    t2 = time.perf_counter()

    out = DistributedMesh(
        mesh, R,
        [c[:, 0].astype(np.int64) for c in new_cells],
        [c.astype(np.int64) for c in new_cones],
        [lab[:, 0].astype(np.int64) for lab in new_labels],
    ).setup_local()
    t3 = time.perf_counter()
    if time_phases:
        return out, {"sf_build": t1 - t0, "migration": t2 - t1,
                     "local_setup": t3 - t2, "total": t3 - t0}
    return out


def make_vertex_sf(dm: DistributedMesh) -> StarForest:
    """Point SF over vertices: every non-owned local vertex (leaf) connects
    to its owner's copy (root) — the ghost-exchange SF of paper §4.2."""
    R = dm.nranks
    if dm.local_verts is None:
        dm.setup_local()
    # owner rank and owner's local index of each global vertex
    owner = np.full(dm.mesh.nvertices, -1, dtype=np.int64)
    owner_li = np.full(dm.mesh.nvertices, -1, dtype=np.int64)
    for r in range(R):
        li = np.flatnonzero(dm.vertex_owner[r] == r)
        owner[dm.local_verts[r][li]] = r
        owner_li[dm.local_verts[r][li]] = li
    sf = StarForest(R)
    for r in range(R):
        v = dm.local_verts[r]
        if (owner[v] < 0).any():
            raise KeyError(f"a vertex of rank {r} has no owner copy")
        loc = np.flatnonzero(owner[v] != r)
        sf.set_graph(r, int(v.shape[0]), loc,
                     np.stack([owner[v[loc]], owner_li[v[loc]]], axis=1),
                     nleafspace=max(int(v.shape[0]), 1))
    return sf.setup()


def _dof_sf(vsf: StarForest, dof_per_vertex: int, backend, device
            ) -> StarForest:
    """The vertex SF with ``dof_per_vertex`` dofs per vertex on both
    sides."""
    R = vsf.nranks
    sections = [Section.from_sizes(np.full(vsf.graph(r).nroots,
                                           dof_per_vertex, np.int64))
                for r in range(R)]
    leaf_sections = [Section.from_sizes(np.full(vsf.graph(r).nleafspace,
                                                dof_per_vertex, np.int64))
                     for r in range(R)]
    return apply_section(vsf, sections, leaf_sections, backend=backend,
                         device=device)


def global_to_local(vsf: StarForest, dof_per_vertex: int,
                    global_vec: torch.Tensor, *,
                    backend: Optional[str] = None,
                    device=None) -> torch.Tensor:
    """DMGlobalToLocal: owners push dof values to ghosts (SFBcast over the
    dof-SF derived by applying the Section to the point SF)."""
    ops = SFComm(_dof_sf(vsf, dof_per_vertex, backend, device),
                 backend=backend, device=device)
    g = check_payload(global_vec, ops.device, "global_vec")
    return ops.bcast(g, g.clone(), "replace")


def local_to_global(vsf: StarForest, dof_per_vertex: int,
                    local_vec: torch.Tensor, *,
                    backend: Optional[str] = None,
                    device=None) -> torch.Tensor:
    """DMLocalToGlobal (ADD_VALUES): ghosts accumulate into owners (SFReduce)
    — the assembly step of FE/FV discretizations (paper §4.2)."""
    ops = SFComm(_dof_sf(vsf, dof_per_vertex, backend, device),
                 backend=backend, device=device)
    v = check_payload(local_vec, ops.device, "local_vec")
    return ops.reduce(v, v.clone(), "sum")


# --------------------------------------------------------- overlap growth
@dataclasses.dataclass
class Overlap:
    """n-level cell halo derived by SF composition (DMPlexDistributeOverlap).

    ``cells[q]`` lists rank q's local cell region — owned cells first, then
    halo cells ordered by (level, global id); ``level[q]`` tags each local
    cell with its BFS distance (0 = owned).  ``sf`` connects every local
    cell to its owner's copy (owned cells as self edges, like DMDA
    ``interior='connect'``), so one SFBcast realizes the whole
    overlap-aware DMGlobalToLocal.
    """
    dm: DistributedMesh
    levels: int
    cells: List[np.ndarray]
    level: List[np.ndarray]
    sf: StarForest
    adjacency_sfs: List[StarForest]   # per grown level, the composed SF

    @property
    def nranks(self) -> int:
        return self.dm.nranks

    def cell_offsets(self) -> np.ndarray:
        return self.sf.leaf_offsets()

    def global_to_local(self, cell_data: torch.Tensor,
                        backend: Optional[str] = None,
                        device=None) -> torch.Tensor:
        """Exchange per-owned-cell data (``(ncells_owned_total, *unit)``, in
        the rank-concatenated order of ``dm.cells``, on ``device``) into the
        overlap regions: one SFBcast over the overlap SF."""
        comm = SFComm(self.sf, backend=backend, device=device)
        root = check_payload(cell_data, comm.device, "cell_data")
        return comm.bcast(root, root.new_zeros((self.sf.nleafspace_total,)
                                               + root.shape[1:]), "replace")


def _vertex_owner_map(dm: DistributedMesh, vsf: StarForest) -> np.ndarray:
    """Global vertex id -> owner rank (-1 where no rank has the vertex),
    read off the vertex SF: leaves point at their owner's root copy;
    vertices with no leaf edge anywhere are owned where they live.  Later
    ranks overwrite earlier ones, as the reference's dict updates do."""
    owner = np.full(dm.mesh.nvertices, -1, dtype=np.int64)
    for r in range(dm.nranks):
        g = vsf.graph(r)
        ghost = np.zeros(dm.local_verts[r].shape[0], dtype=bool)
        ghost[g.local] = True
        owner[dm.local_verts[r][~ghost]] = r
    for r in range(dm.nranks):
        g = vsf.graph(r)
        owner[dm.local_verts[r][g.local]] = g.remote_rank
    return owner


def grow_overlap(dm: DistributedMesh, vsf: Optional[StarForest] = None,
                 levels: int = 1, backend: Optional[str] = None,
                 device=None) -> Overlap:
    """Grow an n-level cell overlap by SF composition (paper §2 derived SFs;
    PETSc's DMPlexDistributeOverlap).

    Two SFs are composed per level, leaf-of-leaf via :func:`compose`:

    * **A** (cell->vertex incidence, built once): roots are owned cells;
      rank m's leaves are one slot per (owned vertex v, incident cell)
      pair, each connected to that cell's owner — m's rows of the
      distributed vertex-to-cell incidence table.
    * **B** (vertex fan-out, rebuilt as the known region grows): roots are
      A's leaf slots; rank q's leaves request the full incidence row of
      every vertex q currently knows.

    ``compose(A, B)`` therefore maps owned cells directly to every rank
    that knows one of their vertices.  One SFBcast of ``[cell id | cone]``
    (unit ``(9,)`` int32, on ``device``) over the composed SF then delivers
    both the next halo ring and the cone data needed to extend the
    known-vertex set for the following level — the mesh is never rebuilt.
    """
    if levels < 1:
        raise ValueError("levels must be >= 1")
    R = dm.nranks
    device = resolve_device(device)
    if dm.local_verts is None:
        dm.setup_local()
    if vsf is None:
        vsf = make_vertex_sf(dm)
    owner = _vertex_owner_map(dm, vsf)
    cur_rank, cur_off = _directory(dm)
    ncells, nverts = dm.mesh.ncells, dm.mesh.nvertices

    # Global vertex -> sorted incident cells (from the distributed cones),
    # as CSR over vertex ids.
    pairs = np.unique(np.concatenate(
        [dm.cones[r].reshape(-1) * ncells
         + np.repeat(dm.cells[r], dm.cones[r].shape[1])
         for r in range(R)]))
    inc_cells = pairs % ncells
    inc_ptr = ragged_offsets(np.bincount(pairs // ncells, minlength=nverts))
    inc_len = np.diff(inc_ptr)

    # ---- A: cell->vertex incidence SF (fixed across levels); slot_base[v]
    # is v's first slot in its owner's leaf space.
    slot_base = np.zeros(nverts, dtype=np.int64)
    A = StarForest(R)
    for m in range(R):
        verts = np.flatnonzero(owner == m)
        slot_base[verts] = ragged_offsets(inc_len[verts])[:-1]
        v_of, j = ragged_arange(inc_len[verts])
        c = inc_cells[inc_ptr[verts][v_of] + j]
        A.set_graph(m, int(dm.cells[m].shape[0]), None,
                    np.stack([cur_rank[c], cur_off[c]], axis=1),
                    nleafspace=max(int(c.size), 1))
    A.setup()

    # Per-rank growth state: known vertices and known cells.
    known_verts = np.zeros((R, nverts), dtype=bool)
    known_cells = np.zeros((R, ncells), dtype=bool)
    for r in range(R):
        known_verts[r, dm.local_verts[r]] = True
        known_cells[r, dm.cells[r]] = True
    halo_cells: List[List[np.ndarray]] = [[] for _ in range(R)]

    # Root payload: [cell id | 8-vertex cone] per owned cell, unit (9,).
    payload = torch.as_tensor(np.concatenate(
        [np.concatenate([dm.cells[r].reshape(-1, 1), dm.cones[r]], axis=1)
         for r in range(R)]).astype(np.int32), device=device)

    adjacency_sfs: List[StarForest] = []
    for _ in range(levels):
        # ---- B: fan-out SF over the current known-vertex sets.
        B = StarForest(R)
        nslots_q = []
        for q in range(R):
            verts = np.flatnonzero(known_verts[q])
            v_of, j = ragged_arange(inc_len[verts])
            v = verts[v_of]
            B.set_graph(q, A.graph(q).nleafspace, None,
                        np.stack([owner[v], slot_base[v] + j], axis=1),
                        nleafspace=max(int(v.size), 1))
            nslots_q.append(int(v.size))
        AB = compose(A, B)
        adjacency_sfs.append(AB)

        leaf = SFComm(AB, backend=backend, device=device).bcast(
            payload, payload.new_zeros((AB.nleafspace_total, 9)),
            "replace").cpu().numpy()
        lo = AB.leaf_offsets()
        for q in range(R):
            seen = leaf[lo[q]: lo[q] + nslots_q[q]]
            ids = seen[:, 0].astype(np.int64)
            fresh = np.unique(ids)
            fresh = fresh[~known_cells[q, fresh]]
            halo_cells[q].append(fresh)
            known_cells[q, fresh] = True
            # any slot row with a matching id works: cones are global
            first = np.unique(ids, return_index=True)[1]
            rows = seen[first[np.searchsorted(ids[first], fresh)]]
            known_verts[q, rows[:, 1:].reshape(-1)] = True

    # ---- final overlap SF: roots = owned cells, leaves = owned + halo.
    out_cells, out_level = [], []
    osf = StarForest(R)
    for q in range(R):
        own = dm.cells[q].astype(np.int64)
        halos = halo_cells[q]
        cells_q = np.concatenate([own] + halos)
        lev_q = np.concatenate(
            [np.zeros(own.shape[0], np.int64)]
            + [np.full(h.shape[0], k + 1, np.int64)
               for k, h in enumerate(halos)])
        osf.set_graph(q, int(own.shape[0]), None,
                      np.stack([cur_rank[cells_q], cur_off[cells_q]], axis=1),
                      nleafspace=max(int(cells_q.shape[0]), 1))
        out_cells.append(cells_q)
        out_level.append(lev_q)
    return Overlap(dm, levels, out_cells, out_level, osf.setup(),
                   adjacency_sfs)
