"""Port parity, DMPlex-lite: ``repro_torch.meshdist.plex`` and
``section`` against the reference on the same meshes, all bitwise (mesh
topology, SF graphs and integer payloads; the ghost-assembly counts are
small integers in float32).

* ``HexMesh`` cones and coordinates; each ``initial_distribution`` kind;
* ``migration_sf`` and ``distribute``: the reference's SF graphs, cells,
  cones, labels and local setup, balanced, every cell on one rank;
* ``make_vertex_sf``, ``global_to_local`` / ``local_to_global`` (every
  vertex of the periodic mesh assembles to 8) against the reference;
* ``grow_overlap`` at levels 1 and 2 over the kinds and seeds: the
  reference's cells, levels and composed SFs, and a numpy BFS oracle over
  "cells sharing a vertex"; ``Overlap.global_to_local`` delivers cell ids;
* ``apply_section``'s dof SF equal to the reference's, packed and with
  leaf sections, on both port backends.

The reference's meshes reach the port through
``convert.distributed_mesh_from_arrays``."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from conftest import random_star_forest  # noqa: E402
from torch_parity import CPU, n, port_sf, t  # noqa: E402
from test_torch_compose import assert_same_graphs  # noqa: E402

from repro.meshdist import plex as RP  # noqa: E402
from repro.meshdist import section as RS  # noqa: E402

from repro_torch.convert import distributed_mesh_from_arrays  # noqa: E402
from repro_torch.meshdist import plex as PP  # noqa: E402
from repro_torch.meshdist.section import Section, apply_section  # noqa: E402

MESH_FIELDS = ("cells", "cones", "labels", "local_verts", "cone_local",
               "coords", "vertex_owner")


def _port_mesh(ref):
    return distributed_mesh_from_arrays(
        (ref.mesh.nx, ref.mesh.ny, ref.mesh.nz), ref.cells, ref.cones,
        ref.labels)


def assert_same_mesh(got, want):
    assert got.nranks == want.nranks
    for f in MESH_FIELDS:
        for r, (a, b) in enumerate(zip(getattr(got, f), getattr(want, f))):
            assert a.dtype == b.dtype, (f, r)
            np.testing.assert_array_equal(a, b, err_msg=f"{f}[{r}]")


def _bfs_oracle(mesh, cells_per_rank, levels):
    """Per rank, the halo cells at each BFS level over "cells sharing a
    vertex" adjacency, from the whole mesh's cones (numpy only)."""
    cones = mesh.cell_cone(np.arange(mesh.ncells))
    v2c = np.zeros((mesh.nvertices, mesh.ncells), dtype=bool)
    v2c[cones.reshape(-1), np.repeat(np.arange(mesh.ncells), 8)] = True
    out = []
    for own in cells_per_rank:
        known = np.zeros(mesh.ncells, dtype=bool)
        known[own] = True
        frontier, per_level = known.copy(), []
        for _ in range(levels):
            near = v2c[cones[frontier].reshape(-1)].any(axis=0)
            fresh = near & ~known
            per_level.append(np.flatnonzero(fresh))
            known |= fresh
            frontier = fresh
        out.append(per_level)
    return out


def test_hex_mesh_cones_and_coords_match_reference():
    for shape in ((4, 3, 2), (6, 6, 6), (1, 2, 3)):
        mesh, ref = PP.HexMesh(*shape), RP.HexMesh(*shape)
        cells = np.arange(mesh.ncells)
        np.testing.assert_array_equal(mesh.cell_cone(cells),
                                      ref.cell_cone(cells))
        np.testing.assert_array_equal(mesh.vertex_coords(cells),
                                      ref.vertex_coords(cells))


@pytest.mark.parametrize("kind", ["seq", "chunks", "rand"])
@pytest.mark.parametrize("backend", ["global", "cuda"])
def test_distribute_matches_reference(kind, backend):
    mesh = PP.HexMesh(6, 5, 4)
    dm0 = PP.initial_distribution(mesh, 4, kind, seed=2)
    ref0 = RP.initial_distribution(RP.HexMesh(6, 5, 4), 4, kind, seed=2)
    for f in ("cells", "cones", "labels"):
        for a, b in zip(getattr(dm0, f), getattr(ref0, f)):
            np.testing.assert_array_equal(a, b)
    target = np.random.default_rng(5).integers(0, 4, mesh.ncells)
    assert_same_graphs(PP.migration_sf(dm0, target),
                       RP.migration_sf(ref0, target))
    dm, times = PP.distribute(dm0, time_phases=True, backend=backend,
                              device="cpu")
    assert set(times) == {"sf_build", "migration", "local_setup", "total"}
    assert_same_mesh(dm, RP.distribute(ref0))
    sizes = [c.size for c in dm.cells]
    assert sum(sizes) == mesh.ncells and max(sizes) - min(sizes) <= 1
    assert np.array_equal(np.sort(np.concatenate(dm.cells)),
                          np.arange(mesh.ncells))
    for r in range(4):
        np.testing.assert_array_equal(dm.cones[r], mesh.cell_cone(dm.cells[r]))
        np.testing.assert_array_equal(dm.labels[r], dm.cells[r] % 7)
    with pytest.raises(ValueError):
        PP.initial_distribution(mesh, 4, "blocks")


@pytest.mark.parametrize("backend", ["global", "cuda"])
def test_vertex_sf_and_ghost_assembly_match_reference(backend):
    ref = RP.distribute(RP.initial_distribution(RP.HexMesh(6, 6, 6), 4,
                                                "rand"))
    dm = _port_mesh(ref)
    assert_same_mesh(dm, ref)
    vsf, rvsf = PP.make_vertex_sf(dm), RP.make_vertex_sf(ref)
    assert_same_graphs(vsf, rvsf)
    nl = [v.size for v in dm.local_verts]
    local = np.concatenate([np.bincount(dm.cone_local[r].reshape(-1),
                                        minlength=nl[r]).astype(np.float32)
                            for r in range(4)])
    summed = PP.local_to_global(vsf, 1, t(local), backend=backend,
                                device="cpu")
    np.testing.assert_array_equal(n(summed),
                                  RP.local_to_global(rvsf, 1, local))
    lo = vsf.leaf_offsets()
    for r in range(4):
        own = dm.vertex_owner[r] == r
        assert (n(summed)[lo[r]: lo[r] + nl[r]][own] == 8).all()
    filled = PP.global_to_local(vsf, 1, summed, backend=backend, device="cpu")
    assert (n(filled) == 8).all()
    np.testing.assert_array_equal(
        n(filled), RP.global_to_local(rvsf, 1, n(summed)))
    # three dofs per vertex through the same section-derived SF
    three = np.repeat(local, 3).reshape(-1, 3) * np.float32([1, 2, 3])
    np.testing.assert_array_equal(
        n(PP.local_to_global(vsf, 3, t(three.reshape(-1)), device="cpu")),
        RP.local_to_global(rvsf, 3, three.reshape(-1)))


@pytest.mark.parametrize("kind,levels,seed", [
    ("rand", 1, 3), ("rand", 2, 3), ("rand", 2, 8), ("chunks", 1, 0),
    ("chunks", 2, 0), ("seq", 2, 1)])
def test_grow_overlap_matches_reference_and_bfs(kind, levels, seed):
    ref = RP.distribute(RP.initial_distribution(RP.HexMesh(5, 4, 4), 4, kind,
                                                seed=seed))
    dm = _port_mesh(ref)
    ov = PP.grow_overlap(dm, levels=levels, device="cpu")
    rov = RP.grow_overlap(ref, levels=levels)
    for q in range(4):
        np.testing.assert_array_equal(ov.cells[q], rov.cells[q])
        np.testing.assert_array_equal(ov.level[q], rov.level[q])
    for a, b in zip(ov.adjacency_sfs, rov.adjacency_sfs):
        assert_same_graphs(a, b)
    assert_same_graphs(ov.sf, rov.sf)
    want = _bfs_oracle(dm.mesh, dm.cells, levels)
    for q in range(4):
        own = dm.cells[q]
        np.testing.assert_array_equal(ov.cells[q][: own.size], own)
        assert (ov.level[q][: own.size] == 0).all()
        for k in range(levels):
            np.testing.assert_array_equal(
                np.sort(ov.cells[q][ov.level[q] == k + 1]), want[q][k],
                err_msg=f"rank {q} level {k + 1}")


@pytest.mark.parametrize("backend", ["global", "cuda"])
def test_overlap_global_to_local_delivers_cell_data(backend):
    ref = RP.distribute(RP.initial_distribution(RP.HexMesh(4, 4, 2), 4,
                                                "rand"))
    dm = _port_mesh(ref)
    ov = PP.grow_overlap(dm, levels=2, backend=backend, device="cpu")
    root = torch.as_tensor(np.concatenate(dm.cells).astype(np.int32))
    got = n(ov.global_to_local(root, backend=backend, device="cpu"))
    lo = ov.cell_offsets()
    for q in range(4):
        np.testing.assert_array_equal(got[lo[q]: lo[q] + ov.cells[q].size],
                                      ov.cells[q])


def test_grow_overlap_level_saturates():
    mesh = PP.HexMesh(3, 3, 3)
    dm = PP.distribute(PP.initial_distribution(mesh, 4, "seq"), device="cpu")
    ov = PP.grow_overlap(dm, levels=3, device="cpu")
    for q in range(4):
        assert np.unique(ov.cells[q]).size == ov.cells[q].size
        assert set(ov.cells[q].tolist()) == set(range(mesh.ncells))
    with pytest.raises(ValueError, match="levels"):
        PP.grow_overlap(dm, levels=0, device="cpu")


@pytest.mark.parametrize("backend", ["global", "cuda"])
@pytest.mark.parametrize("seed", [23, 4])
def test_apply_section_matches_reference(backend, seed):
    ref = random_star_forest(seed=seed)
    sf = port_sf(ref)
    sizes = [np.arange(ref.graph(r).nroots) % 3 + 1
             for r in range(ref.nranks)]
    got = apply_section(sf, [Section.from_sizes(s) for s in sizes],
                        backend=backend, device=CPU)
    want = RS.apply_section(ref, [RS.Section.from_sizes(s) for s in sizes])
    assert_same_graphs(got, want)
    # leaf sections: each leaf point gets its root's size, reversed layout
    lsz = [np.zeros(ref.graph(q).nleafspace, np.int64)
           for q in range(ref.nranks)]
    ro = ref.root_offsets()
    allsz = np.concatenate(sizes)
    for q in range(ref.nranks):
        g = ref.graph(q)
        lsz[q][g.local] = allsz[ro[g.remote_rank] + g.remote_offset]
    got = apply_section(sf, [Section.from_sizes(s) for s in sizes],
                        [Section.from_sizes(s) for s in lsz],
                        backend=backend, device=CPU)
    want = RS.apply_section(ref, [RS.Section.from_sizes(s) for s in sizes],
                            [RS.Section.from_sizes(s) for s in lsz])
    assert_same_graphs(got, want)
    bad = [Section.from_sizes(s + 1) for s in lsz]
    if ref.nedges_total:
        with pytest.raises(ValueError, match="size mismatch"):
            apply_section(sf, [Section.from_sizes(s) for s in sizes], bad,
                          device=CPU)
