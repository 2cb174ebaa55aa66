"""Paper §6.3 demo on the port: distribute a periodic hex mesh from Seq /
Chunks / Rand initial layouts, run a ghost exchange over the derived vertex
SF, then grow a 2-level cell overlap by SF composition (paper §2) (the
port of ``examples/mesh_distribution.py``).

    PYTHONPATH=src python examples/torch_mesh_distribution.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.meshdist.plex import (HexMesh, distribute, grow_overlap,
                                       initial_distribution, local_to_global,
                                       make_vertex_sf)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = HexMesh(8, 8, 8)
    nranks = 8
    for kind in ("seq", "chunks", "rand"):
        dm0 = initial_distribution(mesh, nranks, kind)
        dm, times = distribute(dm0, time_phases=True, device=dev)
        sizes = [len(c) for c in dm.cells]
        print(f"{kind:7s}: cells/rank={min(sizes)}..{max(sizes)}  "
              f"migration={times['migration']*1e3:6.1f}ms  "
              f"local_setup={times['local_setup']*1e3:5.1f}ms")
    vsf = make_vertex_sf(dm)
    nl = [dm.local_verts[r].shape[0] for r in range(nranks)]
    counts = np.concatenate([
        np.array([(dm.cone_local[r] == li).sum() for li in range(nl[r])],
                 dtype=np.float32) for r in range(nranks)])
    summed = local_to_global(vsf, 1, torch.as_tensor(counts, device=dev),
                             device=dev).cpu().numpy()
    lo = vsf.leaf_offsets()
    owners_see_8 = all(
        np.all(summed[lo[r]: lo[r] + nl[r]][dm.vertex_owner[r] == r] == 8)
        for r in range(nranks))
    print(f"ghost assembly: every owned vertex counts 8 incident hexes -> "
          f"{owners_see_8}")

    # Grow a 2-level cell overlap by composing SFs (DMPlexDistributeOverlap)
    # and pull owner cell ids into every halo with one SFBcast.
    ov = grow_overlap(dm, vsf, levels=2, device=dev)
    owned = np.array([len(c) for c in dm.cells])
    halo = np.array([c.size for c in ov.cells]) - owned
    gids = torch.as_tensor(np.concatenate(dm.cells).astype(np.float32),
                           device=dev)
    got = ov.global_to_local(gids, device=dev).cpu().numpy().astype(np.int64)
    off = ov.cell_offsets()
    ok = all(np.array_equal(
        got[off[r]: off[r] + ov.cells[r].size], ov.cells[r])
        for r in range(nranks))
    print(f"overlap : halo cells/rank={halo.min()}..{halo.max()} at levels=2; "
          f"one bcast fills every halo correctly -> {ok}")


if __name__ == "__main__":
    main()
