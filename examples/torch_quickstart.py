"""Quickstart for the PyTorch/CUDA port: the star-forest API in five minutes.

Builds the paper's Fig 2 star forest, shows the registered backends and the
one ``select_backend`` picks, runs every communication operation and the
fused multi-field bcast, then runs the same bcast and reduce on the
``"dist"`` backend: three gloo processes on the CPU, one rank each, every
process returning the whole result.  Run on the card (the default) or on
the CPU:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import (SFComm, StarForest, available_backends,
                              make_multi_sf, patterns, select_backend)


def fig2_sf() -> StarForest:
    """The Fig 2 graph: 3 ranks, leaves point at local or remote roots."""
    sf = StarForest(3)
    #               nroots  local leaf positions   (rank, offset) of roots
    sf.set_graph(0, 2,      [0, 1, 2],             [(0, 0), (0, 1), (1, 0)])
    sf.set_graph(1, 2,      [0, 2],                [(0, 1), (2, 0)],
                 nleafspace=4)   # positions 1, 3 are isolated leaves
    sf.set_graph(2, 1,      [0, 1],                [(2, 0), (1, 1)])
    return sf.setup()


def tour(device: torch.device) -> None:
    sf = fig2_sf()
    print(sf)
    print("degrees per rank:", [sf.degrees(r).tolist() for r in range(3)])
    rep = patterns.analyze(sf)
    print("pattern:", rep.kind, "| local edges:", rep.n_local_edges,
          "| remote edges:", rep.n_remote_edges)

    # SFComm picks a backend (paper §4: -sf_backend); name one to override.
    # A torch.distributed group of sf.nranks processes selects "dist".
    ops = SFComm(sf, device=device)
    print("registered backends:", available_backends(),
          "| select_backend:", select_backend(sf, device=device),
          "| forced override:",
          SFComm(sf, backend="cuda", device=device).backend_name)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    roots = torch.arange(10, 10 + sf.nroots_total, **f32)
    leaves = torch.zeros(sf.nleafspace_total, **f32)

    # Bcast: roots push values to leaves (paper §3.2)
    print("\nbcast(replace):", ops.bcast(roots, leaves, "replace").tolist())
    # Reduce: leaves accumulate into roots
    ones = torch.ones(sf.nleafspace_total, **f32)
    print("reduce(sum) of ones == degrees:",
          ops.reduce(ones, torch.zeros(sf.nroots_total, **f32)).tolist())
    # begin/end split: the overlap idiom of the paper's SpMV
    pend = ops.bcast_begin(roots, "replace")
    local_work = (roots ** 2).sum()              # overlapped compute
    print("begin/end bcast:", pend.end(leaves).tolist(),
          " overlapped:", float(local_work))
    # FetchAndOp: the offset-allocation primitive
    slots_root, slots = ops.fetch_and_op(
        torch.zeros(sf.nroots_total, **i32),
        torch.ones(sf.nleafspace_total, **i32))
    print("fetch_and_add slots:", slots.tolist(), " totals:",
          slots_root.tolist())
    # gather / scatter through the multi-SF layout
    gathered = ops.gather(torch.arange(sf.nleafspace_total, **f32))
    print("multi-SF:", make_multi_sf(sf), "\ngather(leaf ids):",
          gathered.tolist(), "\nscatter back:",
          ops.scatter(gathered).tolist())
    # fused multi-field exchange (VecScatter analogue, core/fields.py)
    coords = torch.arange(3.0 * sf.nroots_total, **f32).reshape(-1, 3)
    labels = torch.arange(sf.nroots_total, **i32)
    oc, ol = ops.bcast_multi(
        [coords, labels],
        [torch.zeros(sf.nleafspace_total, 3, **f32),
         torch.zeros(sf.nleafspace_total, **i32)])
    print("\nbcast_multi (f32 coords + i32 labels, one fused exchange):")
    print("  coords ->", oc[:3].tolist(), "...\n  labels ->", ol.tolist())


def dist_rank(rank: int, store: str) -> None:
    """One rank of the "dist" demo: the group selects the backend."""
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=3, timeout=timedelta(seconds=60))
    try:
        sf = fig2_sf()
        ops = SFComm(sf, device="cpu", group=dist.group.WORLD)
        roots = torch.arange(10, 10 + sf.nroots_total, dtype=torch.float32)
        out = ops.bcast(roots, torch.zeros(sf.nleafspace_total))
        red = ops.reduce(torch.ones(sf.nleafspace_total),
                         torch.zeros(sf.nroots_total))
        if rank == 0:
            print(f"\n{ops.backend_name!r} over 3 gloo ranks "
                  f"(lowering {ops.backend.dist.lowering!r}):")
            print("  bcast(replace):", out.tolist())
            print("  reduce(sum) of ones:", red.tolist())
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    device = torch.device(ap.parse_args().device)
    tour(device)
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(dist_rank, args=(f"{d}/store",), nprocs=3,
                           start_method="spawn")


if __name__ == "__main__":
    main()
