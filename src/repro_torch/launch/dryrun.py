"""Multi-pod dry run: every (architecture x shape x mesh) cell's step on
the production meshes, run on abstract tensors, with its per-device memory
and cost (the port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 virtual XLA devices.
The port runs each cell's step once, eagerly, in one process that stands in
for rank 0 of the mesh: a ``fake`` process group of world 256 (16 x 16) or
512 (2 x 16 x 16), whose collectives return at once, and
``FakeTensorMode``, whose tensors have shapes, dtypes and devices but no
data.  Each mesh runs in a child process of its own (a fake group and a
real one never share a process; ``torch.distributed`` keeps one default
group).  For every cell it:

  1. builds the step and its abstract DTensor arguments
     (``launch/cells.py``), each rank's shard at its local shape;
  2. runs the step under ``launch/op_cost.py``'s counting mode: FLOPs,
     bytes, collectives and peak memory per device (the arguments
     included);
  3. writes a JSON record to ``<out>/<cell>.json``: the reference's schema,
     with ``op_cost`` in place of ``hlo_cost`` and ``fits80G`` (peak
     against ``launch.mesh.HW.hbm_bytes()``) in place of ``fits16G``.

An eager step costs host time in proportion to its depth, so by default a
cell deeper than 4 layers is run at 2, 3 and 4 layers and its counts are
extended to its depth along the parabola through them.  Every
layer runs the same ops at the same shapes (stacked leaves, the L axis
never sharded), so FLOPs and collectives are affine in depth; the bytes
are not: each layer's slice of a stacked leaf takes its gradient through
``select``'s backward, a zero-filled tensor of the whole stack, so that
traffic grows with the square of the depth (the parabola is exact for
it).  The peak is a maximum over the step, not a polynomial: it is
extended along the line through the two deepest runs (the parameters,
moments, gradients and saved activations grow in proportion to the
depth), never below the deepest run's, which is approximate where fixed
activations outweigh the layers.  ``run_cell(depth="full")`` runs every
layer (the tests hold the extension to it).  Arguments are always sized
at full depth.

Every family runs on every mesh; ``long_500k`` of a full-attention family
writes a ``status: "skipped"`` record with that reason.  xlstm's layers
come in (mLSTM, sLSTM) pairs, so its cells run at 2, 4 and 6 layers (1, 2
and 3 pairs) and are extended from those.  ``--device cuda`` (the
default) runs on fake
CUDA tensors over a CUDA mesh, so DTensor lowers each layout change as it
does on the card (``--device cpu``: a CPU mesh, whose shard-to-shard moves
DTensor lowers to all-gathers, for machines without a CUDA build).

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch qwen3-4b]
      [--shape train_4k] [--mesh single|multi|both] [--out DIR]
      [--device cuda|cpu] [--jobs N] [--force]

Restartable: cells with a report are skipped unless ``--force``.
``--jobs N`` deals the archs among N children per mesh, run at once (each
its own fake group; a cell is single-threaded host work).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional, Sequence

__all__ = ["main", "run_cell", "skip_reason", "MESHES", "fake_group"]

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DEPTHS = (2, 3, 4)        # the depths a deeper cell is run at
PAIR_DEPTHS = (2, 4, 6)   # xlstm's: 1, 2 and 3 (mLSTM, sLSTM) pairs


def fake_group(world: int, rank: int = 0) -> None:
    """Initialise the default process group as the ``fake`` backend of
    ``world`` ranks (this process is ``rank``).  The backend lives in
    ``torch.testing._internal``; without it the dry run cannot run."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch does not have") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def skip_reason(arch: str, shape: str, mesh_shape: Sequence[int]
                ) -> Optional[str]:
    """Why a cell is not run, or None."""
    from ..configs import shape_supported
    if not shape_supported(arch, shape):
        return ("full-attention arch: long_500k needs sub-quadratic "
                "attention")
    return None


def _local_bytes(tree) -> int:
    """The bytes of this rank's shards of the tensors of ``tree``."""
    import torch
    from torch.distributed.tensor import DTensor
    from ..training.pytree import tree_leaves
    n = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            n += loc.numel() * loc.element_size()
    return n


def _measure(arch, shape, mesh, opts, overrides, device) -> Dict:
    """One run of the cell's step: counts, peak and seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .cells import build_cell
    from .op_cost import analyze_step
    with FakeTensorMode():
        t0 = time.perf_counter()
        cell = build_cell(arch, shape, mesh, opts, overrides, device=device)
        t1 = time.perf_counter()
        cost = analyze_step(cell["fn"], cell["args"])
        t2 = time.perf_counter()
    return {"cell": cell, "cost": cost, "peak": cost.peak_bytes,
            "build_s": t1 - t0, "step_s": t2 - t1}


def _extend(runs, depths, L: int) -> Dict:
    """The counts at depth ``L`` on the parabola (Lagrange's form) through
    the runs at ``depths``."""
    def at(values):
        total = 0.0
        for i, (di, v) in enumerate(zip(depths, values)):
            w = 1.0
            for j, dj in enumerate(depths):
                if j != i:
                    w *= (L - dj) / (di - dj)
            total += w * v
        return total
    costs = [r["cost"] for r in runs]
    kinds = sorted({k for c in costs for k in c.collective_counts})
    return {
        "flops": at([c.flops for c in costs]),
        "bytes_accessed": at([c.bytes_accessed for c in costs]),
        "collective_bytes": at([c.collective_bytes for c in costs]),
        "collective_counts": {k: int(round(at(
            [c.collective_counts.get(k, 0) for c in costs]))) for k in kinds},
        "collective_bytes_by_kind": {k: at(
            [c.collective_bytes_by_kind.get(k, 0) for c in costs])
            for k in kinds},
        "peak": _peak_at([r["peak"] for r in runs], depths, L)}


def _peak_at(peaks, depths, L: int) -> float:
    """The peak at depth ``L``: the line through the two deepest runs (the
    parameters, moments, gradients and saved activations that make it grow
    in proportion to the depth), never below the deepest run's.  A
    maximum over the step is not a polynomial of the depth: where a fixed
    activation (the logits) makes the shallow runs' peaks, a parabola
    through three of them can bend down past zero at full depth."""
    (d0, p0), (d1, p1) = sorted(zip(depths, peaks))[-2:]
    return max(p1, p1 + (p1 - p0) / (d1 - d0) * (L - d1))


def run_cell(arch: str, shape: str, mesh, opts=None, overrides=None, *,
             device: str = "cuda", depth: str = "auto") -> Dict:
    """The dry-run record of one cell on ``mesh`` (a mesh over the live
    fake group)."""
    from ..configs import get_config
    from .cells import build_cell, cell_options
    from .mesh import HW
    opts = opts or cell_options(arch, shape)
    cfg = get_config(arch)
    L = int((overrides or {}).get("n_layers", cfg.n_layers))
    depths_at = PAIR_DEPTHS if cfg.block_kind == "xlstm" else DEPTHS
    t0 = time.perf_counter()
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        full = build_cell(arch, shape, mesh, opts, overrides, device=device)
        arg_bytes = _local_bytes(full["args"])
    lower_s = time.perf_counter() - t0
    if depth == "full" or L <= depths_at[-1]:
        runs = [_measure(arch, shape, mesh, opts, overrides, device)]
        c = runs[0]["cost"]
        got = {"flops": c.flops, "bytes_accessed": c.bytes_accessed,
               "collective_bytes": c.collective_bytes,
               "collective_counts": dict(c.collective_counts),
               "collective_bytes_by_kind": dict(c.collective_bytes_by_kind),
               "peak": runs[0]["peak"]}
        depths = [L]
    else:
        runs = [_measure(arch, shape, mesh, opts,
                         {**(overrides or {}), "n_layers": d}, device)
                for d in depths_at]
        got = _extend(runs, depths_at, L)
        depths = list(depths_at)
    peak = int(round(got.pop("peak")))
    donated = full["meta"]["kind"] == "train"
    return {
        "cell": None, "status": "ok", "meta": full["meta"],
        "device": device, "depths_run": depths,
        "peak_by_depth": [r["peak"] for r in runs],
        "lower_s": lower_s + sum(r["build_s"] for r in runs),
        "step_s": sum(r["step_s"] for r in runs),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": 0,
                   "temp_bytes": max(peak - arg_bytes, 0),
                   "alias_bytes": arg_bytes if donated else 0,
                   "peak_per_device": peak},
        "cost_analysis": {"flops": got["flops"],
                          "bytes accessed": got["bytes_accessed"]},
        "op_cost": got,
        "hbm_bytes": HW.hbm_bytes(),
        "fits80G": peak <= HW.hbm_bytes(),
    }


def cell_tag(arch: str, shape: str, mesh_tag: str) -> str:
    return f"{arch}__{shape}__{mesh_tag}".replace("/", "_")


def child(mesh_name: str, archs, shapes, out: str, force: bool,
          device: str) -> int:
    """Every cell of one mesh, in this process, under a fake group."""
    from .mesh import make_mesh
    shape_, axes = MESHES[mesh_name]
    world = 1
    for s in shape_:
        world *= s
    fake_group(world)
    mesh = make_mesh(shape_, axes, device_type=device)
    mesh_tag = "x".join(map(str, shape_))
    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = cell_tag(arch, shape, mesh_tag)
            path = os.path.join(out, tag + ".json")
            if os.path.exists(path) and not force:
                print(f"[skip-done] {tag}", flush=True)
                continue
            reason = skip_reason(arch, shape, shape_)
            if reason is not None:
                with open(path, "w") as f:
                    json.dump({"cell": tag, "status": "skipped",
                               "reason": reason}, f, indent=1)
                print(f"[skip-by-design] {tag}", flush=True)
                continue
            try:
                rec = run_cell(arch, shape, mesh, device=device)
            except Exception as e:  # noqa: BLE001 -- one record per cell
                failures += 1
                with open(path + ".fail", "w") as f:
                    json.dump({"cell": tag, "status": "fail",
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-4000:]},
                              f, indent=1)
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                continue
            rec["cell"] = tag
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            gib = rec["memory"]["peak_per_device"] / 2 ** 30
            print(f"[ok] {tag} step={rec['step_s']:.1f}s "
                  f"peak/dev={gib:.2f}GiB "
                  f"fits80G={'YES' if rec['fits80G'] else 'NO'}", flush=True)
    return 1 if failures else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ..configs import ALL_ARCHS, SHAPES
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/torch_dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="children per mesh, the archs dealt among them")
    ap.add_argument("--child", default=None, choices=list(MESHES),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = ALL_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    os.makedirs(args.out, exist_ok=True)
    if args.child:
        return child(args.child, archs, shapes, args.out, args.force,
                     args.device)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    jobs = max(1, min(args.jobs, len(archs)))
    rc = 0
    for name in meshes:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--child", name, "--arch", ",".join(archs[j::jobs]),
             "--shape", ",".join(shapes), "--out", args.out,
             "--device", args.device] + (["--force"] if args.force
                                         else []), env=env)
            for j in range(jobs)]
        rc = max([rc] + [p.wait() for p in procs])
    print(f"\ndone; exit {rc}", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
