"""Roofline report: three terms per (arch x shape x mesh) from the dry run
(the port of ``repro/launch/roofline.py``).

  compute    = device_FLOPs / peak_FLOP/s          (989 TF/s bf16, H100)
  memory     = device_HBM_bytes / HBM_bw           (3.35 TB/s)
  collective = device_collective_bytes / link_bw   (450 GB/s NVLink each way)

Device quantities come from the dry run's per-device op count
(``launch/op_cost.py``, the record's ``op_cost``; a reference record's
``hlo_cost`` reads the same way).  The constants are ``launch.mesh.HW``:
an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.

MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE; 2·N·D for inference steps) is
compared against device_FLOPs × n_devices to expose remat/dispatch waste.

Usage:  PYTHONPATH=src python -m repro_torch.launch.roofline
        [--dir reports/torch_dryrun] [--format md|csv]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from .mesh import HW

__all__ = ["load_cells", "model_flops", "roofline_row", "main"]


def load_cells(d: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("status") == "ok":
            out.append(r)
    return out


def model_flops(meta: Dict) -> float:
    """6·N_active·D for training, 2·N_active·D_step for inference."""
    n = meta["active_params"]
    if meta["kind"] == "train":
        tokens = meta["global_batch"] * meta["seq_len"]
        return 6.0 * n * tokens
    if meta["kind"] == "prefill":
        tokens = meta["global_batch"] * meta["seq_len"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * meta["global_batch"]


def roofline_row(rec: Dict) -> Dict:
    meta = rec["meta"]
    n_dev = 1
    for v in meta["mesh"].values():
        n_dev *= v
    hc = rec.get("op_cost") or rec.get("hlo_cost", {})
    flops = hc.get("flops", rec["cost_analysis"].get("flops", 0.0))
    bts = hc.get("bytes_accessed", 0.0)
    coll = hc.get("collective_bytes", 0.0)
    t_compute = flops / HW.PEAK_BF16_FLOPS
    t_memory = bts / HW.HBM_BW
    t_coll = coll / HW.LINK_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    mf = model_flops(meta)
    useful = mf / (flops * n_dev) if flops else 0.0
    # roofline fraction: useful-compute time over the dominating term
    t_bound = max(t_compute, t_memory, t_coll, 1e-30)
    frac = (mf / n_dev / HW.PEAK_BF16_FLOPS) / t_bound
    return {
        "cell": rec["cell"],
        "mesh": "x".join(str(v) for v in meta["mesh"].values()),
        "kind": meta["kind"],
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "op_flops_dev": flops,
        "useful_frac": useful,
        "roofline_frac": frac,
        "peak_gib": rec["memory"]["peak_per_device"] / 2 ** 30,
        "collectives": hc.get("collective_counts", {}),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default="reports/torch_dryrun")
    ap.add_argument("--format", default="md", choices=["md", "csv"])
    args = ap.parse_args(argv)
    rows = [roofline_row(r) for r in load_cells(args.dir)]
    rows.sort(key=lambda r: r["cell"])
    if args.format == "csv":
        print("cell,kind,compute_s,memory_s,collective_s,dominant,"
              "useful_frac,roofline_frac,peak_gib")
        for r in rows:
            print(f"{r['cell']},{r['kind']},{r['compute_s']:.4e},"
                  f"{r['memory_s']:.4e},{r['collective_s']:.4e},"
                  f"{r['dominant']},{r['useful_frac']:.3f},"
                  f"{r['roofline_frac']:.3f},{r['peak_gib']:.2f}")
    else:
        print("| cell | compute s | memory s | collective s | bound |"
              " useful | roofline | GiB/dev |")
        print("|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['cell']} | {r['compute_s']:.2e} |"
                  f" {r['memory_s']:.2e} | {r['collective_s']:.2e} |"
                  f" {r['dominant']} | {r['useful_frac']:.2f} |"
                  f" {r['roofline_frac']:.2f} | {r['peak_gib']:.1f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
