"""The readings that the limits of a cell's correctness check are set from,
on the card at the cell's own size, several seeds in one process:

    python3 sfbench/controls.py --workload <cell> --seeds 12 --controls 3

The cell's traffic driver takes them (its ``controls``): the program's
readings on every seed, each its run of the cell's timed path checked
against the plain reference as a run checks it; and, on the first
``--controls`` seeds, the control's (the plain reference put in the
program's place and computed one precision below the configuration's)
and each planted fault's.  One JSON line a reading; the benchmark's own
runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from sfbench import harness  # noqa: E402

SEED0 = 7_000_000_000


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=SEED0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("controls run on the card", file=sys.stderr)
        return 2
    wl = harness.workload(args.workload)
    seeds = [args.seed0 + 7919 * i for i in range(args.seeds)]
    emit(kind="card", card=harness.nvidia_smi(), torch=torch.__version__)
    harness.driver(wl["driver"]).controls(
        args.workload, wl, harness.config(wl["config"]), seeds,
        args.controls, torch.device("cuda", 0), emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
