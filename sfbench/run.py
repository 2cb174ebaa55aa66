"""Run one cell of the benchmark once:

    python3 sfbench/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

from the root of a checkout on a machine with the cell's NVIDIA cards.  The
cell's files are found by name (``harness``): its workload file names its
configuration and its traffic driver, ``BENCHMARK.json`` names the metrics it
reports.  A run sets the program up (``setup_s`` runs from this process's
start to the window's), then with ``--trace 0`` measures the cell's
end-to-end metrics over ``--seconds``, or with ``--trace 1`` runs a fixed
amount of the same work in a profiler window and reads each per-layer
metric from it.  Once the window has closed and the peak memory is read,
the program's state is freed and the plain reference checks what the timed
path produced.  The last line of standard output is the result, as one
JSON object; an earlier line describes the card and the program's choices,
and the last lines of standard error give each number compared beside its
limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from sfbench import harness  # noqa: E402


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's CUDA libraries already build under ``build/``)."""
    cache = ROOT / "build" / "sfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device) -> dict:
    """One run of cell ``name`` on ``device``: the result object."""
    import torch
    e2e, layer = harness.cell_metrics(harness.spec(), name)
    wl = harness.workload(name)
    cell = harness.driver(wl["driver"]).Cell(harness.config(wl["config"]),
                                             wl, seed, device)
    cuda = device.type == "cuda"
    cell.setup()
    setup_s = time.perf_counter() - T0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                "count": 1}
    out = {}
    if traced:
        path = harness.trace_dir() / f"{name}.{seed}.json"
        ctx = cell.traced(path)
        ctx["peaks"] = harness.peaks(kind)
        ctx["device_kind"] = kind
        metrics = {}
        for m in layer:
            v = harness.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        out["breakdown"] = ctx["breakdown"]
        attempted, failed = ctx["attempted"], ctx["failed"]
    else:
        win = cell.window(seconds)
        wanted = {m["name"]: m["unit"] for m in e2e}
        got = dict(win["metrics"], setup_s=setup_s)
        missing = set(wanted) - set(got)
        if missing:
            raise RuntimeError(f"{name} reported no {sorted(missing)}")
        metrics = {k: {"value": got[k], "unit": u} for k, u in wanted.items()}
        attempted, failed = win["attempted"], win["failed"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dev_info["memory_peak_bytes"] = peak
    print(json.dumps({"info": {"card": harness.nvidia_smi() if cuda
                               else "cpu", "torch": torch.__version__,
                               "setup_s": setup_s, **cell.info(),
                               "max_memory_allocated": peak,
                               "trace": str(path) if traced else None}}),
          flush=True)
    cell.release()
    checks = cell.check()
    detail = {k: checks.pop(k) for k in list(checks) if k.startswith("_")}
    if detail:
        print(json.dumps({"check_detail": detail}), flush=True)
    correct = all(c["ok"] for c in checks.values()) and attempted > 0 \
        and failed == 0
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_info, **out,
            "checks": {k: {"value": c["value"], "limit": c["limit"],
                           "ok": c["ok"]} for k, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    entry = [w for w in harness.spec()["workloads"]
             if w["name"] == args.workload]
    if not entry:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    chips = entry[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    harness.emit_checks(result["checks"])
    bad = harness.loaded_forbidden()
    if bad:
        print(f"the process holds {bad}: the JAX package or JAX was "
              f"imported", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
