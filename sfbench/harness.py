"""What every cell of the benchmark shares: finding its files by name, seeds,
the card's description, the profiled window and the guard against the JAX
package.

Everything a cell owns lives in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``configs/<config>.json``   the configuration's sizes and its source;
* ``workloads/<cell>.json``   the cell: its configuration, its driver, the
  traffic parameters and the limits of its correctness check;
* ``traffic/<driver>.py``     the general generator and driver of a kind of
  traffic (a class ``Cell``);
* ``metrics/<metric>.py``     the reader of one per-layer metric (``read``).

So a new cell, configuration or per-layer metric is a new file, and this
module and ``run.py`` stay as they are.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

# top-level module names that no process of the benchmark may hold: the
# JAX package beside the port, and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(SPEC_FILE)


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def _module(path: Path, name: str):
    """The module in ``path``, loaded under ``name`` (file names may hold
    dots, which an import statement cannot name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module(BENCH_DIR / "traffic" / f"{name}.py",
                   f"sfbench_traffic_{re.sub(r'[^0-9A-Za-z_]', '_', name)}")


def metric_reader(name: str):
    return _module(BENCH_DIR / "metrics" / f"{name}.py",
                   f"sfbench_metric_{re.sub(r'[^0-9A-Za-z_]', '_', name)}")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports: an
    end-to-end metric without a ``workloads`` list is every cell's; a
    per-layer metric names its cells."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def seed_of(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under the run's
    ``seed`` (any whole number; the same arguments give the same seed)."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (an
    empty string where it cannot run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()


def loaded_forbidden(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (by default what
    ``sys.modules`` holds), compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if modules is None else list(modules)
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def kernel_names(*sources: str) -> List[str]:
    """The ``__global__`` functions of the port's CUDA sources
    ``kernels/csrc/<source>.cu``: the names their launches carry in a
    device trace."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    names = []
    for s in sources:
        names += pat.findall((csrc / f"{s}.cu").read_text())
    return names


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind``, or None for a card
    the table does not hold."""
    return load_json(BENCH_DIR / "peaks.json").get(kind)


def trace_dir() -> Path:
    """Where a traced run writes its chrome trace: under ``TMPDIR``, or
    in the checkout's ignored ``build/`` where no ``TMPDIR`` is set."""
    tmp = os.environ.get("TMPDIR")
    d = (Path(tmp) if tmp else ROOT / "build") / "sfbench_traces"
    d.mkdir(parents=True, exist_ok=True)
    return d


def emit_checks(checks: Dict[str, dict]) -> None:
    """Each number compared beside its limit, one line each on standard
    error (the run's last lines there)."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr,
              flush=True)
