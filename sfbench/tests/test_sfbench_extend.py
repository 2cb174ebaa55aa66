"""A new cell, configuration and per-layer metric need only new files: in a
copy of the benchmark, three new files and three new entries of
``BENCHMARK.json`` give a cell that runs, untraced and traced, with every
file already there left byte for byte as it was."""

import json
import shutil
import subprocess
import sys
import textwrap

from sfbench import harness

NEW_METRIC = '''\
"""solves_seen: solves in the traced window (a throwaway metric)."""


def read(ctx):
    return float(ctx["program"]["solves"])
'''

DRIVE = textwrap.dedent("""
    import json, sys
    sys.path[:0] = [sys.argv[1], sys.argv[2]]
    import torch
    from sfbench import run
    for traced in (False, True):
        r = run.run_cell("poisson3d-tiny.cg_tiny", 2**33 + 1, 0.1, traced,
                         torch.device("cpu"))
        print(json.dumps(r))
""")


def test_new_cell_is_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "sfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.SPEC_FILE, root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "sfbench").rglob("*")
              if p.is_file()}
    b = root / "sfbench"
    conf = harness.config("poisson3d-256")
    conf.update(name="poisson3d-tiny", grid=[8, 8, 8], reduced=["grid"])
    (b / "configs" / "poisson3d-tiny.json").write_text(json.dumps(conf))
    wl = harness.workload("poisson3d-256.cg_graph")
    wl.update(config="poisson3d-tiny", why="a throwaway cell")
    wl["traffic"]["trace_solves"] = 3
    (b / "workloads" / "poisson3d-tiny.cg_tiny.json").write_text(
        json.dumps(wl))
    (b / "metrics" / "solves_seen.py").write_text(NEW_METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "poisson3d-tiny", "source": conf["source"],
                            "file": "sfbench/configs/poisson3d-tiny.json",
                            "reduced": ["grid"], "why": "throwaway"})
    spec["workloads"].append({"name": "poisson3d-tiny.cg_tiny",
                              "config": "poisson3d-tiny", "traffic": "cg_tiny",
                              "chips": 1, "why": "a throwaway cell"})
    spec["end_to_end"][0]["workloads"].append("poisson3d-tiny.cg_tiny")
    spec["per_layer"].append({"name": "solves_seen", "unit": "solves",
                              "better": "higher", "source": "program_counter",
                              "layer": "solver: solvers/cg.py cg_async",
                              "moves": "solve_ms",
                              "workloads": ["poisson3d-tiny.cg_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run(
        [sys.executable, "-c", DRIVE, str(root), str(harness.ROOT / "src")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = [json.loads(line) for line in out.stdout.splitlines()
                     if line.startswith('{"correct"')]
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"solve_ms", "setup_s"}
    assert set(traced["metrics"]) == {"solves_seen"}
    assert traced["metrics"]["solves_seen"]["value"] == 3.0
    for p, data in before.items():
        assert p.read_bytes() == data, p
