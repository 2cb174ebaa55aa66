"""The benchmark's files: ``BENCHMARK.json`` within its contract, every
configuration, cell, driver and metric found by its name, and no module of
the benchmark importing JAX or the JAX package."""

import ast
import json
import re
from pathlib import Path

import pytest

from sfbench import harness

BENCH = harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def spec():
    return harness.spec()


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "sfbench/run.py"]
    assert spec["paths"] == ["sfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_run_seconds_fits_a_full_check(spec):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell to
    compile, 1,200 s spare: all inside 43,200 s."""
    cells = 24
    total = (2 + 14 * cells) * (spec["run_seconds"] + 60) + cells * 180 \
        + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(spec, kind):
    names = [e["name"] for e in spec[kind]]
    assert len(names) == len(set(names))
    for e in spec[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)


def test_entry_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("sfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        # the harness finds a per-layer metric's cells by its list
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_every_cell_reports_what_it_must(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    assert "setup_s" in e2e
    for cell in cells:
        mine, layer = harness.cell_metrics(spec, cell)
        names = {m["name"] for m in mine}
        assert "setup_s" in names and len(names) >= 2, cell
        assert layer, cell
        for m in layer:
            assert m["moves"] in names, (cell, m["name"])
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells


def test_files_found_by_name(spec):
    for c in spec["configs"]:
        conf = harness.config(c["name"])
        assert (harness.ROOT / c["file"]).is_file()
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    for w in spec["workloads"]:
        wl = harness.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert wl["why"] == w["why"]
        assert hasattr(harness.driver(wl["driver"]), "Cell")
        assert wl["check"], w["name"]
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    """Top-level names compared whole: ``repro_torch`` is allowed where
    ``repro`` is not."""
    tops = set(_imports(path))
    assert not tops & set(harness.FORBIDDEN_MODULES), tops
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in tops


def test_loaded_forbidden_compares_whole_names():
    assert harness.loaded_forbidden(["repro_torch", "repro_torch.core",
                                     "reproduce", "torch"]) == []
    assert harness.loaded_forbidden(["repro.core", "jax.numpy",
                                     "flax"]) == ["flax", "jax", "repro"]
