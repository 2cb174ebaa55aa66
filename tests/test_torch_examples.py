"""Smoke test of the port's examples on the CPU: each runs to its end as a
user runs it (a fresh process, ``--device cpu``) and prints its results."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_torch_quickstart_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_quickstart.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    text = out.stdout
    assert "registered backends: ['cuda', 'dist', 'global']" in text
    assert "select_backend: global" in text
    assert "bcast(replace): [10.0, 11.0, 12.0, 11.0, 0.0, 14.0, 0.0, " \
           "14.0, 13.0]" in text
    assert "reduce(sum) of ones == degrees: [1.0, 2.0, 1.0, 1.0, 2.0]" in text
    assert "bcast_multi" in text and "fetch_and_add slots" in text
    # the "dist" section: the 3-rank group selects the backend, and every
    # rank's global result is the single-program one
    assert "'dist' over 3 gloo ranks" in text
    dist_part = text[text.index("'dist' over 3 gloo ranks"):]
    assert "bcast(replace): [10.0, 11.0, 12.0, 11.0, 0.0, 14.0, 0.0, " \
           "14.0, 13.0]" in dist_part
    assert "reduce(sum) of ones: [1.0, 2.0, 1.0, 1.0, 2.0]" in dist_part
