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


@pytest.mark.parametrize("arch", ["qwen3-4b", "hymba-1.5b"])
def test_torch_train_lm_runs_and_resumes_on_the_cpu(arch, tmp_path):
    """``examples/torch_train_lm.py`` trains a transformer and hymba at the
    tiny preset on the CPU, checkpoints, and a second run resumes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, os.path.join(ROOT, "examples", "torch_train_lm.py"),
           "--arch", arch, "--preset", "tiny", "--batch", "2", "--seq", "16",
           "--device", "cpu", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    runs = [subprocess.run(cmd + ["--steps", str(n)] + extra,
                           capture_output=True, text=True, env=env,
                           timeout=300, cwd=ROOT)
            for n, extra in ((2, []), (3, ["--resume"]))]
    for out in runs:
        assert out.returncode == 0, out.stderr[-4000:]
    first, second = (r.stdout.splitlines() for r in runs)
    assert first[0].startswith(f"arch={arch} params~")
    assert first[0].endswith("device=cpu")
    assert first[1].startswith("step    0 loss=") and first[-1] == "done."
    assert second[1] == "resumed from step 2"
    assert second[2].startswith("step    2 loss=") and second[-1] == "done."
