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


def _example(name: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=timeout,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_torch_async_cg_runs_on_the_cpu():
    """CG and the fused-loop CGAsync converge to the same x
    (``examples/async_cg.py``'s demo)."""
    lines = _example("torch_async_cg.py").splitlines()
    assert lines[0].startswith("CG       : iters=") and \
        lines[0].endswith("converged=True")
    assert lines[1].startswith("CGAsync  : iters=") and \
        lines[1].endswith("converged=True")
    assert lines[0].split()[2] == lines[1].split()[2]   # the same iters
    assert lines[3] == "max |x_cg - x_async| = 0.00e+00"
    assert lines[-1].endswith("us/iter on cpu")


def test_torch_mesh_distribution_runs_on_the_cpu():
    """Every layout distributes, the ghost assembly counts 8 hexes at every
    owned vertex, and one bcast fills the 2-level overlap."""
    text = _example("torch_mesh_distribution.py")
    for kind in ("seq", "chunks", "rand"):
        assert f"{kind:7s}: cells/rank=64..64" in text
    assert "every owned vertex counts 8 incident hexes -> True" in text
    assert "one bcast fills every halo correctly -> True" in text


def test_torch_multigrid_poisson_runs_on_the_cpu():
    """The stash flushes once; V(1,1)-PCG converges in fewer iterations
    than plain CG (the reference's demo: 88 against 8)."""
    text = _example("torch_multigrid_poisson.py")
    assert "1 flush (= one SF reduce)" in text
    assert "hierarchy: (33, 33) -> (17, 17) -> (9, 9) -> (5, 5)" in text
    plain = [ln for ln in text.splitlines() if ln.startswith("plain CG")][0]
    pre = [ln for ln in text.splitlines() if ln.startswith("V(1,1)-PCG")][0]
    assert "converged=True" in plain and "converged=True" in pre
    assert int(pre.split(":")[1].split()[0]) * 4 < \
        int(plain.split(":")[1].split()[0])


def test_torch_serve_lm_runs_on_the_cpu():
    """Nine requests through ``ServeEngine`` with 4 slots: every request
    gets its 12 tokens."""
    lines = _example("torch_serve_lm.py").splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == \
        ["req 0", "req 1", "req 2"]
    for ln in lines[:3]:
        assert len(ln.split("-> ")[1].strip("[]").split(",")) == 12
    assert lines[-1].startswith("... 9 requests, 108 tokens in")
    assert lines[-1].endswith("continuous batching, cpu)")
