"""The command as the benchmark's checker runs it: without the cards a cell
asks for it prints no result and exits with another code than 0; on a
card (the ``cuda`` marker; skipped here) a short run of a cell prints a
correct result as its last line."""

import json
import subprocess
import sys

import pytest

from sfbench import harness


def command(*args):
    return subprocess.run([sys.executable, "sfbench/run.py", *args],
                          cwd=harness.ROOT, capture_output=True, text=True,
                          timeout=900)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = command("--workload", "phi3.5-moe-2l.train_sft256", "--seed",
                  str(2**31 + 9), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_unknown_cell_is_refused():
    out = command("--workload", "no.such_cell", "--seed", "1", "--seconds",
                  "1", "--trace", "0")
    assert out.returncode != 0 and '"correct"' not in out.stdout


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = command("--workload", "phi3.5-moe-2l.train_sft256", "--seed",
                  str(2**31 + 9), "--seconds", "3", "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checks"
