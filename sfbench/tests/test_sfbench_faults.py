"""Whole runs of each cell on the CPU at a small size, the look for a card
skipped: a sound run comes out correct, and one with the timed path broken
underneath comes out not correct, once for each fault the cell can have.

A Poisson solve has no batch to halve; its faults are a solve that returns
its first guess unchanged, the halo exchange between the ranks left out,
an answer altered where it is produced, and solves stopped at a looser
tolerance than the configuration states.  A training step's are a step
that returns its state unchanged, half of the batch left out (the mean
taken over the rest), and every sequence's labels shifted back by one
token where the batch is produced (the feed's off-by-one).  The training
runs here take float32 weights, so that a sound run agrees with the
reference to rounding whatever the cell's limits.  The small sizes are
files of a copy of the benchmark, which the harness reads in place of the
real ones."""

import json
import shutil

import pytest
import torch

from sfbench import harness, run

CG = "poisson3d-256.cg_graph"
TRAIN = ("phi3.5-moe-2l.train_4k", "phi3.5-moe-2l.train_sft256")
SMALL = {"poisson3d-256": {"grid": [12, 12, 12]},
         "phi3.5-moe-2l": {"hidden_size": 64, "intermediate_size": 96,
                           "num_attention_heads": 4,
                           "num_key_value_heads": 2, "num_local_experts": 4,
                           "vocab_size": 256, "param_dtype": "float32"}}
SHAPES = {TRAIN[0]: {"batch": 1, "seq_len": 48},
          TRAIN[1]: {"batch": 4, "seq_len": 12}}


@pytest.fixture(autouse=True)
def small(tmp_path, monkeypatch):
    """The cells at the small sizes, in a copy of the benchmark."""
    bench = tmp_path / "sfbench"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, sizes in SMALL.items():
        (bench / "configs" / f"{name}.json").write_text(
            json.dumps(dict(harness.config(name), **sizes)))
    for cell, shape in SHAPES.items():
        wl = harness.workload(cell)
        wl["traffic"].update(shape)
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    monkeypatch.setattr(harness, "BENCH_DIR", bench)


def run_cg(seed=2**31 + 11):
    return run.run_cell(CG, seed, 0.2, False, torch.device("cpu"))


def run_train(cell, seed=2**32 + 5):
    return run.run_cell(cell, seed, 0.2, False, torch.device("cpu"))


def test_cg_sound_run_is_correct():
    r = run_cg()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"solve_ms", "setup_s"}
    assert list(r)[-1] == "checks"


def _first_guess(matvec, b, x0=None, **kw):
    from repro_torch.solvers.cg import CGResult
    return CGResult(torch.zeros_like(b), 1, 0.0, True)


def _no_halo(self, x, use_kernel=False):
    """``ParCSR.spmv`` with the ghost exchange left out: the ghost
    vector stays zero."""
    y = [self._diag_ell[r].apply(
        x[int(self.col_offsets[r]):int(self.col_offsets[r + 1])], use_kernel)
        for r in range(self.nranks)]
    return torch.cat(y)


@pytest.mark.parametrize("fault", ["state_unchanged", "exchange_left_out",
                                   "answer_altered", "loose_rtol_1e-4",
                                   "loose_rtol_1e-3"])
def test_cg_fault_is_not_correct(fault, monkeypatch):
    from repro_torch import solvers
    from repro_torch.sparse import parmat
    real = solvers.cg_async
    if fault == "state_unchanged":
        monkeypatch.setattr(solvers, "cg_async", _first_guess)
    elif fault == "exchange_left_out":
        monkeypatch.setattr(parmat.ParCSR, "spmv", _no_halo)
    elif fault == "answer_altered":
        def altered(*a, **kw):
            res = real(*a, **kw)
            res.x[res.x.numel() // 2] += 1.0
            return res
        monkeypatch.setattr(solvers, "cg_async", altered)
    else:
        def loose(*a, **kw):
            return real(*a, **dict(kw, tol=float(fault.rsplit("_", 1)[1])))
        monkeypatch.setattr(solvers, "cg_async", loose)
    r = run_cg()
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_sound_run_is_correct(cell):
    r = run_train(cell)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}


def _unchanged(params, grads, opt_state, cfg, *, inplace=False):
    from repro_torch.training.optimizer import global_norm
    return params, opt_state, {"grad_norm": global_norm(grads),
                               "lr": torch.zeros(())}


def _half_batch(batch_to):
    def cut(batch, device, float_dtype=None):
        b = batch_to(batch, device, float_dtype)
        B, S = b["tokens"].shape
        keep = (slice(0, B // 2), slice(None)) if B > 1 \
            else (slice(None), slice(0, S // 2))
        return {k: v[keep] for k, v in b.items()}
    return cut


def _label_shift(batch_to):
    def shift(batch, device, float_dtype=None):
        b = batch_to(batch, device, float_dtype)
        return dict(b, labels=b["tokens"].clone())
    return shift


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "label_shift"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.training import train_loop
    if fault == "state_unchanged":
        monkeypatch.setattr(train_loop, "adamw_update", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(train_loop, "batch_to",
                            _half_batch(train_loop.batch_to))
    else:
        monkeypatch.setattr(train_loop, "batch_to",
                            _label_shift(train_loop.batch_to))
    r = run_train(cell)
    assert not r["correct"], r["checks"]
