"""The launch tooling of the port (``repro_torch.launch``) against the
reference's (``repro.launch``) on the CPU.

``cell_options`` and ``model_flops`` are pure logic: equal for every cell.
``build_cell``'s ``meta`` and its arguments' names, shapes and dtypes equal
the reference's on a one-device mesh (``eval_shape`` only on the reference
side, meta tensors on the port's; no compile, nothing runs).
``roofline_row`` keeps the reference's math with the H100's constants.
``shardings()`` gives every parameter leaf of every config the
placements that ``param_specs`` names, on the production meshes, under a
``fake`` group of 512 ranks (a subprocess: one default group a process).
The dry run's step runs under a fake group of 8 on a (4, 2) mesh at the
reference's small-mesh cell (qwen3-4b with its overrides) and at a tiny
phi3.5-moe cell (4 experts over ``model``), and at world 1 its per-device
FLOPs equal ``FlopCounterMode``'s count of the plain step.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

import jax  # noqa: F401  (before the reference package)
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

from repro.configs import ALL_ARCHS, SHAPES  # noqa: E402
from repro.launch import cells as RC  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import sharding as RSH  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import cells as PC  # noqa: E402
from repro_torch.launch import roofline as PR  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

# the reference's small-mesh cell (tests/test_launch.py)
SMALL_OVERRIDES = dict(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
                       head_dim=16, d_ff=256, vocab=512)
# a tiny MoE cell on the same mesh: 4 experts over model = 2
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_OVERRIDES = dict(d_ff=0, moe_experts=4, moe_topk=2, moe_dff=64)
# narrow cells whose heads do not divide 16 model ranks: llava-next-34b's
# 56 query heads over 8 KV heads, xlstm-350m's 4 (their published counts);
# heads of 16, the smallest size the flash kernels take (the operator's
# fake refuses a head size no kernel runs, as the card does)
UNEVEN_HEADS = {"llava-next-34b": dict(d_model=896, n_heads=56, n_kv_heads=8,
                                       head_dim=16),
                "xlstm-350m": dict(d_model=256, n_heads=4, n_kv_heads=4,
                                   head_dim=64, d_ff=0)}
TINY = {"tiny_train": dict(seq_len=64, global_batch=8, kind="train"),
        "tiny_train_16x16": dict(seq_len=32, global_batch=32, kind="train"),
        "tiny_decode": dict(seq_len=64, global_batch=8, kind="decode")}


def _run(code: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


# ---------------------------------------------------------------- options
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_options_equal_the_reference(arch, shape):
    assert dataclasses.asdict(PC.cell_options(arch, shape)) == \
        dataclasses.asdict(RC.cell_options(arch, shape))


# ------------------------------------------------------------- build_cell
@pytest.fixture(scope="module")
def unit_meshes(tmp_path_factory):
    """A (1, 1) mesh on each side: jax's one CPU device, and a gloo group
    of one rank in this process (destroyed after the module)."""
    import torch.distributed as dist
    from repro.launch.mesh import make_mesh_compat
    from repro_torch.launch.mesh import make_mesh
    store = tmp_path_factory.mktemp("unit") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield (make_mesh_compat((1, 1), ("data", "model")),
               make_mesh((1, 1), ("data", "model"), device_type="cpu"))
    finally:
        dist.destroy_process_group()


def _abstract(tree, prefix=""):
    """{path: (shape, dtype name)} of a reference tree of ShapeDtypeStructs
    or a port tree of (D)Tensors."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_abstract(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (tuple(tree.shape), str(tree.dtype).split(".")[-1])
    elif hasattr(tree, "dtype") and hasattr(tree, "shape"):
        out[prefix] = (tuple(tree.shape), str(np.dtype(tree.dtype)))
    return out


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_build_cell_matches_the_reference(arch, shape, unit_meshes,
                                          monkeypatch):
    monkeypatch.setenv("REPRO_SF_AUTOTUNE", "0")   # eval_shape, no sweep
    rmesh, pmesh = unit_meshes
    want = RC.build_cell(arch, shape, rmesh)
    got = PC.build_cell(arch, shape, pmesh)
    assert got["meta"] == want["meta"]
    assert got["name"] == want["name"]
    assert len(got["args"]) == len(want["args"])
    for g, w in zip(got["args"], want["args"]):
        wa, ga = _abstract(w), _abstract(g)
        # the decode cache's position: a host int in the port
        wa.pop("/pos", None)
        assert ga == wa
    if shape == "decode_32k":
        assert got["args"][2]["pos"] == SHAPES[shape]["seq_len"] - 1


# --------------------------------------------------------------- roofline
def _reference_record():
    """tests/test_launch.py::test_roofline_row_math's record."""
    return {
        "cell": "x", "memory": {"peak_per_device": 2 ** 30},
        "meta": {"mesh": {"data": 16, "model": 16}, "kind": "train",
                 "global_batch": 256, "seq_len": 4096,
                 "active_params": 1e9, "params": 1e9},
        "cost_analysis": {"flops": 1e12},
        "hlo_cost": {"flops": 1e12, "bytes_accessed": 1e11,
                     "collective_bytes": 1e9, "collective_counts": {}},
    }


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_the_reference(kind):
    meta = dict(_reference_record()["meta"], kind=kind)
    assert PR.model_flops(meta) == RR.model_flops(meta)


def test_roofline_row_math_with_the_h100():
    row = PR.roofline_row(_reference_record())
    assert row["compute_s"] == 1e12 / 989e12
    assert row["memory_s"] == 1e11 / 3.35e12
    assert row["collective_s"] == 1e9 / 450e9
    assert row["dominant"] == "memory"
    assert row["roofline_frac"] > 0
    assert (HW.PEAK_BF16_FLOPS, HW.HBM_BW, HW.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_roofline_reads_the_dry_runs_records(tmp_path, capsys):
    rec = _reference_record()
    rec["op_cost"] = dict(rec.pop("hlo_cost"), flops=2e12)
    rec["status"] = "ok"
    (tmp_path / "x.json").write_text(json.dumps(rec))
    (tmp_path / "y.json").write_text(json.dumps({"cell": "y",
                                                  "status": "skipped"}))
    assert [r["cell"] for r in PR.load_cells(str(tmp_path))] == ["x"]
    assert PR.roofline_row(rec)["compute_s"] == 2e12 / 989e12
    assert PR.main(["--dir", str(tmp_path), "--format", "csv"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cell,kind,compute_s") and len(lines) == 2


# -------------------------------------------------------------- shardings
def _expected_placements(spec, axes):
    """The placements a reference PartitionSpec names, written out."""
    out = ["Replicate()"] * len(axes)
    for d, entry in enumerate(tuple(spec)):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for n in names:
            out[axes.index(n)] = f"Shard(dim={d})"
    return "(" + ", ".join(out) + ")"


def test_shardings_name_the_param_specs_placements():
    got = json.loads(_run("""
        import json, torch
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import fake_group
        from repro_torch.models import transformer as T
        from repro_torch.models.sharding import param_specs, shardings
        from torch.distributed.device_mesh import DeviceMesh
        fake_group(512)
        out = {}
        for shape, axes in (((16, 16), ("data", "model")),
                            ((2, 16, 16), ("pod", "data", "model"))):
            n = 1
            for s in shape:
                n *= s
            mesh = DeviceMesh("cpu", torch.arange(n).view(shape),
                              mesh_dim_names=axes)
            for arch in %r:
                cfg = get_config(arch)
                params = T.init_params(cfg, device="meta")
                sh = shardings(mesh, param_specs(
                    params, cfg, dict(zip(axes, shape))))
                def walk(t, p):
                    if isinstance(t, dict):
                        for k, v in t.items():
                            walk(v, p + "/" + k)
                    else:
                        out["|".join((arch, "x".join(map(str, shape)),
                                      p))] = str(t.placements)
                walk(sh, "")
        print(json.dumps(out))
    """ % (ALL_ARCHS,)).splitlines()[-1])
    n = 0
    for shape, axes in (((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        mesh = types.SimpleNamespace(axis_names=axes,
                                     shape=dict(zip(axes, shape)))
        for arch in ALL_ARCHS:
            rcfg = ref_config(arch)
            rparams = jax.eval_shape(lambda k: RT.init_params(k, rcfg),
                                     jax.random.PRNGKey(0))
            specs = RSH.param_specs(rparams, rcfg, mesh)

            def walk(t, p):
                nonlocal n
                if isinstance(t, dict):
                    for k, v in t.items():
                        walk(v, p + "/" + k)
                else:
                    key = "|".join((arch, "x".join(map(str, shape)), p))
                    assert got[key] == _expected_placements(t, axes), key
                    n += 1
            walk(specs, "")
    assert n == len(got)


# ---------------------------------------------------------------- dry run
DRY_RUNS = """
    import json, torch, torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import CellOptions
    from repro_torch.launch.mesh import make_mesh
    configs.SHAPES.update(%(tiny)r)
    out = {}
    for world, shape, cells in %(runs)r:
        dryrun.fake_group(world)
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        for arch, cell, layers, depth in cells:
            ov = dict(%(ov)r, n_layers=layers, **%(arch_ov)r.get(arch, {}))
            rec = dryrun.run_cell(
                arch, cell, mesh,
                CellOptions(microbatches=2) if "train" in cell
                else CellOptions(), ov, device="cpu", depth=depth)
            out["|".join((arch, str(world), cell, str(layers),
                          depth))] = rec
        dist.destroy_process_group()
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dry_runs():
    """The dry run's records, one subprocess (a fake group at a time):
    the reference's small-mesh cells under a fake group of 8 on (4, 2),
    the train cell at 5 layers extended from 2, 3 and 4 and run whole,
    and the train cell under a fake group of 1 on (1, 1)."""
    q, m = "qwen3-4b", MOE_ARCH
    runs = [(8, (4, 2), [(q, "tiny_train", 5, "auto"),
                         (q, "tiny_train", 5, "full"),
                         (q, "tiny_decode", 4, "auto"),
                         (m, "tiny_train", 5, "auto"),
                         (m, "tiny_train", 5, "full"),
                         (m, "tiny_decode", 4, "auto")]),
            (1, (1, 1), [(q, "tiny_train", 4, "auto")]),
            (256, (16, 16), [(a, "tiny_train_16x16", 2, "full")
                             for a in UNEVEN_HEADS])]
    return json.loads(_run(DRY_RUNS % dict(
        tiny=TINY, runs=runs, ov=SMALL_OVERRIDES,
        arch_ov={m: MOE_OVERRIDES, **UNEVEN_HEADS}),
        timeout=600).splitlines()[-1])


def test_dry_run_small_mesh_cells_count(dry_runs):
    """The reference's small-mesh cells under a fake group of 8 on (4, 2):
    FLOPs, bytes and peak above 0, collectives in the train step; at 5
    layers the train step's default (2, 3 and 4 layers, extended) equals
    every layer run in FLOPs, bytes and collectives (each a polynomial of
    degree at most 2 in the depth).  The peak is a maximum over the step,
    whose largest moment can move as layers are added (this config's
    layers are small beside its fixed activations): extended, it is held
    within 5%."""
    for key in ("qwen3-4b|8|tiny_train|5|full",
                "qwen3-4b|8|tiny_decode|4|auto"):
        rec = dry_runs[key]
        oc = rec["op_cost"]
        assert rec["status"] == "ok"
        assert oc["flops"] > 0 and oc["bytes_accessed"] > 0
        assert rec["memory"]["peak_per_device"] > \
            rec["memory"]["argument_bytes"] > 0
        assert rec["fits80G"] and rec["meta"]["mesh"] == {"data": 4,
                                                          "model": 2}
    full = dry_runs["qwen3-4b|8|tiny_train|5|full"]
    ext = dry_runs["qwen3-4b|8|tiny_train|5|auto"]
    assert full["op_cost"]["collective_bytes"] > 0
    assert set(full["op_cost"]["collective_counts"]) >= {"all-reduce"}
    assert ext["depths_run"] == [2, 3, 4] and full["depths_run"] == [5]
    for k in ("flops", "bytes_accessed", "collective_bytes"):
        assert ext["op_cost"][k] == pytest.approx(full["op_cost"][k],
                                                  rel=1e-12), k
    assert ext["op_cost"]["collective_counts"] == \
        full["op_cost"]["collective_counts"]
    assert ext["memory"]["peak_per_device"] == pytest.approx(
        full["memory"]["peak_per_device"], rel=5e-2)


def test_dry_run_at_world_1_counts_the_plain_steps_flops(dry_runs):
    """Under a fake group of 1 the dry run's per-device FLOPs equal
    ``FlopCounterMode``'s count of the plain ``make_train_step`` (no mesh)
    on real tensors: the same ops at the same shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_train_step)
    cfg = get_config("qwen3-4b").scaled(**SMALL_OVERRIDES)
    params = T.init_params(cfg, device="cpu")
    opt = init_opt_state(params, OptConfig())
    step = make_train_step(cfg, OptConfig(), TrainConfig(microbatches=2),
                           donate=True)
    B, S = TINY["tiny_train"]["global_batch"], TINY["tiny_train"]["seq_len"]
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    with FlopCounterMode(display=False) as fc:
        step(params, opt, {"tokens": toks, "labels": toks})
    rec = dry_runs["qwen3-4b|1|tiny_train|4|auto"]
    assert rec["depths_run"] == [4]
    assert rec["op_cost"]["flops"] == fc.get_total_flops()
    assert rec["op_cost"]["collective_bytes"] == 0


def test_dry_run_moe_cell_counts_the_expert_exchange(dry_runs):
    """The tiny MoE cell under a fake group of 8 on (4, 2): the step's
    counts at 5 layers extended from 2, 3 and 4 equal every layer run;
    the decode step counts the FSDP all-gathers of each layer's three
    expert stacks (2 local experts x 128 x 64 bf16 each, gathered over
    data) and the all-reduce of each layer's MoE output (8 tokens x 128
    bf16, a partial sum over model)."""
    full = dry_runs[f"{MOE_ARCH}|8|tiny_train|5|full"]
    ext = dry_runs[f"{MOE_ARCH}|8|tiny_train|5|auto"]
    assert full["status"] == ext["status"] == "ok"
    assert ext["depths_run"] == [2, 3, 4] and full["depths_run"] == [5]
    for k in ("flops", "bytes_accessed", "collective_bytes"):
        assert ext["op_cost"][k] == pytest.approx(full["op_cost"][k],
                                                  rel=1e-12), k
    assert ext["op_cost"]["collective_counts"] == \
        full["op_cost"]["collective_counts"]
    dec = dry_runs[f"{MOE_ARCH}|8|tiny_decode|4|auto"]
    by = dec["op_cost"]["collective_bytes_by_kind"]
    L, E_l, D, F, B = 4, 2, SMALL_OVERRIDES["d_model"], \
        MOE_OVERRIDES["moe_dff"], TINY["tiny_decode"]["global_batch"]
    assert by["all-gather"] >= L * 3 * E_l * D * F * 2
    assert by["all-reduce"] >= L * B * D * 2
    assert dec["fits80G"] and dec["memory"]["peak_per_device"] > 0


@pytest.mark.parametrize("arch", list(UNEVEN_HEADS))
def test_dry_run_heads_that_do_not_divide_the_model_ranks(dry_runs, arch):
    """A train cell on the production mesh (16 x 16, a fake group of 256)
    whose heads do not divide the 16 model ranks: the backward of the
    head merge before the output projection takes the gradient whole
    (``sharding.merge_heads``); without that pin DTensor cannot unflatten
    it and the step raises."""
    rec = dry_runs[f"{arch}|256|tiny_train_16x16|2|full"]
    assert rec["status"] == "ok" and rec["op_cost"]["flops"] > 0
    assert rec["meta"]["mesh"] == {"data": 16, "model": 16}
    assert rec["op_cost"]["collective_counts"]["reduce-scatter"] > 0


def _loop_cost(arch: str, folded: bool, monkeypatch):
    """The op cost (``launch.op_cost.CostMode``) of one recurrence's
    forward and backward on fake tensors: hymba's ``ssm_scan`` in 8-step
    chunks, an xlstm pair in 8-step chunks (``TIME_CHUNK`` patched), 32
    steps, with the loops counted by trip or (``folded=False``) stepped."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.op_cost import CostMode
    from repro_torch.models import ssm, xlstm
    monkeypatch.setattr(xlstm, "TIME_CHUNK", 8)
    if not folded:
        monkeypatch.setattr(ssm, "_one_trip", lambda t, T: False)
        monkeypatch.setattr(xlstm, "is_fake", lambda t: False)
    cfg = get_config(arch).smoke_config().scaled(dtype="float32")
    with FakeTensorMode():
        params = T.init_params(cfg, device="cpu")
        lp = {k: v[0].detach().requires_grad_()
              for k, v in (params["pairs"] if arch == "xlstm-350m"
                           else params["blocks"]).items()}
        x = torch.empty(2, 32, cfg.d_model).requires_grad_()
        mode = CostMode()
        with mode:
            if arch == "xlstm-350m":
                y = xlstm.xlstm_pair_scan(
                    x, lp, cfg, xlstm.init_xlstm_state(cfg, 2, x.device))[0]
            else:
                y = ssm.ssm_scan(x, lp, cfg, time_chunk=8)[0]
            torch.autograd.grad(y.sum(), [x] + list(lp.values()),
                                allow_unused=True)
    monkeypatch.undo()
    return mode.cost


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_dry_run_counts_time_loops_by_trip(arch, monkeypatch):
    """The recurrences' time loops on the dry run's fake tensors run one
    step (xlstm: one whole chunk too) counted once per step
    (``op_cost.trips``): the FLOPs of a forward and backward equal the
    step-by-step count, the bytes within 10% (the per-step slices and
    their select backward, counted once a loop) and the peak within 10%."""
    a = _loop_cost(arch, True, monkeypatch)
    b = _loop_cost(arch, False, monkeypatch)
    assert a.flops == b.flops > 0
    assert a.bytes_accessed == pytest.approx(b.bytes_accessed, rel=0.1)
    assert a.peak_bytes == pytest.approx(b.peak_bytes, rel=0.1)


def test_dry_run_cli_writes_records_and_skips(tmp_path):
    """``python -m repro_torch.launch.dryrun``: a child per mesh writes
    one record per cell; hymba's long_500k (a decode step over a 524,288
    key cache, sequence-sharded over model) is ``ok`` with its peak and
    ``fits80G``, and long_500k of a full-attention family writes a
    ``skipped`` record with its reason."""
    out = _run(f"""
        from repro_torch.launch.dryrun import main
        raise SystemExit(main(["--arch", "qwen3-4b,hymba-1.5b",
                               "--shape", "long_500k", "--mesh", "single",
                               "--out", {str(tmp_path)!r},
                               "--device", "cpu", "--jobs", "2"]))
    """)
    assert "[skip-by-design] qwen3-4b__long_500k__16x16" in out
    recs = {p: json.loads((tmp_path / p).read_text())
            for p in os.listdir(tmp_path)}
    q = recs["qwen3-4b__long_500k__16x16.json"]
    h = recs["hymba-1.5b__long_500k__16x16.json"]
    assert q["status"] == "skipped" and "sub-quadratic" in q["reason"]
    assert h["status"] == "ok" and h["depths_run"] == [2, 3, 4]
    assert h["meta"]["mesh"] == {"data": 16, "model": 16}
    assert 0 < h["memory"]["peak_per_device"] and h["fits80G"]
