"""Each cell's control, at a size a test run holds: the plain reference put
in the program's place and computed one precision below the
configuration's comes out not correct by the cell's own limits (a
training cell's: the weights kept in bfloat16 stored in float8, every
product's operands rounded to float8; and the products alone in float8),
and the same reference in the configuration's precision comes out
correct.  (On the card, at the
cells' own sizes, ``sfbench/controls.py`` takes the readings the limits
were set from.)"""

import pytest
import torch

from sfbench import harness
from sfbench.lm_init import (Batches, flat_leaves, leaf_specs, lm_dims,
                             make_params, probe_index)
from sfbench.reference import moe_lm, stencil


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False),
                                           (torch.float32, True)])
def test_cg_control(dtype, correct):
    wl = harness.workload("poisson3d-256.cg_graph")
    conf = harness.config(wl["config"])
    limit = wl["check"]["true_rel_residual"]
    g = torch.Generator().manual_seed(harness.seed_of(3, "rhs", 0))
    b = torch.randn((24, 24, 24), generator=g)
    x, _ = stencil.cg(b, float(conf["rtol"]), int(wl["traffic"]["maxiter"]),
                      dtype)
    assert (stencil.rel_residual(b, x) <= limit) == correct


# the products alone in float8 are held by train_4k's direction of the
# first gradient; train_sft256, the same step, does not compare it
@pytest.mark.parametrize("cell,control", [
    ("phi3.5-moe-2l.train_4k", "control_fp8"),
    ("phi3.5-moe-2l.train_4k", "control_fp8_products"),
    ("phi3.5-moe-2l.train_sft256", "control_fp8")])
def test_train_control(cell, control):
    wl = harness.workload(cell)
    drv = harness.driver(wl["driver"])
    conf = harness.config(wl["config"])
    conf.update(hidden_size=128, intermediate_size=192, num_local_experts=4,
                vocab_size=512)
    traffic = dict(wl["traffic"], batch=min(wl["traffic"]["batch"], 4),
                   seq_len=64)
    m = lm_dims(conf)
    P0 = flat_leaves(make_params(conf, 17, "cpu"))
    batches = [Batches(traffic, m["vocab"], 17, "cpu").at(i)
               for i in range(1, 4)]
    probe = probe_index(conf, 17, "cpu")

    def train(mm=moe_lm.f32_mm, store=None):
        return moe_lm.train(P0, batches, m, conf["loss"], conf["optimizer"],
                            mm, store, probe)
    ref, again = train(), train()
    mm, rnd, _ = drv.STAND_INS[control]
    ctl = train(mm, {n: rnd for n, _, _, dt in leaf_specs(conf)
                     if dt == torch.bfloat16} if rnd else None)
    same = drv.compare(again, ref, wl["check"])
    assert all(c["ok"] for k, c in same.items() if not k.startswith("_"))
    low = drv.compare(ctl, ref, wl["check"])
    assert not all(c["ok"] for k, c in low.items() if not k.startswith("_"))
