"""The plain references against independent formulas at small sizes, and
against the program's own ordering and model where the semantics must
agree."""

import numpy as np
import pytest
import torch

from sfbench import harness
from sfbench.lm_init import Batches, flat_leaves, lm_dims, make_params
from sfbench.reference import moe_lm, stencil


def _laplacian(grid):
    """The 7-point Dirichlet Laplacian as a dense matrix, row by row."""
    n = int(np.prod(grid))
    A = np.zeros((n, n))
    for i, p in enumerate(np.ndindex(*grid)):
        A[i, i] = 6
        for d in range(3):
            for s in (-1, 1):
                q = list(p)
                q[d] += s
                if 0 <= q[d] < grid[d]:
                    A[i, np.ravel_multi_index(q, grid)] = -1
    return A


@pytest.mark.parametrize("grid", [(4, 5, 6), (3, 3, 3)])
def test_stencil_is_the_formula(grid):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(grid)
    want = _laplacian(grid) @ x.reshape(-1)
    got = stencil.apply(torch.as_tensor(x)).numpy().reshape(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    b = torch.as_tensor(want.reshape(grid))
    assert stencil.rel_residual(b, torch.as_tensor(x)) < 1e-15


def test_global_order_is_the_dmdas():
    from repro_torch.meshdist import DMDA
    grid, pg = (4, 6, 8), (2, 2, 2)
    da = DMDA(grid, 8, proc_grid=pg, stencil="star", periodic=False)
    nat = np.stack(np.unravel_index(np.arange(np.prod(grid)), grid), 1)
    gid = da.natural_to_global(nat)
    x = torch.arange(np.prod(grid), dtype=torch.float64).reshape(grid)
    v = stencil.to_global(x, pg)
    assert torch.equal(v[torch.as_tensor(gid)], x.reshape(-1))
    assert torch.equal(stencil.to_natural(v, grid, pg), x)


def test_plain_cg_converges():
    g = torch.Generator().manual_seed(1)
    b = torch.randn((12, 12, 12), generator=g, dtype=torch.float64)
    x, it = stencil.cg(b, 1e-10, 500, torch.float64)
    assert stencil.rel_residual(b, x) < 1e-9 and 0 < it < 500


def tiny_lm(**kw):
    conf = harness.config("phi3.5-moe-2l")
    conf.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
                num_key_value_heads=2, num_local_experts=4, vocab_size=256,
                **kw)
    return conf


@pytest.mark.parametrize("batch,seq", [(1, 48), (3, 16)])
def test_reference_loss_is_the_programs(batch, seq):
    """In float32 the program's training loss and the plain reference's
    agree to rounding: the same model, read two ways."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.training.train_loop import TrainConfig, make_loss_fn
    conf = tiny_lm(param_dtype="float32")
    m = lm_dims(conf)
    params = make_params(conf, 11, "cpu")
    cfg = ModelConfig(name="tiny", family="moe", n_layers=m["n_layers"],
                      d_model=m["d_model"], n_heads=m["n_heads"],
                      n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"],
                      d_ff=0, vocab=m["vocab"], rope_theta=m["rope_theta"],
                      norm_eps=m["norm_eps"], moe_experts=m["moe_experts"],
                      moe_topk=m["moe_topk"], moe_dff=m["moe_dff"],
                      moe_capacity=m["moe_capacity"], dtype="float32")
    b = Batches({"batch": batch, "seq_len": seq, "zipf_s": 1.0}, m["vocab"],
                11, "cpu").at(1)
    got, _ = make_loss_fn(cfg, TrainConfig(**conf["loss"]))(params, b)
    want = moe_lm.loss(flat_leaves(params), b["tokens"], b["labels"], m,
                       conf["loss"])
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_batches_repeat_and_differ():
    b = Batches({"batch": 2, "seq_len": 32, "zipf_s": 1.0}, 1000, 5, "cpu")
    assert torch.equal(b.at(3)["tokens"], b.at(3)["tokens"])
    assert not torch.equal(b.at(3)["tokens"], b.at(4)["tokens"])
    assert torch.equal(b.at(3)["tokens"][:, 1:], b.at(3)["labels"][:, :-1])


def test_weights_redraw_slice_by_slice():
    from sfbench.lm_init import draw_slice, leaf_specs, slices
    conf = tiny_lm()
    p = flat_leaves(make_params(conf, 2**40 + 3, "cpu"))
    for name, shape, std, dt in leaf_specs(conf):
        for idx in slices(shape):
            assert torch.equal(p[name][idx], draw_slice(
                name, shape, std, dt, idx, 2**40 + 3, "cpu")), name
