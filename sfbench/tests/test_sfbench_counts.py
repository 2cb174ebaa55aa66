"""The benchmark's own counts, pinned to values worked out by hand."""

import pytest

from sfbench import counts, harness
from sfbench.lm_init import lm_dims


def test_poisson_256():
    g = (256, 256, 256)
    assert counts.poisson_unknowns(g) == 16_777_216
    # 7 N less the 6 faces' missing neighbours: 7 x 256^3 - 6 x 256^2
    assert counts.poisson_nnz(g) == 117_047_296
    # 8 bytes a nonzero, x read once and y written once
    assert counts.spmv_bytes(g) == 117_047_296 * 8 + 2 * 4 * 16_777_216


@pytest.mark.parametrize("grid", [(2, 3, 4), (5, 1, 7), (16, 16, 16)])
def test_poisson_nnz_by_brute_force(grid):
    import itertools
    nnz = 0
    for p in itertools.product(*(range(n) for n in grid)):
        nnz += 1
        for d in range(3):
            for s in (-1, 1):
                q = p[d] + s
                nnz += 0 <= q < grid[d]
    assert counts.poisson_nnz(grid) == nnz


def test_phi35_moe_two_layers():
    m = lm_dims(harness.config("phi3.5-moe-2l"))
    # a layer: attention 4096 x (4096 + 2 x 1024 + 4096) = 41,943,040,
    # router 65,536, two experts 2 x 3 x 4096 x 6400 = 157,286,400, norms
    # 8,192; two layers, the final norm 4,096 and the head 131,334,144
    assert counts.active_params(m) == 529_944_576
    # 6 N + 12 L H hd (S + 1) / 2
    assert counts.train_flops_per_token(m, 4096) == 3_381_043_200
    assert counts.train_flops_per_token(m, 256) == 3_192_299_520
    assert round(counts.train_flops_per_token(m, 4096) / 1e9, 2) == 3.38
    assert round(counts.train_flops_per_token(m, 256) / 1e9, 2) == 3.19
    # 14 x pairs x H x hd x L x B
    assert counts.flash_flops_per_step(m, 1, 4096) == \
        14 * 8_390_656 * 32 * 128 * 2
    assert counts.flash_flops_per_step(m, 16, 256) == \
        14 * 32_896 * 32 * 128 * 2 * 16
