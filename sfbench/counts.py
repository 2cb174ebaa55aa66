"""The benchmark's own counts of work: operations and bytes worked out from a
configuration alone, never from the program, so that a roofline or a
utilization reads the same work whatever implements it.

Poisson (PETSc ``ex45.c``'s 7-point Laplacian, homogeneous Dirichlet):
  nonzeros  7 N less one for each neighbour outside the grid;
  SpMV bytes  8 a nonzero (a float32 value and an int32 column), x read
  once and y written once (4 bytes an unknown each); padding of any
  storage format counts as nothing.

Language-model training (a pre-norm GQA transformer with top-k experts):
  model FLOPs a token  6 x (active non-embedding parameters + the LM head)
  + 12 L H hd x (visible causal pairs a token), the pairs of a sequence of S
  being S (S + 1) / 2; recomputation under remat and capacity padding count
  as nothing;
  attention FLOPs a step  (4 forward + 10 backward) x pairs x H x hd, for
  each layer and sequence.
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["poisson_unknowns", "poisson_nnz", "spmv_bytes", "causal_pairs",
           "active_params", "train_flops_per_token", "flash_flops_per_step",
           "train_tokens_per_step"]


def poisson_unknowns(grid: Sequence[int]) -> int:
    return math.prod(int(g) for g in grid)


def poisson_nnz(grid: Sequence[int]) -> int:
    """Nonzeros of the 7-point Laplacian on ``grid`` with the neighbours
    outside it dropped: each axis of extent n has n - 1 neighbour pairs a
    line, two nonzeros each."""
    n = poisson_unknowns(grid)
    off = 0
    for d, ext in enumerate(grid):
        off += 2 * (ext - 1) * (n // ext)
    return n + off


def spmv_bytes(grid: Sequence[int], value_bytes: int = 4,
               index_bytes: int = 4) -> int:
    """The least bytes one SpMV moves: every nonzero's value and column
    once, x read once and y written once."""
    n = poisson_unknowns(grid)
    return poisson_nnz(grid) * (value_bytes + index_bytes) + 2 * n * \
        value_bytes


def causal_pairs(seq_len: int) -> int:
    """(query, key) pairs a causal mask lets through in one sequence."""
    return seq_len * (seq_len + 1) // 2


def active_params(m: dict) -> int:
    """Parameters a token touches outside the embedding: attention,
    router, its top-k experts (and a shared expert), the norms, the final
    norm and the LM head.  ``m`` is a configuration's ``model`` group."""
    D, L = m["d_model"], m["n_layers"]
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = D * H * hd + 2 * D * Hkv * hd + H * hd * D
    ff = m["moe_topk"] * 3 * D * m["moe_dff"] + D * m["moe_experts"] \
        + 3 * D * m.get("moe_shared_ff", 0)
    layer = attn + ff + 2 * D
    return L * layer + D + D * m["vocab"]


def train_flops_per_token(m: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token (forward and backward)."""
    attn = 12 * m["n_layers"] * m["n_heads"] * m["head_dim"] * \
        causal_pairs(seq_len) / seq_len
    return 6.0 * active_params(m) + attn


def flash_flops_per_step(m: dict, batch: int, seq_len: int) -> float:
    """The attention core's FLOPs in one step: 4 pairs H hd forward (q k^T
    and p v) and 10 backward (the scores again, dv, dp, dq and dk), over
    the visible causal pairs of every layer and sequence."""
    return 14.0 * causal_pairs(seq_len) * m["n_heads"] * m["head_dim"] * \
        m["n_layers"] * batch

