"""Deterministic, resumable data pipeline (the port of
``repro/training/data.py``; numpy only, so the tokens are the reference's
bit for bit).

``SyntheticLM`` — a hash-based token stream: batch(step) is a pure function
of (seed, step, data_rank), so restart-at-step-k reproduces the exact stream
with no iterator state to checkpoint (the checkpoint stores just the step).

``MemmapTokens`` — binary token-file reader (uint16/uint32 raw tokens) with
block-shuffled, rank-sharded sampling, also a pure function of step: each
data-parallel rank reads only its slice.

``make_batch`` — one batch for the architecture family; VLM and audio
batches carry precomputed embeddings, the modality frontends being stubbed
as in the reference.  Batches are numpy arrays: the train step moves them
to the parameters' device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..models.config import ModelConfig

__all__ = ["SyntheticLM", "MemmapTokens", "make_batch"]


def _hash_tokens(seed: int, step: int, rank: int, shape, vocab: int
                 ) -> np.ndarray:
    """SplitMix64-style counter-based generation: reproducible anywhere."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = (np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
             + np.uint64(rank) * np.uint64(0x94D049BB133111EB) + idx)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32).reshape(shape)


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int           # per-rank batch
    seed: int = 0
    rank: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        toks = _hash_tokens(self.seed, step, self.rank,
                            (self.batch, self.seq_len + 1), self.vocab)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclasses.dataclass
class MemmapTokens:
    """Raw binary token file; samples length-(seq+1) windows, block-shuffled,
    disjoint across data ranks; pure function of step (resume = set step)."""
    path: str
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    rank: int = 0
    world: int = 1
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.dtype(self.dtype),
                               mode="r")
        self.n_windows = (len(self._data) - 1) // (self.seq_len + 1)
        if self.n_windows <= 0:
            raise ValueError("token file shorter than one window")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        # counter-based permutation: window index via hashing, stratified by
        # (step, rank, i) so ranks never collide within a step
        g = _hash_tokens(self.seed, step, self.rank * 131071 + 7,
                         (self.batch,), self.n_windows).astype(np.int64)
        W = self.seq_len + 1
        toks = np.stack([np.asarray(self._data[w * W:(w + 1) * W])
                         for w in g]).astype(np.int32)
        toks = np.minimum(toks, self.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, step: int = 0,
               seed: int = 0, rank: int = 0,
               enc_len: int = 128) -> Dict[str, np.ndarray]:
    """One batch appropriate for the architecture family (stub frontends
    supply embeddings, as in the reference)."""
    ds = SyntheticLM(cfg.vocab, seq_len, batch, seed=seed, rank=rank)
    b = ds.batch_at(step)
    if cfg.family == "vlm":
        rng = np.random.default_rng((seed, step, rank, 1))
        b["embeds"] = rng.standard_normal(
            (batch, seq_len, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "audio":
        rng = np.random.default_rng((seed, step, rank, 2))
        b["enc_embeds"] = rng.standard_normal(
            (batch, enc_len, cfg.d_model)).astype(np.float32) * 0.02
    return b
