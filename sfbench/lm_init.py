"""The training cells' inputs, made by the benchmark from ``--seed`` and handed
alike to the program and to the plain reference: the weights of a pre-norm
GQA transformer with top-k experts (under the program's leaf names and
layer-stacked shapes), and seeded batches of token sequences.

Every weight slice (a layer's matrix, a layer's expert, a block of an
embedding's rows) is drawn on the device by a ``torch.Generator`` of its
own, seeded from ``(seed, leaf, slice)``: the weights are a few hundred large
draws, and any slice can be drawn again alone, bit for bit, which is how the
check recovers the initial weights after the program has updated its own in
place.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from .harness import seed_of

__all__ = ["lm_dims", "leaf_specs", "slices", "draw_slice", "make_params",
           "flat_leaves", "probe_index", "Batches"]

# rows of an embedding or head drawn by one generator
_ROW_BLOCK = 8192
# entries of a leaf at which the check compares the first gradient's
# direction
PROBE = 1 << 20

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def lm_dims(conf: dict) -> dict:
    """The sizes the model is built from, read from a configuration whose
    keys are the published ``config.json``'s, with the run's own keys."""
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    return {"d_model": D, "n_layers": conf["num_hidden_layers"],
            "n_heads": H, "n_kv_heads": conf["num_key_value_heads"],
            "head_dim": conf.get("head_dim") or D // H,
            "vocab": conf["vocab_size"],
            "moe_experts": conf["num_local_experts"],
            "moe_topk": conf["num_experts_per_tok"],
            "moe_dff": conf["intermediate_size"],
            "rope_theta": float(conf["rope_theta"]),
            "norm_eps": float(conf["rms_norm_eps"]),
            "moe_capacity": float(conf["moe_capacity_factor"])}


def leaf_specs(conf: dict) -> List[Tuple[str, tuple, float, torch.dtype]]:
    """``(name, shape, std, dtype)`` of every leaf; std 0 marks a leaf of
    ones (the norm scales).  Scaled as the program's own initializer scales
    them: 1/sqrt(fan-in), the output projections also by 1/sqrt(2 L)."""
    m = lm_dims(conf)
    D, L, V = m["d_model"], m["n_layers"], m["vocab"]
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    E, F = m["moe_experts"], m["moe_dff"]
    w = DTYPES[conf["param_dtype"]]
    nd = DTYPES[conf["norm_dtype"]]
    rd = DTYPES[conf["router_dtype"]]
    s, so = 1.0 / math.sqrt(D), 1.0 / math.sqrt(2 * L)
    return [("embed", (V, D), 0.02, w),
            ("final_norm", (D,), 0.0, nd),
            ("lm_head", (D, V), 0.02, w),
            ("blocks.ln1", (L, D), 0.0, nd),
            ("blocks.ln2", (L, D), 0.0, nd),
            ("blocks.wq", (L, D, H * hd), s, w),
            ("blocks.wk", (L, D, Hkv * hd), s, w),
            ("blocks.wv", (L, D, Hkv * hd), s, w),
            ("blocks.wo", (L, H * hd, D), s * so, w),
            ("blocks.router", (L, D, E), s, rd),
            ("blocks.w_in", (L, E, D, F), s, w),
            ("blocks.w_gate", (L, E, D, F), s, w),
            ("blocks.w_out", (L, E, F, D), so / math.sqrt(F), w)]


def slices(shape: tuple) -> Iterator[tuple]:
    """The index of each slice a leaf is drawn in: one a layer (and
    expert) of a stack, blocks of rows of a matrix."""
    if len(shape) >= 4:
        for i in range(shape[0]):
            for j in range(shape[1]):
                yield (i, j)
    elif len(shape) == 3:
        for i in range(shape[0]):
            yield (i,)
    elif len(shape) == 2:
        for r in range(0, shape[0], _ROW_BLOCK):
            yield (slice(r, min(r + _ROW_BLOCK, shape[0])),)
    else:
        yield ()


def draw_slice(name: str, shape: tuple, std: float, dtype: torch.dtype,
               index: tuple, seed: int, device) -> torch.Tensor:
    """Slice ``index`` of leaf ``name``, drawn again from its own
    generator."""
    sub = torch.empty(shape, device="meta")[index].shape
    if std == 0.0:
        return torch.ones(sub, dtype=dtype, device=device)
    tag = tuple(i.start if isinstance(i, slice) else i for i in index)
    g = torch.Generator(device=device).manual_seed(
        seed_of(seed, "weights", name, tag))
    return torch.randn(sub, generator=g, device=device).mul_(std).to(dtype)


def make_params(conf: dict, seed: int, device) -> Dict:
    """The weights of ``conf`` from ``seed``, as the program's nested dict
    (``blocks`` holding the layer-stacked leaves)."""
    out: Dict = {"blocks": {}}
    for name, shape, std, dt in leaf_specs(conf):
        t = torch.empty(shape, dtype=dt, device=device)
        for idx in slices(shape):
            t[idx] = draw_slice(name, shape, std, dt, idx, seed, device)
        if name.startswith("blocks."):
            out["blocks"][name.split(".", 1)[1]] = t
        else:
            out[name] = t
    return out


def flat_leaves(params: Dict) -> Dict[str, torch.Tensor]:
    """The leaves of a nested parameter dict under dotted names."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flat_leaves(v).items():
                out[f"{k}.{kk}"] = vv
        else:
            out[k] = v
    return out


def probe_index(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """For each leaf, the flat positions at which the check compares the
    direction of the first gradient: every position of a leaf of at most
    ``PROBE`` entries, else ``PROBE`` positions drawn from the seed."""
    out = {}
    for name, shape, _, _ in leaf_specs(conf):
        n = math.prod(shape)
        if n <= PROBE:
            out[name] = torch.arange(n, device=device)
            continue
        g = torch.Generator(device=device).manual_seed(
            seed_of(seed, "probe", name))
        out[name] = torch.randint(n, (PROBE,), generator=g, device=device)
    return out


class Batches:
    """Seeded batches of ``batch`` sequences of ``seq_len`` tokens, each
    step's drawn on the device by its own generator: token ids from a Zipf
    law of exponent ``zipf_s`` over the vocabulary in an order drawn from
    the seed (text's skew: a few ids take much of the mass), labels the
    next token."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        self.B, self.S = int(traffic["batch"]), int(traffic["seq_len"])
        self.seed, self.device = seed, device
        g = torch.Generator(device=device).manual_seed(
            seed_of(seed, "vocab order"))
        self.order = torch.randperm(vocab, generator=g, device=device)
        rank = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
        p = rank ** -float(traffic["zipf_s"])
        self.cdf = torch.cumsum(p / p.sum(), 0).float()
        self.cdf[-1] = 1.0

    def at(self, step: int) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device=self.device).manual_seed(
            seed_of(self.seed, "batch", step))
        u = torch.rand(self.B * (self.S + 1), generator=g,
                       device=self.device)
        ids = torch.searchsorted(self.cdf, u).clamp_(max=self.cdf.numel() - 1)
        seq = self.order[ids].reshape(self.B, self.S + 1)
        return {"tokens": seq[:, :-1].contiguous(),
                "labels": seq[:, 1:].contiguous()}
