"""Carry reference state across from numpy arrays only.

The port never imports the JAX package; a caller that has reference
objects reads their arrays out (``repro.core.graph.RankGraph`` fields,
``repro.sparse.parmat.ParCSR`` blocks, a distributed mesh's per-rank
arrays, a model's param pytree) and hands them over here as plain dicts,
lists and tuples.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .core.device import resolve_device
from .core.graph import RankGraph, StarForest
from .meshdist.plex import DistributedMesh, HexMesh
from .models.config import ModelConfig
from .models.transformer import init_params, require_supported
from .sparse.csr import LocalCSR
from .sparse.parmat import ParCSR

__all__ = ["star_forest_from_arrays", "parcsr_from_arrays",
           "distributed_mesh_from_arrays", "params_from_arrays",
           "opt_state_from_arrays"]


def star_forest_from_arrays(nranks: int,
                            graphs: Sequence[Dict[str, object]]
                            ) -> StarForest:
    """A set-up StarForest from one dict per rank with the fields of
    ``RankGraph``: ``nroots``, ``nleafspace``, ``local``, ``remote_rank``,
    ``remote_offset``."""
    if len(graphs) != nranks:
        raise ValueError(f"{len(graphs)} rank graphs for {nranks} ranks")
    return StarForest.from_rank_graphs([
        RankGraph(nroots=int(g["nroots"]), nleafspace=int(g["nleafspace"]),
                  local=np.asarray(g["local"], dtype=np.int64),
                  remote_rank=np.asarray(g["remote_rank"], dtype=np.int64),
                  remote_offset=np.asarray(g["remote_offset"],
                                           dtype=np.int64))
        for g in graphs])


Block = Tuple[Tuple[int, int], np.ndarray, np.ndarray, np.ndarray]


def parcsr_from_arrays(nranks: int, row_offsets, col_offsets,
                       diag: List[Block], offd: List[Block],
                       garray: List[np.ndarray], dtype=np.float32,
                       device=None) -> ParCSR:
    """A ParCSR from per-rank ``(shape, indptr, indices, data)`` blocks."""
    def block(b: Block) -> LocalCSR:
        shape, indptr, indices, data = b
        return LocalCSR((int(shape[0]), int(shape[1])),
                        np.asarray(indptr, dtype=np.int64),
                        np.asarray(indices, dtype=np.int64),
                        np.asarray(data))
    return ParCSR(nranks, np.asarray(row_offsets), np.asarray(col_offsets),
                  [block(b) for b in diag], [block(b) for b in offd],
                  [np.asarray(g, dtype=np.int64) for g in garray],
                  dtype=dtype, device=device)


def distributed_mesh_from_arrays(shape: Sequence[int], cells: Sequence,
                                 cones: Sequence, labels: Sequence
                                 ) -> DistributedMesh:
    """A DistributedMesh of ``HexMesh(*shape)`` from per-rank global cell
    ids, ``(n, 8)`` cones and labels, with its local setup (vertex
    numbering, coordinates, owners) done."""
    if not len(cells) == len(cones) == len(labels):
        raise ValueError(f"{len(cells)} cell, {len(cones)} cone and "
                         f"{len(labels)} label arrays")
    as64 = lambda arrays: [np.asarray(a, dtype=np.int64) for a in arrays]
    return DistributedMesh(HexMesh(*(int(e) for e in shape)), len(cells),
                           as64(cells), as64(cones),
                           as64(labels)).setup_local()


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype on ``device``; bfloat16
    arrays (numpy's ``ml_dtypes`` extension type) go across as their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def params_from_arrays(cfg: ModelConfig, tree: Dict, *,
                       device=None) -> Dict:
    """The port's params from the reference's param pytree given as nested
    dicts of numpy arrays (``{"embed", "final_norm", "lm_head"?,
    "blocks": {...}}``, or ``"pairs"`` for xlstm, plus ``"enc_blocks"``,
    ``"enc_norm"`` and ``"cross_blocks"`` for an encoder-decoder), name for
    name and in the same dtype.  The names, shapes and dtypes must be the
    ones ``models.transformer.init_params`` makes for ``cfg``: for a MoE
    config the blocks carry ``router`` (L, D, E) in float32, ``w_in`` /
    ``w_gate`` (L, E, D, F) and ``w_out`` (L, E, F, D), and ``shared_*``
    only when ``moe_shared_ff`` is set; hymba's blocks add the SSM leaves
    (``w_dt``, ``b_dt``, ``a_log`` in float32) and ``ln_attn_out`` /
    ``ln_ssm_out``; xlstm's pairs carry their gate weights and biases in
    float32."""
    require_supported(cfg)
    dev = resolve_device(device)

    def convert(where: str, spec: Dict, arrays: Dict) -> Dict:
        if set(arrays) != set(spec):
            raise KeyError(f"params{where} have {sorted(arrays)}, {cfg.name} "
                           f"needs {sorted(spec)}")
        out = {}
        for name, leaf in spec.items():
            if isinstance(leaf, dict):
                out[name] = convert(f"{where}.{name}", leaf, arrays[name])
                continue
            t = _tensor(arrays[name], dev)
            if t.shape != leaf.shape or t.dtype != leaf.dtype:
                raise ValueError(f"params{where}.{name}: {t.dtype} "
                                 f"{tuple(t.shape)}, {cfg.name} needs "
                                 f"{leaf.dtype} {tuple(leaf.shape)}")
            out[name] = t
        return out
    return convert("", init_params(cfg, device="meta"), tree)


def opt_state_from_arrays(params: Dict, tree: Dict) -> Dict:
    """The port's AdamW state (``training.optimizer``) from the
    reference's, given as numpy arrays: ``{"m", "v", "step"}`` where ``m``
    and ``v`` mirror ``params`` (the port's, e.g. from
    :func:`params_from_arrays`) with, at each parameter, a float32 or
    bfloat16 array of its shape or an int8 moment ``{"q": int8 of its
    shape, "s": float32 of its shape[:-1] + (1,)}``.  Each moment goes to
    its parameter's device; ``step`` becomes an int32 scalar there."""
    def moment(where: str, p, m):
        if isinstance(p, dict):
            if not isinstance(m, dict) or set(m) != set(p):
                raise KeyError(f"opt state{where} does not mirror the "
                               f"params' {sorted(p)}")
            return {k: moment(f"{where}.{k}", p[k], m[k]) for k in p}
        if isinstance(m, dict):
            if set(m) != {"q", "s"}:
                raise KeyError(f"opt state{where}: an int8 moment has "
                               f"q and s, got {sorted(m)}")
            q, sc = _tensor(m["q"], p.device), _tensor(m["s"], p.device)
            want_s = tuple(p.shape[:-1]) + (1,)
            if q.dtype != torch.int8 or tuple(q.shape) != tuple(p.shape) \
                    or sc.dtype != torch.float32 \
                    or tuple(sc.shape) != want_s:
                raise ValueError(f"opt state{where}: q {q.dtype} "
                                 f"{tuple(q.shape)}, s {sc.dtype} "
                                 f"{tuple(sc.shape)} for a parameter of "
                                 f"shape {tuple(p.shape)}")
            return {"q": q, "s": sc}
        t = _tensor(m, p.device)
        if tuple(t.shape) != tuple(p.shape) or \
                t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"opt state{where}: {t.dtype} "
                             f"{tuple(t.shape)} for a parameter of shape "
                             f"{tuple(p.shape)}")
        return t

    if set(tree) != {"m", "v", "step"}:
        raise KeyError(f"opt state has {sorted(tree)}, needs m, v, step")
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    step = torch.as_tensor(np.asarray(tree["step"]).astype(np.int32),
                           device=leaf.device)
    if step.dim() != 0:
        raise ValueError(f"opt state step has shape {tuple(step.shape)}")
    return {"m": moment(".m", params, tree["m"]),
            "v": moment(".v", params, tree["v"]), "step": step}
