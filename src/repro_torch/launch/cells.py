"""Cell builder: (architecture x input shape x mesh) -> a step and its
abstract arguments (the port of ``repro/launch/cells.py``).

A *cell* binds an architecture config, one of the input shapes, per-cell
run options (microbatching, optimizer-state dtype: the knobs that make the
big configs fit) and the mesh, and gives the step function with abstract
arguments: DTensors over meta tensors (or over fake tensors, when built
under the dry run's ``FakeTensorMode``), placed by the spec rules, with
no memory behind them (the reference's ``ShapeDtypeStruct`` leaves with
their ``NamedSharding``).  Each rank's shard is made at its local shape
directly, so no whole tensor exists in the dry run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs import SHAPES, get_config, shape_supported
from ..models import transformer as T
from ..models.config import torch_dtype
from ..models.meshed import wrap_local
from ..models.sharding import (NamedSharding, batch_spec, cache_specs,
                               dp_axes, param_specs, shardings)
from ..training.optimizer import OptConfig
from ..training.train_loop import TrainConfig, make_train_step
from .mesh import mesh_sizes

__all__ = ["CellOptions", "cell_options", "build_cell", "abstractify",
           "input_specs", "WHISPER_ENC_LEN"]

WHISPER_ENC_LEN = 1536   # stubbed mel-frame count (the frontend stub)


@dataclasses.dataclass(frozen=True)
class CellOptions:
    microbatches: int = 1
    moments_dtype: str = "float32"
    grad_dtype: str = "float32"
    remat: str = "block"
    seq_shard: bool = False


def cell_options(arch: str, shape: str) -> CellOptions:
    """Per-cell run options: the memory-fitting decisions."""
    kind = SHAPES[shape]["kind"]
    if kind != "train":
        return CellOptions()
    big = arch in ("mistral-large-123b", "kimi-k2-1t-a32b", "llava-next-34b",
                   "qwen3-14b", "phi3.5-moe-42b-a6.6b")
    mb = 8 if big else 4
    if arch == "kimi-k2-1t-a32b":
        # 1T params: 8-bit moments + bf16 grad accumulation
        return CellOptions(microbatches=16, moments_dtype="int8",
                           grad_dtype="bfloat16", seq_shard=True)
    if arch == "mistral-large-123b":
        return CellOptions(microbatches=mb, moments_dtype="bfloat16",
                           grad_dtype="bfloat16", seq_shard=True)
    if arch == "llava-next-34b":
        return CellOptions(microbatches=mb, moments_dtype="bfloat16",
                           seq_shard=True)
    return CellOptions(microbatches=mb)


def abstract_leaf(shape, dtype, sharding: NamedSharding,
                  device="meta") -> torch.Tensor:
    """A DTensor of ``shape`` and ``dtype`` in ``sharding``'s layout whose
    local shard is ``torch.empty`` at its local shape on ``device``; a
    0-dim leaf is a plain tensor."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return torch.empty((), dtype=dtype, device=device)
    t = torch.empty(local_shape(shape, sharding), dtype=dtype,
                    device=device)
    return wrap_local(t, sharding.mesh, sharding.placements, shape)


def local_shape(shape, sharding: NamedSharding) -> tuple:
    """This rank's shard shape of a ``shape`` tensor in ``sharding``'s
    layout: ``torch.chunk``'s split on each sharded dimension, mesh
    dimensions outermost first (DTensor's rule), from the rank's mesh
    coordinate alone (no tensor is read, so it runs under
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import Shard
    local = list(shape)
    coord = sharding.mesh.get_coordinate()
    for j, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            n, k = local[p.dim], sharding.mesh.size(j)
            size = -(-n // k)
            local[p.dim] = max(0, min(size, n - coord[j] * size))
    return tuple(local)


def abstractify(tree, sharding_tree, device="meta"):
    """A tree of tensors (or anything with ``shape`` and ``dtype``) as
    abstract DTensors placed by ``sharding_tree``."""
    if isinstance(tree, dict):
        return {k: abstractify(v, sharding_tree[k], device)
                for k, v in tree.items()}
    return abstract_leaf(tree.shape, tree.dtype, sharding_tree, device)


def _opt_specs(params_specs, cfg_moments: str):
    """Optimizer-state specs mirroring the param specs (ZeRO-3); an int8
    moment's scale ``s`` takes ``(*spec[:-1], None)``."""
    def leaf(ps):
        if cfg_moments == "int8":
            tail = list(ps) if ps is not None else []
            s_spec = tuple(tail[:-1] + [None]) if tail else ()
            return {"q": ps, "s": s_spec}
        return ps

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return leaf(t)
    return {"m": walk(params_specs), "v": walk(params_specs), "step": ()}


def _opt_abstract(params_abs, moments: str):
    """The shapes and dtypes of ``init_opt_state``'s tree, as meta
    tensors."""
    def leaf(p):
        if moments == "int8":
            return {"q": torch.empty(p.shape, dtype=torch.int8,
                                     device="meta"),
                    "s": torch.empty(tuple(p.shape[:-1]) + (1,),
                                     dtype=torch.float32, device="meta")}
        dt = torch.bfloat16 if moments == "bfloat16" else torch.float32
        return torch.empty(p.shape, dtype=dt, device="meta")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return leaf(t)
    return {"m": walk(params_abs), "v": walk(params_abs),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _meta_like(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def build_cell(arch: str, shape: str, mesh,
               opts: Optional[CellOptions] = None,
               cfg_overrides: Optional[Dict[str, Any]] = None, *,
               device="meta"):
    """Returns dict(name, fn, args, cfg, meta) or None if the (arch,
    shape) cell is skipped by design.  ``fn(*args)`` runs the cell's step
    on abstract DTensors (``device``: their local tensors' device; build
    under ``FakeTensorMode`` with ``device="cpu"`` to run it)."""
    if not shape_supported(arch, shape):
        return None
    sh = SHAPES[shape]
    S, B, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    opts = opts or cell_options(arch, shape)
    cfg = get_config(arch).scaled(remat=opts.remat, seq_shard=opts.seq_shard,
                                  **(cfg_overrides or {}))
    sizes = mesh_sizes(mesh)
    params_meta = T.init_params(cfg, device="meta")
    pspecs = param_specs(params_meta, cfg, sizes)
    psh = shardings(mesh, pspecs)
    dp = dp_axes(sizes)
    dpe = dp if len(dp) != 1 else dp[0]
    bs = batch_spec(sizes)
    name = f"{arch}|{shape}|{'x'.join(str(s) for s in sizes.values())}"
    meta = {"arch": arch, "shape": shape, "kind": kind, "seq_len": S,
            "global_batch": B, "mesh": dict(sizes),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "options": dataclasses.asdict(opts)}
    params_abs = abstractify(params_meta, psh, device)
    dt = torch_dtype(cfg.dtype)

    if kind == "train":
        ocfg = OptConfig(moments_dtype=opts.moments_dtype)
        tcfg = TrainConfig(microbatches=opts.microbatches,
                           grad_dtype=opts.grad_dtype)
        opt_abs = abstractify(
            _opt_abstract(params_meta, opts.moments_dtype),
            shardings(mesh, _opt_specs(pspecs, opts.moments_dtype)), device)
        batch = {"tokens": _meta_like((B, S), torch.int32),
                 "labels": _meta_like((B, S), torch.int32)}
        bspecs = {"tokens": bs, "labels": bs}
        if cfg.family == "vlm":
            batch = {"embeds": _meta_like((B, S, cfg.d_model), dt),
                     "labels": batch["labels"]}
            bspecs = {"embeds": (dpe, None, None), "labels": bs}
        if cfg.family == "audio":
            batch["enc_embeds"] = _meta_like((B, WHISPER_ENC_LEN,
                                              cfg.d_model), dt)
            bspecs["enc_embeds"] = (dpe, None, None)
        bsh = shardings(mesh, bspecs)
        fn = make_train_step(cfg, ocfg, tcfg, donate=True,
                             param_shardings=psh, batch_shardings=bsh)
        return dict(name=name, fn=fn,
                    args=(params_abs, opt_abs,
                          abstractify(batch, bsh, device)),
                    cfg=cfg, meta=meta)

    if kind == "prefill":
        inputs: Dict[str, Any] = {}
        ispecs: Dict[str, Any] = {}
        if cfg.family == "vlm":
            inputs["embeds"] = _meta_like((B, S, cfg.d_model), dt)
            ispecs["embeds"] = (dpe, None, None)
        else:
            inputs["tokens"] = _meta_like((B, S), torch.int32)
            ispecs["tokens"] = bs
        if cfg.family == "audio":
            inputs["enc_embeds"] = _meta_like((B, WHISPER_ENC_LEN,
                                               cfg.d_model), dt)
            ispecs["enc_embeds"] = (dpe, None, None)

        def prefill_fn(params, inputs):
            return _on_mesh(mesh, lambda: T.prefill(
                params, cfg, s_max=S, **inputs))
        return dict(name=name, fn=prefill_fn,
                    args=(params_abs,
                          abstractify(inputs, shardings(mesh, ispecs),
                                      device)),
                    cfg=cfg, meta=meta)

    # decode: one new token against a seq_len KV cache (position S - 1)
    cache_meta = T.init_cache(cfg, B, S, device="meta")
    cspecs = cache_specs(cache_meta, cfg, sizes, B, S)
    cache_abs = {k: (v if k == "pos" else abstractify(
        v, shardings(mesh, cspecs[k]), device))
        for k, v in cache_meta.items()}
    cache_abs["pos"] = S - 1
    ndp = 1
    for a in dp:
        ndp *= sizes[a]
    tok_spec = bs if dp and B % ndp == 0 else (None,)

    def decode_fn(params, tokens, cache):
        return _on_mesh(mesh, lambda: T.decode_step(params, cfg, tokens,
                                                    cache))
    return dict(name=name, fn=decode_fn,
                args=(params_abs,
                      abstract_leaf((B,), torch.int32,
                                    NamedSharding(mesh, tok_spec), device),
                      cache_abs),
                cfg=cfg, meta=meta)


def _on_mesh(mesh, run):
    """``run()`` with ``mesh`` ambient and plain tensors replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    from .mesh import use_mesh
    with use_mesh(mesh), implicit_replication():
        return run()


def input_specs(arch: str, shape: str = "train_4k", mesh=None):
    """The abstract argument tuple of the cell (the brief's
    ``input_specs()`` contract); ``mesh`` defaults to a (1, 1) mesh over
    the live process group of one rank."""
    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    cell = build_cell(arch, shape, mesh)
    if cell is None:
        raise ValueError(f"cell ({arch}, {shape}) is skipped by design")
    return cell["args"]
