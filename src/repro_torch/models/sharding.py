"""Sharding rules: params / optimizer / activations / caches -> per-leaf
specs (the port of ``repro/models/sharding.py``'s rules).

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh-axis name, or a tuple of names — the entries of the
reference's ``PartitionSpec`` for the same shapes and axis sizes, with its
normalization (a one-name tuple is the name, an empty one ``None``).  A
mesh is given by its axis sizes, an ordered mapping such as ``{"data": 8,
"model": 4}`` (``{"pod": 2, "data": 8, "model": 4}`` across pods).

Mesh axes: ``pod`` (inter-pod), ``data`` (DP/FSDP/ZeRO), ``model``
(TP/EP).  Rules:

  * weights: TP-shard the "wide" axis over ``model``; FSDP-shard the other
    matrix axis over ``data`` (ZeRO-3 style — params, grads and optimizer
    states all inherit the same spec).
  * MoE expert stacks: experts over ``model`` (EP) and d_model over ``data``.
  * embeddings / lm_head: vocab over ``model``, d_model over ``data``.
  * batch axes: over ``(pod, data)``.
  * KV caches: batch over ``(pod, data)`` when batch divides, kv-heads
    over ``model`` when divisible, else sequence over ``model``.
  * the layer-stacked leading L axis is never sharded.

On a device mesh (``launch.mesh``) :func:`shardings` turns a spec tree
into :class:`NamedSharding` leaves, one DTensor placement per mesh
dimension: ``Shard(d)`` where tensor dimension ``d``'s entry names that
mesh dimension, ``Replicate()`` elsewhere (the reference's
``NamedSharding(mesh, PartitionSpec)``).  :func:`constrain` pins an
activation DTensor under an ambient mesh (``launch.mesh.use_mesh``) and is
the identity outside one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .config import ModelConfig
from .meshed import is_dtensor, whole

__all__ = ["param_specs", "batch_spec", "cache_specs", "dp_axes",
           "constrain", "merge_heads", "NamedSharding", "shardings",
           "placements_of", "is_spec", "place"]

DP = ("pod", "data")   # flattened data-parallel axes (pod may be absent)

Mesh = Mapping[str, int]
Spec = Tuple


def _entry(axes):
    """A spec entry as ``PartitionSpec`` normalizes it."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        if len(axes) == 1:
            return axes[0]
    return axes


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in DP if a in mesh)


def _spec_for_leaf(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
                   mesh: Mesh) -> Spec:
    """The spec of one parameter leaf, by its tree path."""
    model_ax = "model" if "model" in mesh else None
    data_ax = "data" if "data" in mesh else None
    msize = mesh.get("model", 1)
    dsize = mesh.get("data", 1)

    def ok(dim, size):   # shardable?
        return size is not None and dim % int(size) == 0

    name = path.split("/")[-1]
    nd = len(shape)

    # vocab-carrying tensors
    if name == "embed":
        v, d = shape
        return (model_ax if ok(v, msize) else None,
                data_ax if ok(d, dsize) else None)
    if name == "lm_head":
        d, v = shape
        return (data_ax if ok(d, dsize) else None,
                model_ax if ok(v, msize) else None)

    # MoE expert stacks (L, E, D, F) / router (L, D, E)
    if name in ("w_in", "w_gate", "w_out") and nd == 4:
        L, E, a, b = shape
        return (None, model_ax if ok(E, msize) else None,
                data_ax if ok(a, dsize) else None, None)
    if name == "router":
        return (None, data_ax if ok(shape[1], dsize) else None, None)

    # attention / mlp matrices, layer-stacked (L, in, out)
    wide_out = {"wq", "wk", "wv", "w_in", "w_gate", "in_proj", "gate_proj",
                "shared_in", "shared_gate", "m_wq", "m_wk", "m_wv", "m_wo",
                "s_wz", "s_wo"}
    wide_in = {"wo", "w_out", "out_proj", "shared_out", "m_out", "s_out"}
    if nd == 3 and name in wide_out:
        L, din, dout = shape
        return (None, data_ax if ok(din, dsize) else None,
                model_ax if ok(dout, msize) else None)
    if nd == 3 and name in wide_in:
        L, din, dout = shape
        return (None, model_ax if ok(din, msize) else None,
                data_ax if ok(dout, dsize) else None)
    # small/vector params: replicate
    return (None,) * nd


def param_specs(params, cfg: ModelConfig, mesh: Mesh):
    """A spec tree mirroring ``params`` (tensors or anything with a
    ``shape``)."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        return _spec_for_leaf(prefix, tuple(int(d) for d in tree.shape),
                              cfg, mesh)
    return walk(params, "")


def batch_spec(mesh: Mesh, *, seq_shard: bool = False) -> Spec:
    """(B, S[, ...]) activations: batch over dp axes, optionally seq over
    model (sequence parallelism)."""
    dp = _entry(dp_axes(mesh))
    if seq_shard and "model" in mesh:
        return (dp, "model")
    return (dp,)


def cache_specs(cache, cfg: ModelConfig, mesh: Mesh, batch: int,
                s_max: int):
    """A spec tree mirroring a decode cache from
    ``models.transformer.init_cache``.  KV caches (L, B, S, Hkv, hd): batch
    over dp; kv-heads over ``model`` when divisible, else the sequence
    axis, else replicated on the model axis.  SSM / xLSTM states: batch
    over dp only; ``pos`` and scalars replicated."""
    dp = dp_axes(mesh)
    dp_size = int(np.prod([mesh[a] for a in dp])) if dp else 1
    msize = int(mesh.get("model", 1))
    b_ax = _entry(dp) if dp and batch % max(dp_size, 1) == 0 else None
    kv_heads_ok = cfg.n_kv_heads % max(msize, 1) == 0
    seq_ok = s_max % max(msize, 1) == 0
    if kv_heads_ok:
        kv = (None, b_ax, None, "model", None)
    elif seq_ok:
        kv = (None, b_ax, "model", None, None)
    else:
        kv = (None, b_ax, None, None, None)

    def leaf_spec(name, leaf):
        nd = len(np.shape(leaf))
        if name in ("k", "v", "ck", "cv") and nd == 5:
            return kv
        if name == "pos" or nd == 0:
            return ()
        # stacked states (L, B, ...): batch over dp
        if nd >= 2:
            return (None, b_ax) + (None,) * (nd - 2)
        return (None,)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf_spec(name, tree)
    return walk(cache, "")


def is_spec(x) -> bool:
    """A spec is a tuple of entries, each ``None``, a name or a tuple of
    names (a spec tree's leaf)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(n, str) for n in e))
        for e in x)


def placements_of(spec: Spec, axis_names: Tuple[str, ...]) -> Tuple:
    """One DTensor placement per mesh dimension for ``spec``: ``Shard(d)``
    on each mesh dimension that entry ``d`` names (a tuple entry shards
    dimension ``d`` over each of its mesh dimensions, outermost first, as
    ``PartitionSpec`` does), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        for n in names:
            if n not in axis_names:
                raise ValueError(f"spec {spec} names {n!r}, not an axis of "
                                 f"the mesh {axis_names}")
            j = axis_names.index(n)
            if out[j] != Replicate():
                raise ValueError(f"spec {spec} shards two dimensions over "
                                 f"{n!r}")
            out[j] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``.
    ``placements`` has one entry per mesh dimension."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> Tuple:
        return placements_of(self.spec, tuple(self.mesh.mesh_dim_names))

    def distribute(self, t):
        """``t`` (the whole tensor, the same on every rank) as a DTensor in
        this layout: each rank keeps its shard."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements)


def shardings(mesh, spec_tree):
    """Map a spec tree (``param_specs``, ``cache_specs``, ...) to
    :class:`NamedSharding` leaves."""
    if is_spec(spec_tree):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: shardings(mesh, v) for k, v in spec_tree.items()}
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def place(tree, sharding_tree):
    """Each leaf of ``tree`` (whole tensors, the same on every rank) in the
    layout of the matching :class:`NamedSharding` of ``sharding_tree``
    (the reference's ``jax.device_put(tree, shardings)``).  A 0-dim leaf
    (the optimizer's step) stays a plain tensor: every rank holds it
    whole.  A leaf that is a DTensor already is redistributed."""
    if isinstance(tree, dict):
        return {k: place(v, sharding_tree[k]) for k, v in tree.items()}
    if tree.dim() == 0:
        return whole(tree)
    if is_dtensor(tree):
        return tree.redistribute(sharding_tree.mesh,
                                 sharding_tree.placements)
    return sharding_tree.distribute(tree)


def constrain(x, *, batch_dim: int = 0, model_dim: Optional[int] = None):
    """Pin an activation to (batch over the dp axes[, ``model_dim`` over
    ``model``]), each where it divides, under the ambient mesh: the
    DTensor is redistributed to that layout.  The identity outside a mesh,
    for a plain tensor, and where neither pin applies (the reference's
    rule, ``repro/models/sharding.py`` ``constrain``)."""
    from ..launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = [None] * x.ndim
    dp = dp_axes(sizes)
    if dp:
        dpsize = int(np.prod([sizes[a] for a in dp]))
        if x.shape[batch_dim] % dpsize == 0:
            spec[batch_dim] = _entry(dp)
    if model_dim is not None and "model" in sizes \
            and model_dim != batch_dim \
            and x.shape[model_dim] % sizes["model"] == 0:
        spec[model_dim] = "model"
    if all(e is None for e in spec):
        return x
    want = placements_of(tuple(spec), tuple(mesh.mesh_dim_names))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def merge_heads(t):
    """(B, S, H, hd) -> (B, S, H * hd), pinned with the merged dimension
    over ``model`` where it divides (:func:`constrain`).  The pin's
    backward gathers the gradient before the reshape's: the product that
    follows hands back a gradient sharded on the merged dimension, which
    DTensor cannot unflatten where its shards would split a head (llava's
    56 heads, hymba's 25, xlstm's 4 on 16 ranks).  The plain reshape off a
    mesh."""
    B, S = t.shape[0], t.shape[1]
    return constrain(t.reshape(B, S, -1), model_dim=2)
