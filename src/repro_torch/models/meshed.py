"""The model's hand-kernel calls on a device mesh.

Parameters placed by ``models.sharding.shardings`` are DTensors, and the
activations that come from them are DTensors whose layouts DTensor's
sharding propagation works out op by op (the counterpart of GSPMD).  Two
calls run on each rank's local shards instead, through
``torch.distributed.tensor.experimental.local_map``, because the kernels
behind them take plain tensors:

  * :func:`sharded_flash`: attention is local per batch row and per query
    head, so each rank launches the flash kernel (row 8) on its own batch
    rows and query heads.  Where the KV heads are not sharded with the
    query heads (GQA with fewer KV heads than ``model`` ranks: qwen3-4b's
    8 on 16), each rank slices the KV heads of its own query group, and
    their gradient is a partial sum over ``model``.
  * :func:`sharded_lookup`: the token lookup through the gather kernel
    whose transpose is the sorted segment reduce (``core.dynplan.
    gather_rows``), vocab-parallel where the embedding's vocabulary is
    sharded (Megatron's VocabParallelEmbedding): each rank looks up the
    tokens of its vocabulary slice, zeroes the others, and the rows are a
    partial sum over those mesh dimensions.  The embedding's model
    dimension is gathered first (the FSDP all-gather of a weight).

Every op between them is DTensor's; tensors made inside the model (rope
tables, positions, the loss's masks) are plain and the train step runs
under ``implicit_replication()``, which treats them as replicated.
"""

from __future__ import annotations

import torch

__all__ = ["is_dtensor", "mesh_of", "whole", "wrap_local", "meshable",
           "require_meshable", "sharded_flash", "sharded_lookup",
           "split_heads", "whole_groups", "sharded_cache_write",
           "sharded_decode_core", "sharded_pick"]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(t):
    """A DTensor gathered whole on every rank (a collective); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def wrap_local(local, mesh, placements, shape):
    """This rank's shard ``local`` as a DTensor of the contiguous global
    ``shape`` (no check across ranks)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(int(d) for d in shape)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


def mesh_of(tree):
    """The device mesh of the first DTensor leaf of ``tree``, or None."""
    if isinstance(tree, dict):
        for v in tree.values():
            m = mesh_of(v)
            if m is not None:
                return m
        return None
    return tree.device_mesh if is_dtensor(tree) else None


def meshable(cfg) -> bool:
    """Whether the sharded step covers ``cfg``'s family: the dense block
    kinds (dense, llava's embeddings).  MoE (expert parallelism needs the
    DynPlan dispatch across ranks), hymba, xlstm and whisper (their own
    scans and encoder) wait in ROADMAP Queue 1."""
    return not cfg.is_moe and cfg.block_kind == "transformer" \
        and not cfg.enc_layers and not cfg.cross_attention


def require_meshable(cfg, params) -> None:
    """Raise for a family that is not :func:`meshable` under a mesh with
    an axis larger than 1; on a mesh whose axes are all 1 every family
    runs."""
    mesh = mesh_of(params)
    if mesh is None or max(mesh.shape) == 1:
        return
    if not meshable(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the sharded step covers the dense block kinds "
            f"only; a {'x'.join(map(str, mesh.shape))} mesh needs the "
            f"MoE / hymba / xlstm / whisper sharded step (ROADMAP Queue 1)")


def _coord(mesh, dim: int) -> int:
    return int(mesh.get_local_rank(dim))


def _even(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}: {n} does not divide over {parts} ranks")
    return n // parts


def whole_groups(t, dim: int, groups: int):
    """``t`` with dimension ``dim`` gathered on every mesh dimension whose
    size does not divide ``groups``, the number of whole pieces ``dim`` is
    about to be split into (a shard may not split a head, as GSPMD's
    layouts do not); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.ndim
    sizes = t.device_mesh.shape
    want = [Replicate() if p == Shard(dim) and groups % sizes[j] else p
            for j, p in enumerate(t.placements)]
    if want != list(t.placements):
        t = t.redistribute(t.device_mesh, want)
    return t


def split_heads(t, heads: int, hd: int):
    """(B, S, heads * hd) -> (B, S, heads, hd), a DTensor gathered first
    where its shards would split a head (GQA's KV projections: 8 heads on
    16 ranks)."""
    B, S = t.shape[0], t.shape[1]
    return whole_groups(t, -1, heads).reshape(B, S, heads, hd)


def sharded_cache_write(cache, new, pos: int):
    """``cache[:, pos] = new[:, 0]`` in place on a DTensor KV cache (B,
    Smax, Hkv, hd) sharded by ``models.sharding.cache_specs``: each rank
    writes its own shard, and where the sequence is sharded only the rank
    holding ``pos`` writes.  Returns ``cache``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache.device_mesh
    seq_dims = [j for j, p in enumerate(cache.placements) if p == Shard(1)]
    new_pl = [Replicate() if p == Shard(1) else p for p in cache.placements]
    Smax = cache.shape[1]

    def local(cl, nl):
        first, rows = 0, Smax
        for j in seq_dims:
            rows = _even(rows, mesh.size(j), "sequence")
            first = first * mesh.size(j) + _coord(mesh, j)
        lo = first * rows
        if lo <= pos < lo + rows:
            cl[:, pos - lo] = nl[:, 0].to(cl.dtype)
        return cl

    fn = local_map(local, out_placements=list(cache.placements),
                   in_placements=(tuple(cache.placements), tuple(new_pl)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(cache, new)


def sharded_flash(q, k, v, *, causal: bool, window):
    """``kernels.ops.flash_attention`` on DTensors q (B, Sq, H, hd) and k,
    v (B, Skv, Hkv, hd): batch over the dp dimensions, query heads over
    ``model`` where they divide, each rank's attention on its shards.
    Returns q's layout."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..kernels import ops as kops
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    B, H, Hkv = q.shape[0], q.shape[2], k.shape[2]
    rep = H // Hkv
    qp, kp, kg = [], [], []
    slicing = None          # (mesh dim, local query heads) when KV is sliced
    for j, (name, size) in enumerate(zip(names, mesh.shape)):
        if name == "model" and size > 1 and H % size == 0:
            hl = H // size
            qp.append(Shard(2))
            if Hkv % size == 0:
                kp.append(Shard(2))
                kg.append(Shard(2))
            elif hl % rep == 0 or rep % hl == 0:
                slicing = (j, hl)
                kp.append(Replicate())
                kg.append(Partial())
            else:
                raise ValueError(f"{H} query heads over {size} ranks split "
                                 f"the {rep}-head GQA groups unevenly")
        elif name != "model" and size > 1 and B % size == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
            kg.append(Shard(0))
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kg.append(Replicate())
    # batch sharded over two dp dimensions must divide over both
    if sum(p == Shard(0) for p in qp) > 1:
        ndp = 1
        for p, size in zip(qp, mesh.shape):
            ndp *= size if p == Shard(0) else 1
        _even(B, ndp, "batch")

    def local(ql, kl, vl):
        if slicing is not None:
            j, hl = slicing
            first = _coord(mesh, j) * hl
            lo, hi = first // rep, (first + hl - 1) // rep + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return kops.flash_attention(ql.contiguous(), kl.contiguous(),
                                    vl.contiguous(), causal=causal,
                                    window=window)

    fn = local_map(local, out_placements=list(qp),
                   in_placements=(tuple(qp), tuple(kp), tuple(kp)),
                   in_grad_placements=(tuple(qp), tuple(kg), tuple(kg)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


def sharded_lookup(embed, tokens):
    """``embed[tokens]`` on a DTensor embedding (V, D) and DTensor token
    ids (B, S) -> (B, S, D), through the gather kernel on each rank's
    shards (vocab-parallel where the vocabulary is sharded)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..core.dynplan import gather_rows
    mesh = embed.device_mesh
    sizes = tuple(mesh.shape)
    if not is_dtensor(tokens):
        tokens = wrap_local(tokens, mesh, [Replicate()] * len(sizes),
                            tokens.shape)
    ep, tp, op, gp = [], [], [], []
    vocab_dims = []
    for j, (pe, pt) in enumerate(zip(embed.placements, tokens.placements)):
        if pe == Shard(0) and sizes[j] > 1:
            vocab_dims.append(j)
            ep.append(Shard(0))
            tp.append(Replicate())
            op.append(Partial())
            gp.append(Shard(0))
        elif isinstance(pt, Shard):
            ep.append(Replicate())
            tp.append(pt)
            op.append(pt)
            gp.append(Partial())
        else:
            ep.append(Replicate())
            tp.append(Replicate())
            op.append(Replicate())
            gp.append(Replicate())
    V = embed.shape[0]
    rows = V
    for j in vocab_dims:
        rows = _even(rows, sizes[j], "vocab")

    def local(el, tl):
        flat = tl.reshape(-1)
        if rows == V:
            out = gather_rows(el, flat)
        else:
            first = 0
            for j in vocab_dims:     # outermost mesh dimension first
                first = first * sizes[j] + _coord(mesh, j)
            rel = flat - first * rows
            inside = (rel >= 0) & (rel < rows)
            out = gather_rows(el, torch.where(inside, rel, 0))
            out = torch.where(inside[:, None], out, 0)
        return out.reshape(tuple(tl.shape) + (el.shape[1],))

    fn = local_map(local, out_placements=list(op),
                   in_placements=(tuple(ep), tuple(tp)),
                   in_grad_placements=(tuple(gp), tuple(tp)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(embed, tokens)


def sharded_decode_core(q, cache_k, cache_v, pos: int, window, core):
    """``core`` (``models.layers.decode_core``) on each rank's shards of a
    DTensor decode: the cache's batch and KV-head shards with their query
    heads, and where the cache's sequence is sharded (KV heads that do not
    divide over ``model``) the rank's keys, the softmax statistics and
    the partial outputs summed over those mesh dimensions (flash-decoding's
    split).  q (B, 1, H, hd) -> q's shape, in the cache's batch and head
    layout."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache_k.device_mesh
    cp = list(cache_k.placements)
    # q follows the cache: batch where the cache's batch is sharded, query
    # heads where its KV heads are (dimension 2 of both)
    qp = [p if p in (Shard(0), Shard(2)) else Replicate() for p in cp]
    seq_dims = [j for j, p in enumerate(cp) if p == Shard(1)]
    Smax = cache_k.shape[1]

    def local(ql, kl, vl):
        if not seq_dims:
            return core(ql, kl, vl, pos, window)
        first, rows = 0, Smax
        for j in seq_dims:
            rows = _even(rows, mesh.size(j), "sequence")
            first = first * mesh.size(j) + _coord(mesh, j)

        def reduce(t, op):
            for j in seq_dims:
                t = funcol.all_reduce(t, op, (mesh, j))
            return t
        return core(ql, kl, vl, pos, window, first * rows, reduce)

    fn = local_map(local, out_placements=qp,
                   in_placements=(tuple(qp), tuple(cp), tuple(cp)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, cache_k, cache_v)


def sharded_pick(x, idx):
    """``torch.gather(x, -1, idx)[..., 0]`` for a DTensor ``x`` whose last
    dimension (a vocabulary) may be sharded and token ids ``idx`` (...,
    1): each rank picks the ids of its own slice and zeroes the rest, and
    the result is a partial sum over the vocabulary's mesh dimensions (the
    vocab-parallel cross-entropy's gold logit).  With the vocabulary whole
    on every rank it is the plain gather."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    last = x.ndim - 1
    if not is_dtensor(idx):
        idx = wrap_local(idx, mesh, [Replicate()] * mesh.ndim, idx.shape)
    vocab_dims = [j for j, p in enumerate(x.placements)
                  if p == Shard(last) and mesh.size(j) > 1]
    xp = [Replicate() if p == Shard(last) and mesh.size(j) == 1 else p
          for j, p in enumerate(x.placements)]
    ip = [Replicate() if p == Shard(last) else p for p in xp]
    op = [Partial() if j in vocab_dims else p for j, p in enumerate(xp)]
    V = x.shape[-1]
    rows = V
    for j in vocab_dims:
        rows = _even(rows, mesh.size(j), "vocab")

    def local(xl, il):
        if rows == V:
            return torch.gather(xl, -1, il)[..., 0]
        first = 0
        for j in vocab_dims:
            first = first * mesh.size(j) + _coord(mesh, j)
        rel = il - first * rows
        inside = (rel >= 0) & (rel < rows)
        got = torch.gather(xl, -1, torch.where(inside, rel, 0))
        return torch.where(inside, got, 0.0)[..., 0]

    fn = local_map(local, out_placements=op,
                   in_placements=(tuple(xp), tuple(ip)),
                   in_grad_placements=(tuple(xp), tuple(ip)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, idx)
