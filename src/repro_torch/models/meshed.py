"""The model's hand-kernel calls on a device mesh.

Parameters placed by ``models.sharding.shardings`` are DTensors, and the
activations that come from them are DTensors whose layouts DTensor's
sharding propagation works out op by op (the counterpart of GSPMD).  The
calls below run on each rank's local shards instead, through
``torch.distributed.tensor.experimental.local_map``, because the kernels
and recurrences behind them take plain tensors:

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

  * :func:`sharded_moe`: expert parallelism.  Each rank routes the tokens
    of its batch rows (whole over ``model``, as the reference pins them),
    keeps the picks whose slot falls among its own experts, and runs the
    DynPlan dispatch, the expert products and the combine on them; the
    output is a partial sum over ``model``, made whole by one all-reduce.
  * :func:`sharded_heads`: a recurrence (hymba's SSM scan, xlstm's cells)
    on each rank's batch rows and heads, the heads over ``model`` where
    they divide.

Every op between them is DTensor's; tensors made inside the model (rope
tables, positions, the loss's masks) are plain and the train step runs
under ``implicit_replication()``, which treats them as replicated.
"""

from __future__ import annotations

import torch

__all__ = ["is_dtensor", "mesh_of", "whole", "wrap_local", "sharded_flash",
           "sharded_lookup", "split_heads", "whole_groups",
           "sharded_cache_write", "sharded_decode_core", "sharded_pick",
           "sharded_moe", "sharded_heads", "sharded_set"]


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


def _as_dtensor(t, mesh):
    """A plain tensor (the same on every rank) as a replicated DTensor; a
    DTensor as it is."""
    from torch.distributed.tensor import Replicate
    if t is None or is_dtensor(t):
        return t
    return wrap_local(t, mesh, [Replicate()] * mesh.ndim, t.shape)


def mesh_of(tree):
    """The device mesh of the first DTensor leaf of ``tree``, or None."""
    if isinstance(tree, dict):
        for v in tree.values():
            m = mesh_of(v)
            if m is not None:
                return m
        return None
    return tree.device_mesh if is_dtensor(tree) else None


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
    tokens = _as_dtensor(tokens, mesh)
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
    idx = _as_dtensor(idx, mesh)
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


def _dp_dims(mesh) -> list:
    """The mesh dimensions of the data-parallel axes (``pod``, ``data``)."""
    return [j for j, n in enumerate(mesh.mesh_dim_names)
            if n in ("pod", "data")]


def _batch_sharded(mesh, rows: int) -> bool:
    """Whether ``rows`` (a batch or group count) divides over the dp
    dimensions taken together, and there is more than one dp rank."""
    n = 1
    for j in _dp_dims(mesh):
        n *= mesh.size(j)
    return n > 1 and rows % n == 0


def sharded_moe(x, p, G: int, T: int, C: int, k: int, mode: str):
    """``models.moe``'s layer without the shared expert on a DTensor x (B,
    S, D) -> (y (B, S, D), aux loss), with the reference's layout: groups
    over the dp dimensions where G divides them (else every rank routes
    the whole batch, as the reference's pin leaves ``xg`` whole), whole
    over ``model``; the expert stacks' E over ``model``, their D gathered
    (FSDP).

    Two calls run per rank.  The router (:func:`models.moe.route`) gives
    every model rank of a data shard the same picks, slots and weights,
    and the aux loss's statistics of its groups (the mean probability and
    top-1 counts, partial sums over dp, made whole before their product).
    Then each rank keeps the picks whose slot lies in its experts' range
    ``[e0 C, (e0 + E_l) C)``, rebased onto a local buffer of G_l E_l C
    rows (every other pick points at the drop row), and runs
    :func:`models.moe.experts` on them: the DynPlan exchange is local, and
    y is a partial sum over ``model`` (one all-reduce, 4,096 x 7,168 bf16
    a layer for kimi-k2 at train_4k against the reference's 589 MB
    all-gather of the expert outputs; the k picks are then summed across
    ranks, not in one rank's order).  Gradients: x and the weights' a
    partial sum over ``model`` from the second call; the expert stacks'
    Shard on E, their dp part reduce-scattered into D; the router's a
    partial sum over dp."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from .moe import aux_loss, aux_parts, experts, route
    mesh = x.device_mesh
    B, D = x.shape[0], x.shape[-1]
    E = p["w_in"].shape[0]
    dp = _dp_dims(mesh)
    ndp = 1
    for j in dp:
        ndp *= mesh.size(j)
    gshard = _batch_sharded(mesh, G) and B % ndp == 0
    ej = [j for j, pl in enumerate(p["w_in"].placements) if pl == Shard(0)]
    rep = [Replicate()] * mesh.ndim
    xp, part_dp, wp, wg, yp, xg_grad = ([] for _ in range(6))
    for j in range(mesh.ndim):
        sh = j in dp and gshard
        xp.append(Shard(0) if sh else Replicate())
        part_dp.append(Partial() if sh else Replicate())
        wp.append(Shard(0) if j in ej else Replicate())
        wg.append(Shard(0) if j in ej else part_dp[-1])
        yp.append(Partial() if j in ej else xp[-1])
        xg_grad.append(Partial() if j in ej else xp[-1])
    xp, part_dp, wp, wg, yp, xg_grad = (tuple(t) for t in (
        xp, part_dp, wp, wg, yp, xg_grad))
    G_l = G // ndp if gshard else G

    def local_route(xl, rl):
        probs, wk, eidx, slot, keep = route(xl.reshape(G_l, T, D), rl, k, C)
        me, cnt = aux_parts(probs, eidx, rl.shape[-1])
        if gshard:
            me = me / ndp
        return wk, slot, keep, me, cnt

    wk, slot, keep, me, cnt = local_map(
        local_route, out_placements=(xp, xp, xp, part_dp, part_dp),
        in_placements=(xp, tuple(rep)), in_grad_placements=(xp, part_dp),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"])

    def local_experts(xl, wkl, sl, kl, w_in, w_gate, w_out):
        E_l = w_in.shape[0]
        e0 = 0
        for j in ej:
            e0 = e0 * mesh.size(j) + _coord(mesh, j)
        lo = e0 * E_l * C
        mine = kl & (sl >= lo) & (sl < lo + E_l * C)
        ls = torch.where(mine, sl - lo, E_l * C)
        y = experts(xl.reshape(G_l, T, D), wkl, ls, mine, w_in, w_gate,
                    w_out, C, mode)
        return y.reshape(xl.shape)

    y = local_map(
        local_experts, out_placements=list(yp),
        in_placements=(xp, xp, xp, xp, wp, wp, wp),
        in_grad_placements=(xg_grad, xg_grad, xp, xp, wg, wg, wg),
        device_mesh=mesh, redistribute_inputs=True)(
            x, wk, slot, keep, p["w_in"], p["w_gate"], p["w_out"])
    me, cnt = (t.redistribute(mesh, rep) for t in (me, cnt))
    return y, aux_loss(me, cnt, G * T, E)


def sharded_heads(fn, args, roles, out_heads, heads: int):
    """``fn(*args)`` on each rank's shards, for a recurrence that is local
    per batch row and per head (hymba's SSM scan, xlstm's cells): the
    batch (dimension 0 of every activation) over the dp dimensions where
    it divides them, the heads over ``model`` where ``heads`` divides it
    (else whole on every model rank: a shard may not split a head).

    ``roles[i]`` says what ``args[i]`` is: ``("act", h)`` an activation or
    state whose head dimension is ``h`` (None: no head dimension), plain
    tensors taken as replicated; ``("param", h)`` a replicated weight,
    sliced to the rank's heads on dimension ``h``, whose gradient is a
    partial sum over the dp dimensions that shard the batch; ``None`` for
    an argument that is None.  ``fn`` returns a tuple of activations
    whose head dimensions are ``out_heads``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    batch = next(a.shape[0] for a, r in zip(args, roles)
                 if r is not None and r[0] == "act")
    bshard = _batch_sharded(mesh, batch)
    dp = _dp_dims(mesh)
    names = mesh.mesh_dim_names

    def hsharded(j):
        return names[j] == "model" and mesh.size(j) > 1 \
            and heads % mesh.size(j) == 0

    def place(kind, h, grad=False):
        out = []
        for j in range(mesh.ndim):
            if j in dp:
                if kind == "act" and bshard:
                    out.append(Shard(0))
                else:
                    out.append(Partial() if grad and bshard
                               else Replicate())
            elif hsharded(j):
                # a tensor with no head dimension is read by every head:
                # its gradient is a partial sum over the heads' ranks
                out.append(Shard(h) if h is not None else
                           Partial() if grad else Replicate())
            else:
                out.append(Replicate())
        return tuple(out)

    args = [_as_dtensor(a, mesh) for a in args]
    inp = tuple(None if r is None else place(*r) for r in roles)
    grads = tuple(None if r is None else place(*r, grad=True)
                  for r in roles)
    outp = tuple(place("act", h) for h in out_heads)
    return local_map(fn, out_placements=outp, in_placements=inp,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def sharded_set(stack, i: int, new) -> None:
    """``stack[i] = new`` in place on a DTensor ``stack`` (a cache leaf
    stacked on an unsharded leading L axis): ``new`` is brought to the
    layout of ``stack[i]`` and each rank writes its own shard."""
    from torch.distributed.tensor import Shard
    mesh = stack.device_mesh
    want = [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in stack.placements]
    new = _as_dtensor(new, mesh)
    if list(new.placements) != want:
        new = new.redistribute(mesh, want)
    stack.to_local()[i].copy_(new.to_local())
