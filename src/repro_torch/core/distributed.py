"""Distributed SF execution over a ``torch.distributed`` process group.

The port of ``repro.core.distributed``.  A ``DistSF`` binds one StarForest
template to a process group whose size is the SF's rank count; each process
calls its methods with its own shards, as the reference's are called inside
``shard_map``:

    root shard: (root_pad, *unit)   leaf shard: (leaf_pad, *unit)

(both padded uniformly across ranks, with one trailing garbage row — see
:mod:`repro_torch.core.plan`).

Lowering selection (the paper's §5.2 pattern optimization as collective
choice):

  local_only  ->  on-device gather and scatter, no collective
  allgather   ->  all_gather_into_tensor (bcast) / reduce_scatter_tensor
                  (sum-reduce)
  permute     ->  batch_isend_irecv
  general     ->  pack -> all_to_all_single -> unpack (sort-segment reduce)

The begin/end split is the paper's: ``*_begin`` packs and issues the
collective with ``async_op=True`` and returns a :class:`DistPending` that
holds the work handle and every tensor the collective reads or writes;
``*_end`` waits on it, then unpacks.  Work placed between the two (the
§4.1 local SpMV) overlaps the exchange.  ``sync_mode=True`` waits inside
``*_begin`` instead: the blocking-MPI behaviour of paper Fig 5(R).

The packs (``kops.pack_rows``) and the segment reduce
(``kops.segment_reduce_rows``, through :class:`repro_torch.core.ops.
SortedUnpack`) are the hand-written kernels on a CUDA tensor and their
plain versions on a CPU one; ``use_kernels=False`` asks for
``index_select`` and the plain fold instead.  Every scatter writes only
the real rows: the padded indices, which all point at the garbage row, are
dropped at construction, so each scatter has unique indices and the
garbage rows are never written.  The reduce folds only this rank's valid
segments, in the plan's (leaf rank, edge index) order, so for payloads of
one dtype it gives the bits of the single-program backends; only the
allgather SF's ``reduce_scatter_tensor`` sums in the collective's own
order.

The data-movement collectives move ``uint8`` views of contiguous buffers,
exact for every dtype and unit (gloo has no uint16, NCCL no int16).
``reduce_scatter_tensor`` sums in the payload's dtype: float32, float64,
float16, bfloat16, int32 and int64 take it, any other dtype the general
path (a bool payload rides uint8, and its sum must reach the root's dtype
before the fold).  The group must carry the shards' device — NCCL for CUDA
tensors, gloo for CPU ones — or construction raises; nothing is moved
between devices.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .device import check_payload, index_tensor, kernel_index, resolve_device
from .graph import StarForest
from .mpiops import SUM, Op, get_op
from .ops import _AT, SortedUnpack, exclusive_segment_prefix, \
    unsigned_payloads
from .plan import PaddedPlan, build_padded_plan
from .unit import check_plan_unit
from . import patterns as pat
from ..kernels import ops as kops

__all__ = ["DistSF", "DistPending", "pad_ragged", "unpad_ragged"]

# the dtypes reduce_scatter_tensor sums on both gloo and NCCL
_RS_DTYPES = frozenset({torch.float32, torch.float64, torch.float16,
                        torch.bfloat16, torch.int32, torch.int64})
# the devices a single-backend process group carries
_GROUP_DEVICES = {"nccl": {"cuda"}, "gloo": {"cpu"}}


# --------------------------------------------------------------------------
# ragged <-> padded-stacked helpers
# --------------------------------------------------------------------------
def pad_ragged(arrays: Sequence, pad_rows: int) -> torch.Tensor:
    """Stack per-rank arrays or tensors ``(n_r, *unit)`` into one
    ``(R, pad_rows, *unit)`` tensor, zeros beyond each ``n_r``."""
    ts = [torch.as_tensor(a) for a in arrays]
    out = ts[0].new_zeros((len(ts), pad_rows) + tuple(ts[0].shape[1:]))
    for r, a in enumerate(ts):
        out[r, : a.shape[0]] = a
    return out


def unpad_ragged(stacked: torch.Tensor, sizes: Sequence[int]) -> list:
    """The first ``sizes[r]`` rows of each rank's block (views)."""
    return [stacked[r, : int(n)] for r, n in enumerate(sizes)]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def _put(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
         op: Op) -> None:
    """``out[idx] op= vals`` in place, ``idx`` duplicate-free."""
    vals = vals.to(out.dtype)
    if op.at_update == "set":
        out[idx] = vals
    else:
        out[idx] = _AT[op.at_update](out[idx], vals)


def _check_group_device(group, device: torch.device) -> None:
    """Raise unless ``group``'s backend carries tensors on ``device``."""
    name = str(dist.get_backend(group)).lower()
    if ":" in name:            # a per-device map, "cpu:gloo,cuda:nccl"
        ok = {part.split(":")[0] for part in name.split(",")}
    else:
        ok = _GROUP_DEVICES.get(name, {device.type})
    if device.type not in ok:
        raise ValueError(
            f"a {name} process group does not carry {device.type} tensors "
            f"(it carries {', '.join(sorted(ok))}); build the SF on that "
            f"device or pass a group that carries {device.type} tensors")


@dataclasses.dataclass
class DistPending:
    """One ``DistSF`` exchange in flight.

    ``buf`` receives the remote rows, ``self_vals`` holds the self edges'
    rows (for ``reduce_local`` the whole sorted buffer); ``work`` is the
    collective's handles (empty once waited on, or when no collective was
    issued) and ``keep`` every other tensor the collective reads or writes,
    held until the wait (on the card NCCL runs on its own stream).
    ``convert`` maps the rows once they have arrived, ``dtype`` is their
    caller's dtype (:func:`repro_torch.core.ops.unsigned_payloads`)."""

    kind: str
    buf: Optional[torch.Tensor]
    self_vals: Optional[torch.Tensor]
    op: Op
    work: tuple = ()
    keep: tuple = ()
    dtype: Optional[torch.dtype] = None
    convert: Optional[Callable] = None

    def wait(self) -> None:
        for w in self.work:
            w.wait()
        self.work, self.keep = (), ()

    def converted(self, fn, dtype) -> "DistPending":
        """This exchange with its rows mapped by ``fn`` once they arrive."""
        return dataclasses.replace(self, convert=fn, dtype=dtype)

    def rows(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``(buf, self_vals)`` after the wait, converted."""
        self.wait()
        f = self.convert or (lambda v: v)
        return (None if self.buf is None else f(self.buf),
                None if self.self_vals is None else f(self.self_vals))


@unsigned_payloads
class DistSF:
    """StarForest bound to a process group; each process calls the methods
    with its own shards.

    ``group`` defaults to the world group, whose size must equal
    ``sf.nranks``.  ``lowering`` is ``"auto"`` (the SF's pattern) or the
    pattern's own lowering or ``"general"``.  ``device`` defaults to the
    current CUDA device (``device="cpu"`` with a gloo group)."""

    def __init__(self, sf: StarForest, group=None,
                 plan: Optional[PaddedPlan] = None, lowering: str = "auto",
                 sync_mode: bool = False, use_kernels: Optional[bool] = None,
                 unit=None, device=None):
        sf.setup()
        self.sf = sf
        self.device = resolve_device(device)
        self.group = dist.group.WORLD if group is None else group
        size = dist.get_world_size(self.group)
        if size != sf.nranks:
            raise ValueError(f"the process group has {size} ranks but the "
                             f"SF has {sf.nranks}")
        _check_group_device(self.group, self.device)
        self.rank = dist.get_rank(self.group)
        if plan is not None:
            check_plan_unit(plan, unit)
            self.plan = plan
        else:
            self.plan = build_padded_plan(sf, unit=unit)
        self._key = self.plan.comm_signature()   # scopes the tuned winners
        kind = self.plan.pattern.kind
        if lowering == "auto":
            self.lowering = kind
        elif lowering in (pat.GENERAL, kind):
            self.lowering = lowering
        else:
            raise ValueError(
                f"requested lowering {lowering!r} but SF pattern is {kind!r}")
        self.sync_mode = bool(sync_mode)
        self.use_kernels = True if use_kernels is None else bool(use_kernels)
        self._setup_maps()

    # ------------------------------------------------------------ plumbing
    @property
    def nranks(self) -> int:
        return self.plan.nranks

    @property
    def unit(self):
        """The plan's payload unit spec (paper §3.2 ``MPI_Datatype``)."""
        return self.plan.unit

    def _setup_maps(self) -> None:
        """This rank's rows of the plan, with the padded entries dropped,
        as device index tensors (PetscSFSetUp: built once)."""
        p, me, d, sf = self.plan, self.rank, self.device, self.sf
        R, P = p.nranks, p.P
        gi = lambda a: kernel_index(a, d)          # gathers (int32)
        si = lambda a: index_tensor(a, d)          # scatters (int64)
        self_pair = sf.pair(me, me)
        n_self = 0 if self_pair is None else self_pair.count
        self._nremote = R * P
        self._self_root = gi(p.self_root_idx[me, :n_self])
        self._self_leaf = gi(p.self_leaf_idx[me, :n_self])
        self._self_leaf_s = si(p.self_leaf_idx[me, :n_self])
        # general: the (R, P) send / receive blocks, and their real slots
        self._send_root = gi(p.send_root_idx[me].reshape(-1))
        self._recv_leaf_all = gi(p.recv_leaf_idx[me].reshape(-1))
        cnt = p.counts[:, me]
        slots = np.concatenate([q * P + np.arange(cnt[q]) for q in range(R)])
        self._recv_slots = gi(slots)
        self._recv_leaf = si(p.recv_leaf_idx[me].reshape(-1)[slots])
        # the rank's sorted slot space, valid slots and segments only
        nv = int(p.red_is_valid[me].sum())
        ns = int(np.count_nonzero(p.red_seg_len[me]))
        perm = p.red_perm[me, :nv]
        self._perm = gi(perm)
        self._perm_s = si(perm)
        self._red_dst = gi(p.red_dst[me, :nv])
        self._seg_start = si(p.red_seg_start[me, :nv])
        if self.lowering in (pat.LOCAL_ONLY, pat.EMPTY):
            # every valid slot is a self slot: one gather in sorted order
            local = p.self_leaf_idx[me][perm - R * P]
            self._sorted_self_leaf = gi(local)
            self._sorted_self_leaf_s = si(local)
        # this rank's segments as SortedUnpack reads them; the scatter
        # shortcut follows the whole plan, as the reference's (and the
        # single-program backends') does
        red = SimpleNamespace(
            nseg=ns, duplicate_free=p.red_dup_free,
            dst_sorted=p.red_dst[me, :nv], seg_of_slot=p.red_seg_id[me, :nv],
            seg_dst=p.red_seg_dst[me, :ns], seg_first=p.red_seg_first[me, :ns],
            seg_len=p.red_seg_len[me, :ns],
            win_src=p.replace_win_src[me, :ns],
            win_dst=p.replace_win_dst[me, :ns])
        self._unpack = SortedUnpack(red, d, plain=not self.use_kernels,
                                    key=self._key)
        self._roots_s = si(np.arange(p.nroots[me]))
        if self.lowering == pat.ALLGATHER:
            self._ag_src = gi(self._allgather_src_map())
            self._ag_leaf = si(np.arange(int(p.nroots.sum())))
            self._ag_block = gi(self._allgather_block_map().reshape(-1))
        if self.lowering == pat.PERMUTE:
            dsts = p.permute_dst
            src = [q for q in range(R) if dsts[q] == me]
            self._perm_dst = dsts[me]
            self._perm_src = src[0] if src else -1
            n_in = sf.pair(src[0], me).count if src else 0
            self._perm_leaf = si(self._permute_unpack_idx()[me, :n_in])

    def _shard(self, t, what: str, rows: int) -> torch.Tensor:
        t = check_payload(t, self.device, what)
        if t.dim() == 0 or int(t.shape[0]) != rows:
            raise ValueError(f"{what} must have {rows} rows (the padded "
                             f"shard), got shape {tuple(t.shape)}")
        self.plan.unit.check(t, what)
        return t.contiguous()

    def _gather(self, data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``data[idx]`` rows: the pack kernels, or ``index_select`` when
        kernels are off."""
        if self.use_kernels:
            return kops.pack_rows(data, idx, key=self._key)
        return data.index_select(0, idx)

    def _peer(self, r: int) -> int:
        """The global rank of the group's rank ``r`` (p2p ops take it)."""
        if self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def _issue(self, kind: str, buf, self_vals, op: Op, work,
               keep) -> DistPending:
        pend = DistPending(kind, buf, self_vals, op, tuple(work), keep)
        if self.sync_mode:
            pend.wait()
        return pend

    def _all_to_all(self, sbuf: torch.Tensor):
        """``(receive buffer, work)`` of the equal-split all-to-all of the
        ``(R * P, *unit)`` buffer ``sbuf``."""
        rbuf = torch.empty_like(sbuf)
        if sbuf.numel() == 0:
            return rbuf, ()
        return rbuf, (dist.all_to_all_single(_bytes(rbuf), _bytes(sbuf),
                                             group=self.group,
                                             async_op=True),)

    # -------------------------------------------------------------- bcast
    def bcast_begin(self, root_shard: torch.Tensor,
                    op="replace") -> DistPending:
        op = get_op(op)
        p = self.plan
        root = self._shard(root_shard, "root shard", p.root_pad)
        low = self.lowering
        if low in (pat.LOCAL_ONLY, pat.EMPTY):
            return DistPending("bcast", None,
                               self._gather(root, self._self_root), op)
        if low == pat.ALLGATHER:
            buf = root.new_empty((p.nranks * p.root_pad,) + root.shape[1:])
            work = () if root.numel() == 0 else (dist.all_gather_into_tensor(
                _bytes(buf), _bytes(root), group=self.group, async_op=True),)
            return self._issue("bcast_ag", buf, None, op, work, (root,))
        if low == pat.PERMUTE:
            # a rank that receives nothing gets zeros, as ppermute gives
            buf = torch.zeros_like(root)
            ops = []
            if self._perm_dst >= 0:
                ops.append(dist.P2POp(dist.isend, _bytes(root),
                                      self._peer(self._perm_dst), self.group))
            if self._perm_src >= 0:
                ops.append(dist.P2POp(dist.irecv, _bytes(buf),
                                      self._peer(self._perm_src), self.group))
            work = dist.batch_isend_irecv(ops) if ops and root.numel() \
                else ()
            return self._issue("bcast_perm", buf, None, op, work, (root,))
        sbuf = self._gather(root, self._send_root)          # (R*P, *unit)
        buf, work = self._all_to_all(sbuf)
        return self._issue("bcast", buf, self._gather(root, self._self_root),
                           op, work, (sbuf,))

    def bcast_end(self, pending: DistPending,
                  leaf_shard: torch.Tensor) -> torch.Tensor:
        op = pending.op
        leaf = self._shard(leaf_shard, "leaf shard", self.plan.leaf_pad)
        buf, self_vals = pending.rows()
        out = leaf.clone()
        if pending.kind == "bcast_ag":
            # leaves are the rank-major concatenation of all roots
            _put(out, self._ag_leaf, self._gather(buf, self._ag_src), op)
        elif pending.kind == "bcast_perm":
            n = self._perm_leaf.numel()
            _put(out, self._perm_leaf, buf[:n], op)
        else:
            if buf is not None:
                _put(out, self._recv_leaf,
                     self._gather(buf, self._recv_slots), op)
            _put(out, self._self_leaf_s, self_vals, op)
        return out

    def bcast(self, root_shard, leaf_shard, op="replace"):
        return self.bcast_end(self.bcast_begin(root_shard, op), leaf_shard)

    # -------------------------------------------------------------- reduce
    def reduce_begin(self, leaf_shard: torch.Tensor, op="sum") -> DistPending:
        op = get_op(op)
        p = self.plan
        leaf = self._shard(leaf_shard, "leaf shard", p.leaf_pad)
        low = self.lowering
        if low in (pat.LOCAL_ONLY, pat.EMPTY):
            return DistPending("reduce_local", None,
                               self._gather(leaf, self._sorted_self_leaf), op)
        if low == pat.ALLGATHER and op.name == "sum" \
                and leaf.dtype in _RS_DTYPES:
            # reduce over an allgather SF == reduce_scatter
            blocks = self._gather(leaf, self._ag_block)   # (R*root_pad, ..)
            buf = leaf.new_zeros((p.root_pad,) + leaf.shape[1:])
            work = () if blocks.numel() == 0 else (dist.reduce_scatter_tensor(
                buf, blocks, op=dist.ReduceOp.SUM, group=self.group,
                async_op=True),)
            return self._issue("reduce_rs", buf, None, op, work, (blocks,))
        # general path (also permute SFs in reverse and the other
        # reductions on allgather SFs)
        sbuf = self._gather(leaf, self._recv_leaf_all)      # (R*P, *unit)
        buf, work = self._all_to_all(sbuf)
        return self._issue("reduce", buf, self._gather(leaf, self._self_leaf),
                           op, work, (sbuf,))

    def _sorted(self, pending: DistPending) -> torch.Tensor:
        """The received rows in the rank's sorted slot order (valid slots:
        remote slots ``< R * P``, then the self edges)."""
        buf, self_vals = pending.rows()
        if pending.kind == "reduce_local":
            return self_vals
        return self._gather(torch.cat([buf, self_vals]), self._perm)

    def reduce_end(self, pending: DistPending,
                   root_shard: torch.Tensor) -> torch.Tensor:
        root = self._shard(root_shard, "root shard", self.plan.root_pad)
        if pending.kind == "reduce_rs":
            buf, _ = pending.rows()
            out = root.clone()
            _put(out, self._roots_s, buf[: self._roots_s.numel()], pending.op)
            return out
        return self._unpack(root, self._sorted(pending), pending.op)

    def reduce(self, leaf_shard, root_shard, op="sum"):
        return self.reduce_end(self.reduce_begin(leaf_shard, op), root_shard)

    # -------------------------------------------------------- fetch-and-op
    def fetch_and_op(self, root_shard: torch.Tensor, leaf_shard: torch.Tensor,
                     op="sum") -> Tuple[torch.Tensor, torch.Tensor]:
        """Distributed fetch-and-add (paper §3.2).  Returns
        ``(root_shard', leafupdate_shard)``: every leaf receives its root's
        value as of all earlier edges in the (leaf rank, edge index) order,
        and the roots end up fully reduced (the leaf values cast to the root
        dtype first, as the single-program backends do)."""
        op = get_op(op)
        if op.name != "sum":
            raise NotImplementedError("fetch_and_op supports op='sum'")
        p = self.plan
        root = self._shard(root_shard, "root shard", p.root_pad)
        leaf = self._shard(leaf_shard, "leaf shard", p.leaf_pad)
        local = self.lowering in (pat.LOCAL_ONLY, pat.EMPTY)
        # 1) route leaf values to root ranks (the reduce's movement)
        if local:
            sv = self._gather(leaf, self._sorted_self_leaf)
        else:
            sbuf = self._gather(leaf, self._recv_leaf_all)
            buf, work = self._all_to_all(sbuf)
            pend = DistPending("reduce", buf,
                               self._gather(leaf, self._self_leaf), op, work,
                               (sbuf,))
            sv = self._sorted(pend)
        # 2) exclusive in-segment prefix (the plan's order)
        excl = exclusive_segment_prefix(sv, self._seg_start)
        fetched = self._gather(root, self._red_dst) + excl.to(root.dtype)
        # 3) the roots' totals through the deterministic segment reduce
        root_out = self._unpack(root, sv.to(root.dtype), SUM)
        # 4) route the fetched values back to the leaves
        upd = leaf.clone()
        if local:
            upd[self._sorted_self_leaf_s] = fetched.to(leaf.dtype)
            return root_out, upd
        slots = fetched.new_zeros((self._nremote + self._self_leaf.numel(),)
                                  + fetched.shape[1:])
        slots[self._perm_s] = fetched
        back, work = self._all_to_all(slots[: self._nremote].contiguous())
        for w in work:
            w.wait()
        upd[self._recv_leaf] = self._gather(back, self._recv_slots).to(
            leaf.dtype)
        upd[self._self_leaf_s] = slots[self._nremote:].to(leaf.dtype)
        return root_out, upd

    # ----------------------------------------------------- static maps
    def _allgather_src_map(self) -> np.ndarray:
        """Static map: global leaf position -> flattened (R*root_pad) index."""
        p = self.plan
        return np.concatenate([r * p.root_pad + np.arange(p.nroots[r])
                               for r in range(p.nranks)]).astype(np.int64)

    def _allgather_block_map(self) -> np.ndarray:
        """Static map: (R, root_pad) gather indices into a leaf shard for the
        reduce_scatter path (block p = the leaf values for rank p's roots;
        padding reads the garbage row)."""
        p = self.plan
        ro = np.zeros(p.nranks + 1, dtype=np.int64)
        np.cumsum(p.nroots, out=ro[1:])
        out = np.full((p.nranks, p.root_pad), p.leaf_pad - 1, dtype=np.int64)
        for r in range(p.nranks):
            n = int(p.nroots[r])
            out[r, : n] = ro[r] + np.arange(n)
        return out

    def _permute_unpack_idx(self) -> np.ndarray:
        """Static (R, root_pad) leaf positions: where the received block lands
        on each rank (garbage beyond the true count)."""
        p = self.plan
        out = np.full((p.nranks, p.root_pad), p.leaf_pad - 1, dtype=np.int64)
        for pi in self.sf.pairs:
            if pi.root_rank == pi.leaf_rank:
                continue
            out[pi.leaf_rank, : pi.count] = pi.leaf_idx
        return out

    # -------------------------------------------------------- data helpers
    def pad_root_stack(self, per_rank: Sequence) -> torch.Tensor:
        return pad_ragged(per_rank, self.plan.root_pad)

    def pad_leaf_stack(self, per_rank: Sequence) -> torch.Tensor:
        return pad_ragged(per_rank, self.plan.leaf_pad)

    def unpad_root_stack(self, stacked) -> list:
        return unpad_ragged(stacked, list(self.plan.nroots))

    def unpad_leaf_stack(self, stacked) -> list:
        return unpad_ragged(stacked, list(self.plan.nleafspace))
