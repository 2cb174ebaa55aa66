"""Registry-selected SF execution backends (paper §4–§5).

PetscSF's defining design is a small API backed by multiple selectable
implementations chosen per architecture and communication pattern at
setup time via ``-sf_backend``.  This module is that layer for the port:

  ``"global"``  :class:`repro_torch.core.ops.SFOps` — plain torch gathers
                and scatters on global concatenated arrays.
  ``"cuda"``    the general pack → exchange → unpack path routed through the
                hand-written CUDA kernels (:mod:`repro_torch.kernels`): the
                pack kernel, the parametric strided pack wherever the pack
                index list enumerates a 3D box (paper §5.2 ¶3), the fused
                local bcast for local-only SFs, and the deterministic
                segment reduce for reductions with repeated roots.  The
                counterpart of the reference's ``"pallas"`` backend, with
                every routing decision kept.
  ``"dist"``    :class:`repro_torch.core.distributed.DistSF` behind the
                global-array facade: each process of a ``torch.distributed``
                group (NCCL on the card, gloo on the CPU) runs its rank's
                shard, and every process gets the whole result.  The
                counterpart of the reference's ``"shardmap"`` backend.

``select_backend`` mirrors ``-sf_backend``'s default logic with the static
heuristic: an explicit hint wins; a process group whose size equals the
SF's rank count (more than one) selects ``"dist"``; general-pattern SFs on
a CUDA device take the kernel path; everything else uses ``"global"``.
``register_backend`` lets downstream code add implementations without
touching this module.

The user-facing object is :class:`SFComm`: build once per StarForest on a
device (the card unless ``device="cpu"`` is asked for), then call
``bcast``/``reduce``/``fetch_and_op``/``gather``/``scatter`` (and the fused
multi-field ``bcast_multi``/``reduce_multi``) on global tensors on that
device regardless of which backend executes them.  Both backends finish
reductions with :class:`repro_torch.core.ops.SortedUnpack`, so a float
reduction is the same bits on either, from run to run.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Protocol, Tuple, \
    runtime_checkable

import torch
import torch.distributed as dist

from .device import check_payload, index_tensor, kernel_index, resolve_device
from .distributed import DistSF, _bytes, unpad_ragged
from .fields import FieldBundle
from .graph import StarForest
from .mpiops import SUM, get_op
from .ops import (PendingComm, SFOps, SortedUnpack, _apply_unique,
                  exclusive_segment_prefix, unsigned_payloads)
from .plan import GlobalPlan, build_global_plan
from .unit import check_plan_unit, resolve_unit
from . import patterns as pat
from . import sflog
from ..kernels import ops as kops

__all__ = [
    "SFBackend", "SFComm",
    "register_backend", "available_backends", "make_backend",
    "select_backend", "estimate_message_bytes",
    "GlobalBackend", "CudaBackend", "DistBackend",
]


@runtime_checkable
class SFBackend(Protocol):
    """What every SF execution backend provides (paper §3.2 op set).

    All data arguments are *global concatenated* tensors: ``rootdata`` of
    shape ``(sf.nroots_total, *unit)`` and ``leafdata`` of shape
    ``(sf.nleafspace_total, *unit)``, on the backend's device.
    """

    name: str

    def bcast_begin(self, rootdata, op="replace"): ...
    def bcast_end(self, pending, leafdata): ...
    def bcast(self, rootdata, leafdata, op="replace"): ...
    def reduce_begin(self, leafdata, op="sum"): ...
    def reduce_end(self, pending, rootdata): ...
    def reduce(self, leafdata, rootdata, op="sum"): ...
    def fetch_and_op(self, rootdata, leafdata, op="sum"): ...
    def gather(self, leafdata): ...
    def scatter(self, multirootdata, leafdata=None): ...


# --------------------------------------------------------------------------
# registry (PetscFunctionList analogue for -sf_backend)
# --------------------------------------------------------------------------
BackendFactory = Callable[..., "SFBackend"]
_REGISTRY: Dict[str, BackendFactory] = {}


def register_backend(name: str, factory: BackendFactory, *,
                     overwrite: bool = False) -> None:
    """Register a backend factory ``factory(sf, device=..., unit=...)``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"SF backend {name!r} already registered")
    _REGISTRY[name] = factory


def available_backends() -> list:
    return sorted(_REGISTRY)


def make_backend(name: str, sf: StarForest, **kwargs) -> "SFBackend":
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown SF backend {name!r}; registered: "
                         f"{available_backends()}") from None
    return factory(sf, **kwargs)


def estimate_message_bytes(sf: StarForest, unit=None) -> float:
    """Per-exchange payload bytes for ``sf``: edges × unit row bytes
    (scalar float32 rows when the unit is unpinned), the reference's
    lookup key into its measured priors table (``select_backend``'s
    ``priors=``, which waits with the benchmark port)."""
    u = resolve_unit(unit)
    row_bytes = u.nbytes if u.nbytes else 4 * max(u.size, 1)
    return float(sf.nedges_total) * row_bytes


def select_backend(sf: StarForest, hint: Optional[str] = None, *,
                   device=None, group=None) -> str:
    """Pick a backend name for ``sf`` (the ``-sf_backend`` default logic).

    An explicit ``hint`` wins (validated against the registry); a
    ``torch.distributed`` ``group`` whose size equals ``sf.nranks`` (more
    than one) selects the rank decomposition ``"dist"``; otherwise a
    general-pattern SF on a CUDA device (the default device) takes the
    kernel path and everything else — including the allgather / permute /
    local-only patterns — defaults to ``"global"``.
    """
    sf.setup()
    if hint is not None:
        if hint not in _REGISTRY:
            raise ValueError(f"unknown SF backend hint {hint!r}; registered: "
                             f"{available_backends()}")
        return hint
    if group is not None and sf.nranks > 1 \
            and dist.get_world_size(group) == sf.nranks:
        return "dist"
    dev = torch.device("cuda" if device is None else device)
    if pat.analyze(sf).kind == pat.GENERAL and dev.type == "cuda":
        return "cuda"
    return "global"


# --------------------------------------------------------------------------
# "global" — SFOps on global arrays (the Basic backend analogue)
# --------------------------------------------------------------------------
class GlobalBackend(SFOps):
    """Plain torch ops on global concatenated arrays."""

    name = "global"


# --------------------------------------------------------------------------
# "cuda" — kernel pack/unpack on the general path (paper §5.2–§5.3)
# --------------------------------------------------------------------------
@unsigned_payloads
class CudaBackend:
    """Global-array execution with the CUDA pack/unpack kernels on the hot
    path.

    Packs are the gather kernel (``kernels.ops.pack_rows``), or the
    parametric strided kernel when the pack index list enumerates a 3D
    subdomain (paper §5.2 ¶3, detected by
    :func:`repro_torch.core.patterns.detect_strided`).  Reductions pack
    directly in *sorted* slot order, segment-reduce with the deterministic
    ``sf_unpack`` kernel, and finish with one duplicate-free scatter.  A
    local-only replace bcast takes the fused kernel.  On CPU tensors the
    kernels' plain versions run instead (``device="cpu"``).
    """

    name = "cuda"

    def __init__(self, sf: StarForest, plan: Optional[GlobalPlan] = None,
                 unit=None, *, device=None):
        sf.setup()
        self.sf = sf
        self.device = d = resolve_device(device)
        if plan is not None:
            check_plan_unit(plan, unit)
            self.plan = plan
        else:
            self.plan = build_global_plan(sf, unit=unit)
        p, red = self.plan, self.plan.red
        # setup-time index products (PetscSFSetUp analogue), on the device
        gl_sorted = p.gl[red.perm]               # pack list for reduce
        gr_sorted = p.gr[red.perm]
        # §5.2 ¶3: engage the parametric strided pack when the index list is
        # exactly a 3D-subdomain enumeration (contiguous is the 1D case)
        self._bcast_strided = pat.detect_strided(p.gr) if p.nedges else None
        self._reduce_strided = pat.detect_strided(gl_sorted) \
            if p.nedges else None
        self._k_gr = kernel_index(p.gr, d)
        self._k_gl = kernel_index(p.gl, d)
        self._k_gl_sorted = kernel_index(gl_sorted, d)
        self._k_gr_sorted = kernel_index(gr_sorted, d)
        self._k_inv_perm = kernel_index(red.inv_perm, d)
        self._k_multi_slot = kernel_index(p.multi_slot, d)
        self._gl = index_tensor(p.gl, d)
        self._multi_slot = index_tensor(p.multi_slot, d)
        self._seg_start_of_slot = index_tensor(red.seg_start_of_slot, d)
        self._key = p.comm_signature()    # scopes the autotuned winners
        self._unpack = SortedUnpack(red, d, key=self._key)
        self._k_src_of_leaf = None
        if p.nedges and p.pattern is not None \
                and p.pattern.kind == pat.LOCAL_ONLY:
            self._k_src_of_leaf = kernel_index(
                kops.inverse_map(p.gr, p.gl, p.nleafspace), d)

    @property
    def unit(self):
        return self.plan.unit

    # ------------------------------------------------------------ plumbing
    def _arg(self, t, what: str) -> torch.Tensor:
        return check_payload(t, self.device, what)

    def _pack(self, data: torch.Tensor, idx: torch.Tensor,
              strided: Optional[pat.Strided3D] = None) -> torch.Tensor:
        """rows ``data[idx]`` via the pack kernel (strided variant when the
        enumeration is parametric); rows of any ``(*unit)`` shape pass
        through unreshaped."""
        if strided is None:
            return kops.pack_rows(data, idx, key=self._key)
        return kops.pack_strided_rows(data, strided)

    # ------------------------------------------------------------- bcast
    def bcast_begin(self, rootdata: torch.Tensor, op="replace") -> PendingComm:
        op = get_op(op)
        rootdata = self._arg(rootdata, "rootdata")
        self.plan.unit.check(rootdata, "rootdata")
        vals = self._pack(rootdata, self._k_gr, self._bcast_strided)
        return PendingComm("bcast", vals, op, self)

    def bcast_end(self, pending: PendingComm,
                  leafdata: torch.Tensor) -> torch.Tensor:
        assert pending.kind == "bcast"
        leafdata = self._arg(leafdata, "leafdata")
        # each leaf has exactly one root -> unique destinations
        return _apply_unique(leafdata, self._gl, pending.payload, pending.op)

    def bcast(self, rootdata, leafdata, op="replace"):
        opn = get_op(op)
        if opn.name == "replace" and self._k_src_of_leaf is not None:
            rootdata = self._arg(rootdata, "rootdata")
            leafdata = self._arg(leafdata, "leafdata")
            self.plan.unit.check(rootdata, "rootdata")
            self.plan.unit.check(leafdata, "leafdata")
            if _fusable(rootdata.dtype, leafdata.dtype):
                # §5.2 local/remote split: self-communication takes the fused
                # pack→unpack kernel — no intermediate packed leaf buffer
                return kops.local_bcast_rows(rootdata, leafdata,
                                             self._k_src_of_leaf,
                                             key=self._key)
        return self.bcast_end(self.bcast_begin(rootdata, opn), leafdata)

    # ------------------------------------------------------------- reduce
    def reduce_begin(self, leafdata: torch.Tensor, op="sum") -> PendingComm:
        """Pack leaf values directly in sorted slot order (the pack and the
        determinism sort are one gather)."""
        op = get_op(op)
        leafdata = self._arg(leafdata, "leafdata")
        self.plan.unit.check(leafdata, "leafdata")
        vals = self._pack(leafdata, self._k_gl_sorted, self._reduce_strided)
        return PendingComm("reduce", vals, op, self)

    def reduce_end(self, pending: PendingComm,
                   rootdata: torch.Tensor) -> torch.Tensor:
        assert pending.kind == "reduce"
        rootdata = self._arg(rootdata, "rootdata")
        # the payload is (E, *unit) sorted by root: fold it in the leaf dtype
        return self._unpack(rootdata, pending.payload, pending.op)

    def reduce(self, leafdata, rootdata, op="sum"):
        return self.reduce_end(self.reduce_begin(leafdata, op), rootdata)

    # -------------------------------------------------------- fetch-and-op
    def fetch_and_op(self, rootdata: torch.Tensor, leafdata: torch.Tensor,
                     op="sum") -> Tuple[torch.Tensor, torch.Tensor]:
        op = get_op(op)
        if op.name != "sum":
            raise NotImplementedError("fetch_and_op supports op='sum' "
                                      "(fetch-and-add), as used by the paper")
        rootdata = self._arg(rootdata, "rootdata")
        leafdata = self._arg(leafdata, "leafdata")
        if self.plan.nedges == 0:
            return rootdata.clone(), leafdata.clone()
        sv = self._pack(leafdata, self._k_gl_sorted, self._reduce_strided)
        excl = exclusive_segment_prefix(sv, self._seg_start_of_slot)
        base = self._pack(rootdata, self._k_gr_sorted)
        fetched_sorted = base + excl.to(rootdata.dtype)
        fetched = self._pack(fetched_sorted, self._k_inv_perm)
        leafupdate = leafdata.clone()
        leafupdate[self._gl] = fetched.to(leafdata.dtype)
        # the roots' totals: the deterministic segment reduce of the same
        # sorted buffer (no atomics), cast to the root dtype first as the
        # reference's ``.at[].add(sv.astype(root.dtype))`` does
        return self._unpack(rootdata, sv.to(rootdata.dtype), SUM), leafupdate

    # ------------------------------------------------------ gather/scatter
    @property
    def nmulti(self) -> int:
        return self.plan.nmulti

    def gather(self, leafdata: torch.Tensor) -> torch.Tensor:
        leafdata = self._arg(leafdata, "leafdata")
        out = leafdata.new_zeros((self.plan.nmulti,) + leafdata.shape[1:])
        if self.plan.nedges == 0:
            return out
        out[self._multi_slot] = self._pack(leafdata, self._k_gl)
        return out

    def scatter(self, multirootdata: torch.Tensor,
                leafdata: Optional[torch.Tensor] = None) -> torch.Tensor:
        multirootdata = self._arg(multirootdata, "multirootdata")
        if leafdata is None:
            out = multirootdata.new_zeros((self.plan.nleafspace,)
                                          + multirootdata.shape[1:])
        else:
            out = self._arg(leafdata, "leafdata").clone()
        if self.plan.nedges == 0:
            return out
        vals = self._pack(multirootdata, self._k_multi_slot)
        out[self._gl] = vals.to(out.dtype)
        return out

    def compute_degrees(self) -> torch.Tensor:
        ones = torch.ones((self.plan.nleafspace,), dtype=torch.int32,
                          device=self.device)
        zeros = torch.zeros((self.plan.nroots,), dtype=torch.int32,
                            device=self.device)
        return self.reduce(ones, zeros)


_FUSED_CASTS = (torch.float32, torch.float64, torch.bfloat16)


def _fusable(root_dtype: torch.dtype, leaf_dtype: torch.dtype) -> bool:
    """Dtype pairs the fused bcast kernel takes: equal, or a float cast."""
    return root_dtype == leaf_dtype or (root_dtype in _FUSED_CASTS
                                        and leaf_dtype in _FUSED_CASTS)


# --------------------------------------------------------------------------
# "dist" — DistSF behind the global-array facade
# --------------------------------------------------------------------------
class _DistComm(PendingComm):
    """The facade's token of a ``"dist"`` exchange: ``payload`` is the
    :class:`repro_torch.core.distributed.DistPending` in flight."""

    def converted(self, fn, dtype):
        # the rows arrive at the wait: the DistPending maps them then (its
        # own dtype cleared, so its decorator converts nothing twice)
        return dataclasses.replace(
            self, payload=self.payload.converted(fn, None), dtype=dtype)


@unsigned_payloads
class DistBackend:
    """Explicit rank decomposition over a ``torch.distributed`` group: the
    counterpart of the reference's ``ShardmapBackend``
    (``src/repro/core/backend.py``), as ``"cuda"`` is of ``"pallas"``.

    It keeps ``SFComm``'s global-array contract on every process: each holds
    the global tensors, cuts its own rank's shard (``sf.root_offsets()`` /
    ``leaf_offsets()``, padded with zeros to the plan's shard rows), runs
    :class:`repro_torch.core.distributed.DistSF` on it, and rebuilds the
    global result with one ``all_gather_into_tensor`` of the padded shards,
    trimmed.  So every process returns the tensor ``"global"`` returns.
    Unlike the reference's deferred token, ``bcast_begin`` /
    ``reduce_begin`` really pack and issue the collective; the end waits,
    unpacks and gathers.  ``gather``, ``scatter`` and ``compute_degrees``
    go through :class:`GlobalBackend` on the global tensors, as in the
    reference."""

    name = "dist"

    def __init__(self, sf: StarForest, plan=None, unit=None, *, device=None,
                 group=None, lowering: str = "auto", sync_mode: bool = False,
                 use_kernels: Optional[bool] = None):
        sf.setup()
        self.sf = sf
        self.dist = DistSF(sf, group=group, plan=plan, lowering=lowering,
                           sync_mode=sync_mode, use_kernels=use_kernels,
                           unit=unit, device=device)
        self.device = self.dist.device
        self._globalops: Optional[GlobalBackend] = None

    @property
    def plan(self):
        return self.dist.plan

    @property
    def unit(self):
        return self.dist.unit

    # ------------------------------------------------------------ plumbing
    def _cut(self, data, offsets, pad: int, what: str) -> torch.Tensor:
        """This rank's rows of a global tensor, padded with zero rows."""
        data = check_payload(data, self.device, what)
        if data.dim() == 0 or int(data.shape[0]) != int(offsets[-1]):
            raise ValueError(f"{what} must have {int(offsets[-1])} rows, got "
                             f"shape {tuple(data.shape)}")
        me = self.dist.rank
        lo, hi = int(offsets[me]), int(offsets[me + 1])
        shard = data.new_zeros((pad,) + tuple(data.shape[1:]))
        shard[: hi - lo] = data[lo:hi]
        return shard

    def _join(self, shard: torch.Tensor, sizes) -> torch.Tensor:
        """The global tensor of every rank's padded ``shard``."""
        full = shard.new_empty((self.dist.nranks,) + tuple(shard.shape))
        if full.numel():
            dist.all_gather_into_tensor(_bytes(full), _bytes(shard),
                                        group=self.dist.group)
        return torch.cat(unpad_ragged(full, sizes))

    def _roots(self, data) -> torch.Tensor:
        return self._cut(data, self.sf.root_offsets(), self.plan.root_pad,
                         "rootdata")

    def _leaves(self, data) -> torch.Tensor:
        return self._cut(data, self.sf.leaf_offsets(), self.plan.leaf_pad,
                         "leafdata")

    # ------------------------------------------------------------ ops
    def bcast_begin(self, rootdata, op="replace") -> _DistComm:
        op = get_op(op)
        return _DistComm("bcast", self.dist.bcast_begin(self._roots(rootdata),
                                                        op), op, self)

    def bcast_end(self, pending: _DistComm, leafdata) -> torch.Tensor:
        out = self.dist.bcast_end(pending.payload, self._leaves(leafdata))
        return self._join(out, self.plan.nleafspace)

    def bcast(self, rootdata, leafdata, op="replace"):
        return self.bcast_end(self.bcast_begin(rootdata, op), leafdata)

    def reduce_begin(self, leafdata, op="sum") -> _DistComm:
        op = get_op(op)
        return _DistComm("reduce", self.dist.reduce_begin(
            self._leaves(leafdata), op), op, self)

    def reduce_end(self, pending: _DistComm, rootdata) -> torch.Tensor:
        out = self.dist.reduce_end(pending.payload, self._roots(rootdata))
        return self._join(out, self.plan.nroots)

    def reduce(self, leafdata, rootdata, op="sum"):
        return self.reduce_end(self.reduce_begin(leafdata, op), rootdata)

    def fetch_and_op(self, rootdata, leafdata, op="sum"):
        ro, lu = self.dist.fetch_and_op(self._roots(rootdata),
                                        self._leaves(leafdata), op)
        return (self._join(ro, self.plan.nroots),
                self._join(lu, self.plan.nleafspace))

    # gather / scatter reorganize into the multi-root layout, a host-derived
    # index transform shared with the global backend
    def _gops(self) -> GlobalBackend:
        if self._globalops is None:
            self._globalops = GlobalBackend(self.sf, device=self.device)
        return self._globalops

    @property
    def nmulti(self) -> int:
        return self._gops().nmulti

    def gather(self, leafdata):
        return self._gops().gather(leafdata)

    def scatter(self, multirootdata, leafdata=None):
        return self._gops().scatter(multirootdata, leafdata)

    def compute_degrees(self) -> torch.Tensor:
        ones = torch.ones((self.sf.nleafspace_total,), dtype=torch.int32,
                          device=self.device)
        zeros = torch.zeros((self.sf.nroots_total,), dtype=torch.int32,
                            device=self.device)
        return self.reduce(ones, zeros)


# --------------------------------------------------------------------------
# facade
# --------------------------------------------------------------------------
class SFComm:
    """One StarForest, one backend, the full §3.2 op set on global tensors.

    The PetscSF-object analogue: construct once (setup cost amortizes over
    every operation), then communicate.  ``device`` defaults to the current
    CUDA device and raises without one; pass ``device="cpu"`` to run on the
    CPU.  The plan's index lists are uploaded to the device once, here, and
    every payload must already live there.  The backend is chosen by
    ``select_backend`` unless named explicitly — the paper's ``-sf_backend``
    override.  Payload rows are ``(*unit)`` dof blocks; pass ``unit=`` to
    pin and validate the unit shape/dtype.  Operations return new tensors
    and leave their arguments untouched.  ``group`` is the
    ``torch.distributed`` process group of the ``"dist"`` backend (default:
    the world group); a group whose size is the SF's rank count selects it.

    Every operation reports into :mod:`repro_torch.core.sflog` (counts,
    wall time, bytes = plan edges x unit row, split-phase overlap windows),
    as the reference's facade does.  Off (the default), a hook costs one
    integer test; during a CUDA-graph capture it bumps the event's
    ``traced`` counter only, and reads, fences and allocates nothing.
    """

    def __init__(self, sf: StarForest, backend: Optional[str] = None, *,
                 device=None, unit=None, group=None, **backend_kwargs):
        sf.setup()
        self.sf = sf
        self.device = resolve_device(device)
        name = backend if backend is not None \
            else select_backend(sf, device=self.device, group=group)
        if name == "dist":
            backend_kwargs["group"] = group
        self.backend = make_backend(name, sf, device=self.device, unit=unit,
                                    **backend_kwargs)
        self._bundles: Dict[tuple, "FieldBundle"] = {}
        self._lmeta: Optional[Dict[str, Any]] = None   # sflog tag cache

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @property
    def unit(self):
        """The backend plan's payload unit spec."""
        return self.backend.unit

    @property
    def nmulti(self) -> int:
        return self.backend.nmulti

    # sflog plumbing ------------------------------------------------------
    def _logtags(self, op=None) -> Dict[str, Any]:
        """Static tags every event from this comm carries: backend name,
        pattern kind, plan signature (computed once per comm)."""
        m = self._lmeta
        if m is None:
            plan = self.backend.plan
            m = self._lmeta = {
                "backend": self.backend_name,
                "pattern": getattr(plan.pattern, "kind", None),
                "sig": repr(plan.comm_signature())}
        if op is None:
            return m
        return dict(m, op=get_op(op).name)

    def _payload_bytes(self, data) -> float:
        """Comm volume of one exchange: plan edges x unit row bytes of the
        actual payload (trailing dims x itemsize); host arithmetic on the
        shape only, so it reads nothing from the device."""
        return float(self.sf.nedges_total) * math.prod(data.shape[1:]) \
            * data.element_size()

    def _split_begin(self, name: str, begin, data, op):
        if not sflog.enabled():
            return begin(data, op)
        t0 = sflog.op_begin()
        pend = begin(data, op)
        nb = self._payload_bytes(data)
        tags = self._logtags(op)
        sflog.op_end(name + "Begin", t0, pend.payload, nbytes=nb, tags=tags)
        sflog.stash_pending(pend, name + "End", nb, tags, tracing=t0 < 0)
        return pend

    def _split_end(self, end, pending, data):
        info = sflog.claim_pending(pending)
        if info is None:
            return end(pending, data)
        t0 = time.perf_counter()
        out = end(pending, data)
        sflog.pending_end(info, t0, out)
        return out

    def _logged(self, name: str, payload, run, *args, tags=None,
                scale: float = 1.0):
        """``run(*args)`` recorded as one ``name`` event moving ``scale`` x
        ``payload``'s comm volume."""
        t0 = sflog.op_begin()
        out = run(*args)
        sflog.op_end(name, t0, out,
                     nbytes=scale * self._payload_bytes(payload), tags=tags)
        return out

    # delegation ----------------------------------------------------------
    def bcast_begin(self, rootdata, op="replace"):
        return self._split_begin("SFBcast", self.backend.bcast_begin,
                                 rootdata, op)

    def bcast_end(self, pending, leafdata):
        return self._split_end(self.backend.bcast_end, pending, leafdata)

    def bcast(self, rootdata, leafdata, op="replace"):
        if not sflog.enabled():
            return self.backend.bcast(rootdata, leafdata, op)
        return self._logged("SFBcast", rootdata, self.backend.bcast,
                            rootdata, leafdata, op, tags=self._logtags(op))

    def reduce_begin(self, leafdata, op="sum"):
        return self._split_begin("SFReduce", self.backend.reduce_begin,
                                 leafdata, op)

    def reduce_end(self, pending, rootdata):
        return self._split_end(self.backend.reduce_end, pending, rootdata)

    def reduce(self, leafdata, rootdata, op="sum"):
        if not sflog.enabled():
            return self.backend.reduce(leafdata, rootdata, op)
        return self._logged("SFReduce", leafdata, self.backend.reduce,
                            leafdata, rootdata, op, tags=self._logtags(op))

    def fetch_and_op(self, rootdata, leafdata, op="sum"):
        if not sflog.enabled():
            return self.backend.fetch_and_op(rootdata, leafdata, op)
        # fetch-and-op moves payload both ways (fetch + update)
        return self._logged("SFFetchAndOp", leafdata,
                            self.backend.fetch_and_op, rootdata, leafdata,
                            op, tags=self._logtags(op), scale=2.0)

    def gather(self, leafdata):
        if not sflog.enabled():
            return self.backend.gather(leafdata)
        return self._logged("SFGather", leafdata, self.backend.gather,
                            leafdata, tags=self._logtags())

    def scatter(self, multirootdata, leafdata=None):
        if not sflog.enabled():
            return self.backend.scatter(multirootdata, leafdata)
        return self._logged("SFScatter", multirootdata, self.backend.scatter,
                            multirootdata, leafdata, tags=self._logtags())

    # fused multi-field exchange (VecScatter analogue) -------------------
    def _bundle(self, fields) -> "FieldBundle":
        """The cached :class:`repro_torch.core.fields.FieldBundle` of a
        field list's signature (unit shape and dtype of each field)."""
        key = tuple((tuple(int(d) for d in f.shape[1:]), f.dtype)
                    for f in fields)
        if key not in self._bundles:
            self._bundles[key] = FieldBundle.for_data(self, fields)
        return self._bundles[key]

    def bcast_multi(self, rootfields, leaffields, op="replace"):
        """Broadcast k same-pattern fields through ONE fused exchange per
        byte-compatible group.  Returns the list of updated leaf fields."""
        return self._bundle(rootfields).bcast_multi(rootfields, leaffields,
                                                    op)

    def reduce_multi(self, leaffields, rootfields, op="sum"):
        """Reduce k same-pattern fields through ONE fused exchange per
        fusable group.  Returns the list of updated root fields."""
        return self._bundle(leaffields).reduce_multi(leaffields, rootfields,
                                                     op)

    def bcast_multi_begin(self, rootfields, op="replace"):
        """Begin half of :meth:`bcast_multi`; complete with
        :meth:`bcast_multi_end` (or ``pending.end(leaffields)``)."""
        return self._bundle(rootfields).bcast_multi_begin(rootfields, op)

    def bcast_multi_end(self, pending, leaffields):
        return pending.end(leaffields)

    def reduce_multi_begin(self, leaffields, op="sum"):
        """Begin half of :meth:`reduce_multi`: packs every fusable group and
        returns a :class:`repro_torch.core.fields.PendingMulti`."""
        return self._bundle(leaffields).reduce_multi_begin(leaffields, op)

    def reduce_multi_end(self, pending, rootfields):
        return pending.end(rootfields)

    def compute_degrees(self):
        return self.backend.compute_degrees()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SFComm({self.sf!r}, backend={self.backend_name!r})"


# --------------------------------------------------------------------------
# built-in registrations
# --------------------------------------------------------------------------
def _global_factory(sf, plan=None, unit=None, device=None):
    return GlobalBackend(sf, plan=plan, unit=unit, device=device)


def _cuda_factory(sf, plan=None, unit=None, device=None):
    return CudaBackend(sf, plan=plan, unit=unit, device=device)


def _dist_factory(sf, plan=None, unit=None, device=None, **kwargs):
    return DistBackend(sf, plan=plan, unit=unit, device=device, **kwargs)


register_backend("global", _global_factory)
register_backend("cuda", _cuda_factory)
register_backend("dist", _dist_factory)
