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

``select_backend`` mirrors ``-sf_backend``'s default logic with the static
heuristic: an explicit hint wins; general-pattern SFs on a CUDA device take
the kernel path; everything else uses ``"global"``.  ``register_backend``
lets downstream code add implementations without touching this module.

The user-facing object is :class:`SFComm`: build once per StarForest on a
device (the card unless ``device="cpu"`` is asked for), then call
``bcast``/``reduce``/``fetch_and_op``/``gather``/``scatter`` on global
tensors on that device regardless of which backend executes them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, Tuple, \
    runtime_checkable

import numpy as np
import torch

from .device import check_payload, index_tensor, resolve_device
from .graph import StarForest
from .mpiops import SUM, get_op
from .ops import PendingComm, SFOps, _apply_unique, exclusive_segment_prefix
from .plan import GlobalPlan, build_global_plan
from .unit import check_plan_unit
from . import patterns as pat
from ..kernels import ops as kops
from ..kernels._index import device_index, segment_meta

__all__ = [
    "SFBackend", "SFComm",
    "register_backend", "available_backends", "make_backend",
    "select_backend",
    "GlobalBackend", "CudaBackend",
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


def select_backend(sf: StarForest, hint: Optional[str] = None, *,
                   device=None) -> str:
    """Pick a backend name for ``sf`` (the ``-sf_backend`` default logic).

    An explicit ``hint`` wins (validated against the registry); otherwise a
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
def _kernel_index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A setup-time index list as the int32 device tensor the kernels take,
    bounds-checked now so that every later launch skips the check."""
    a = np.asarray(a, dtype=np.int64)
    if a.size and (a.min() < -2 ** 31 or a.max() >= 2 ** 31):
        raise ValueError("index list does not fit in int32")
    t = torch.as_tensor(a.astype(np.int32), device=device)
    device_index(t, device)
    return t


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
        self._k_gr = _kernel_index(p.gr, d)
        self._k_gl = _kernel_index(p.gl, d)
        self._k_gl_sorted = _kernel_index(gl_sorted, d)
        self._k_gr_sorted = _kernel_index(gr_sorted, d)
        self._k_inv_perm = _kernel_index(red.inv_perm, d)
        self._k_multi_slot = _kernel_index(p.multi_slot, d)
        self._k_seg_first = _kernel_index(red.seg_first, d)
        self._k_seg_len = _kernel_index(red.seg_len, d)
        segment_meta(self._k_seg_first, self._k_seg_len, d)
        self._gl = index_tensor(p.gl, d)
        self._multi_slot = index_tensor(p.multi_slot, d)
        self._win_src = index_tensor(red.win_src, d)
        self._win_dst = index_tensor(red.win_dst, d)
        self._dst_sorted = index_tensor(red.dst_sorted, d)
        self._seg_dst = index_tensor(red.seg_dst, d)
        self._seg_of_slot = index_tensor(red.seg_of_slot, d)
        self._seg_start_of_slot = index_tensor(red.seg_start_of_slot, d)
        self._k_src_of_leaf = None
        if p.nedges and p.pattern is not None \
                and p.pattern.kind == pat.LOCAL_ONLY:
            self._k_src_of_leaf = _kernel_index(
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
            return kops.pack_rows(data, idx)
        return kops.pack_strided_rows(data, strided)

    def _segment_reduce(self, sorted_vals: torch.Tensor, opname: str
                        ) -> torch.Tensor:
        """sf_unpack kernel over the sorted slot buffer -> one row/segment."""
        return kops.segment_reduce_rows(sorted_vals, self._k_seg_first,
                                        self._k_seg_len, op=opname)

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
                                             self._k_src_of_leaf)
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
        red, op = self.plan.red, pending.op
        rootdata = self._arg(rootdata, "rootdata")
        sv = pending.payload                   # (E, *unit), sorted by root
        if self.plan.nedges == 0:
            return rootdata.clone()
        if op.name == "replace":
            # deterministic last-writer wins, precomputed at setup
            out = rootdata.clone()
            out[self._win_dst] = sv[self._win_src].to(rootdata.dtype)
            return out
        usize = int(np.prod(sv.shape[1:], dtype=np.int64))
        if op.name in ("sum", "prod", "max", "min") and usize:
            if red.duplicate_free:
                # one slot per root: the unpack scatter is the reduction
                return _apply_unique(rootdata, self._dst_sorted, sv, op)
            seg = self._segment_reduce(sv, op.name)
            return _apply_unique(rootdata, self._seg_dst, seg, op)
        # logical ops reduce as max/min over the int32 view (as mpiops does)
        seg = op.segment(sv, self._seg_of_slot, red.nseg)
        return _apply_unique(rootdata, self._seg_dst, seg, op)

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
        root_out = self.reduce_end(
            PendingComm("reduce", sv.to(rootdata.dtype), SUM, self), rootdata)
        return root_out, leafupdate

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
    and leave their arguments untouched.
    """

    def __init__(self, sf: StarForest, backend: Optional[str] = None, *,
                 device=None, unit=None, **backend_kwargs):
        sf.setup()
        self.sf = sf
        self.device = resolve_device(device)
        name = backend if backend is not None \
            else select_backend(sf, device=self.device)
        self.backend = make_backend(name, sf, device=self.device, unit=unit,
                                    **backend_kwargs)

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

    def bcast_begin(self, rootdata, op="replace"):
        return self.backend.bcast_begin(rootdata, op)

    def bcast_end(self, pending, leafdata):
        return self.backend.bcast_end(pending, leafdata)

    def bcast(self, rootdata, leafdata, op="replace"):
        return self.backend.bcast(rootdata, leafdata, op)

    def reduce_begin(self, leafdata, op="sum"):
        return self.backend.reduce_begin(leafdata, op)

    def reduce_end(self, pending, rootdata):
        return self.backend.reduce_end(pending, rootdata)

    def reduce(self, leafdata, rootdata, op="sum"):
        return self.backend.reduce(leafdata, rootdata, op)

    def fetch_and_op(self, rootdata, leafdata, op="sum"):
        return self.backend.fetch_and_op(rootdata, leafdata, op)

    def gather(self, leafdata):
        return self.backend.gather(leafdata)

    def scatter(self, multirootdata, leafdata=None):
        return self.backend.scatter(multirootdata, leafdata)

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


register_backend("global", _global_factory)
register_backend("cuda", _cuda_factory)
